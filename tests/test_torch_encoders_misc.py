"""The small perceptual encoders, time embeddings and helpers of the PyTorch
port against the JAX package, on the CPU at tiny tower widths: JAX
parameters, perturbed, carried across by `utils/from_jax.py`, the same numpy
inputs through both. Tolerance: rtol 1e-4, atol 5e-5 (float32), as in
tests/test_torch_modules.py; hashes, tables and configs exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdt_policy_tpu.diffusion import precond as jprecond
from mdt_policy_tpu.models import clip as jclip
from mdt_policy_tpu.models import encoders_misc as jenc
from mdt_policy_tpu.models import voltron_vit as jvit
from mdt_policy_tpu.utils import fnv as jfnv
from mdt_policy_tpu_torch.diffusion import precond
from mdt_policy_tpu_torch.models import clip as pclip
from mdt_policy_tpu_torch.models import encoders_misc as penc
from mdt_policy_tpu_torch.models import voltron_vit as pvit
from mdt_policy_tpu_torch.utils import fnv, from_jax
from test_torch_modules import TOL, _x, jinit, jrun, load, prun

B = 2
VIT = dict(image_resolution=32, layers=1, width=64, patch_size=16)
RN = dict(layers=(1, 1, 1, 1), width=8, image_resolution=64)


@pytest.mark.parametrize("family,tower,hw", [("vit", VIT, 32), ("resnet", RN, 64)])
def test_vision_clip_head(family, tower, hw):
    x = _x(B, hw, hw, 3)
    jm = jenc.VisionClipHead(visual_features=24, clip_embed_dim=32, family=family,
                             tower_kwargs=tower)
    p = jinit(jm, x)
    pm = load(penc.VisionClipHead(24, 32, family, tower), from_jax.vision_clip_head_from_jax(p))
    assert pm.fc1.out_features == (512 if family == "resnet" else 256)
    np.testing.assert_allclose(prun(pm, x), jrun(jm, p, x), **TOL)
    # the tower is frozen: no gradient reaches it, the head gets one
    pm(torch.from_numpy(x)).sum().backward()
    assert all(q.grad is None for q in pm.clip.parameters())
    assert pm.fc1.weight.grad.abs().sum() > 0
    with pytest.raises(ValueError, match="family"):
        penc.VisionClipHead(family="rn")


def test_clip_vision_tokens():
    x = _x(B, 32, 32, 3)
    jm = jenc.CLIPVisionTokens(width=64, layers=2, patch_size=16, image_resolution=32)
    p = jinit(jm, x)
    pm = load(penc.CLIPVisionTokens(64, 2, 16, 32), from_jax.clip_vision_tokens_from_jax(p))
    assert pm.ln_pre.eps == 1e-6  # flax's default LayerNorm in JAX
    np.testing.assert_allclose(prun(pm, x), jrun(jm, p, x), **TOL)


def test_voltron_map_encoder_and_frozen_tokens():
    vk = dict(patch_size=16, embed_dim=32, depth=1, n_heads=2, img_size=32)
    x = _x(B, 32, 32, 3)
    jm = jenc.VoltronMAPEncoder(latent_dim=24, vit_kwargs=vk)
    p = jinit(jm, x)
    pm = load(penc.VoltronMAPEncoder(24, vit_kwargs=vk),
              from_jax.voltron_map_encoder_from_jax(p))
    out = prun(pm, x)
    assert out.shape == (B, 24)
    np.testing.assert_allclose(out, jrun(jm, p, x), **TOL)
    pm(torch.from_numpy(x)).sum().backward()
    assert all(q.grad is None for q in pm.vcond.parameters())
    assert sum(q.grad.abs().sum() for q in pm.vector_extractor.parameters()) > 0


def test_time_embeddings_and_no_encoder():
    t = np.asarray([0.0, 0.3, -1.7, 5.0], np.float32)
    for jm, pm in ((jenc.GaussianFourierEmbedding(16, scale=2.0),
                    penc.GaussianFourierEmbedding(16, scale=2.0)),
                   (jenc.SinusoidalTimeEmbedding(16), penc.SinusoidalTimeEmbedding(16))):
        p = jinit(jm, t)
        pm = load(pm, from_jax.module_from_jax(p))
        np.testing.assert_allclose(prun(pm, t), jrun(jm, p, t), **TOL)
        pm(torch.from_numpy(t)).sum().backward()
        if hasattr(pm, "W"):
            assert pm.W.grad is None  # the random features are fixed
    for t_in, width in ((t, 1), (_x(4, 3), 3)):
        jm = jenc.FourierFeatures(16)
        p = jinit(jm, t_in)
        pm = load(penc.FourierFeatures(16, in_features=width), from_jax.module_from_jax(p))
        np.testing.assert_allclose(prun(pm, t_in), jrun(jm, p, t_in), **TOL)
    x = torch.ones(3)
    assert penc.NoEncoder()(x) is x and penc.NoEncoder()() is None
    assert isinstance(penc.NoEncoder(), torch.nn.Module)


def _fake_clip_state_dict(family):
    """Synthetic OpenAI CLIP state dicts: only the shapes and keys
    `clip_config_from_state_dict` reads, at odd sizes."""
    z = lambda *s: np.zeros(s, np.float32)
    sd = {"positional_embedding": z(40, 8), "token_embedding.weight": z(300, 8),
          "ln_final.weight": z(192)}
    sd.update({f"transformer.resblocks.{i}.attn.in_proj_weight": z(1) for i in range(5)})
    if family == "vit":
        sd.update({"visual.proj": z(96, 48), "visual.conv1.weight": z(96, 3, 14, 14),
                   "visual.positional_embedding": z(17 * 17 + 1, 96)})
        sd.update({f"visual.transformer.resblocks.{i}.attn.in_proj_weight": z(1)
                   for i in range(7)})
    else:
        for stage, blocks in enumerate((2, 3, 5, 1), start=1):
            for b in range(blocks):
                sd[f"visual.layer{stage}.{b}.conv1.weight"] = z(24, 3, 1, 1)
        sd.update({"visual.attnpool.positional_embedding": z(9 * 9 + 1, 8),
                   "visual.attnpool.c_proj.weight": z(640, 8)})
    return sd


@pytest.mark.parametrize("family", ["vit", "resnet"])
def test_clip_config_from_state_dict(family):
    sd = _fake_clip_state_dict(family)
    port = pclip.clip_config_from_state_dict(sd)
    assert port == jclip.clip_config_from_state_dict(sd)
    assert port["vision_layers"] == (7 if family == "vit" else (2, 3, 5, 1))


def test_helpers_clip_normalize_sincos_precond():
    x = np.random.default_rng(0).uniform(size=(2, 5, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(pclip.clip_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jclip.clip_normalize(jnp.asarray(x))), **TOL)
    np.testing.assert_array_equal(pvit.get_1d_sincos_pos_embed(16, 11),
                                  jvit.get_1d_sincos_pos_embed(16, 11))
    actions, noise = _x(3, 10, 7), _x(3, 10, 7, seed=1)
    sigma = np.asarray([0.01, 1.0, 40.0], np.float32)
    w = _x(7, 7, seed=2)
    jl, jo = jprecond.precond_loss(lambda a, s: jnp.tanh(a @ w) * s[:, None, None],
                                   actions, noise, sigma, 0.5)
    pl, po = precond.precond_loss(lambda a, s: torch.tanh(a @ torch.from_numpy(w))
                                  * s[:, None, None], *map(torch.from_numpy,
                                                           (actions, noise, sigma)), 0.5)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(pl), float(jl), **TOL)


def test_fnv_variants():
    # the FNV reference vectors over raw bytes
    assert fnv.fnv1_32(b"") == 0x811C9DC5 and fnv.fnv1_32(b"a") == 0x050C5D7E
    assert fnv.fnv1a_32(b"a") == 0xE40C292C
    assert fnv.fnv1_64(b"") == 0xCBF29CE484222325
    assert fnv.fnv1_64(b"a") == 0xAF63BD4C8601B7BE
    assert fnv.fnv1a_64(b"a") == 0xAF63DC4C8601EC8C
    assert fnv.fnv1a_64("a") == fnv.fnv1a_64(b"a\x00")  # str: UTF-16-LE
    rng = np.random.default_rng(0)
    strings = ["", "0", "dict_values([0, 1, 'left'])", "ü中", b"\x00\xff"] + [
        "".join(chr(c) for c in rng.integers(32, 0x3000, size=rng.integers(1, 40)))
        for _ in range(50)]
    for name in ("fnv1_32", "fnv1a_32", "fnv1_64", "fnv1a_64"):
        for s in strings:
            for seed in ({}, {"seed": 12345}):
                assert getattr(fnv, name)(s, **seed) == getattr(jfnv, name)(s, **seed), (name, s)
    with pytest.raises(TypeError):
        fnv.fnv1a_64(3)


def test_cache_mode_config_and_train_annotations():
    from mdt_policy_tpu import training as jtraining
    from mdt_policy_tpu.evaluation import annotations as jann
    from mdt_policy_tpu_torch import training
    from mdt_policy_tpu_torch.agents import MDTVConfig
    from mdt_policy_tpu_torch.evaluation import annotations

    assert training.CACHE_MODE_AGENT_DEFAULTS == jtraining.CACHE_MODE_AGENT_DEFAULTS
    assert training.cache_mode_config() == MDTVConfig()
    assert training.cache_mode_config(n_heads=4) == MDTVConfig(n_heads=4)
    table = annotations.train_annotations()
    assert table == jann.train_annotations()
    assert sum(len(v) for v in table.values()) == 389
