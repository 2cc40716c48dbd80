"""The MDT (ResNet) variant of the PyTorch port against the JAX package, at
float32 and small widths: the ResNet-18-GroupNorm encoder, the spatial
softmax, the MDT denoiser, the whole tiny agent's action chunk and the
closed-loop policy (`MDTPolicy`) over several replans, with the same numpy
inputs and initial noise on both sides.

Module tolerance: rtol 1e-4, atol 5e-5 (tests/test_torch_modules.py): both
sides compute in float32 and differ only in summation order and
transcendental rounding. The chunk after DDIM-10: 1e-3, the chunk bound of
tests/test_torch_slice.py."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdt_policy_tpu.agents import MDTConfig as JaxMDTConfig
from mdt_policy_tpu.agents import MDTPolicy as JaxPolicy
from mdt_policy_tpu.agents import init_mdt_agent
from mdt_policy_tpu.agents.mdtv_agent import denoise_actions as jax_denoise
from mdt_policy_tpu.models.mdt_transformer import MDTTransformer as JMDT
from mdt_policy_tpu.models.resnet import BesoResNetEncoder as JResNetEncoder
from mdt_policy_tpu.models.resnet import ResNet18GN as JResNet
from mdt_policy_tpu.models.resnet import SpatialSoftmax as JSpatialSoftmax
from mdt_policy_tpu_torch.agents import (MDTAgentNet, MDTConfig, MDTPolicy,
                                         MDTVPolicy, denoise_actions)
from mdt_policy_tpu_torch.agents import mdtv_agent as port_agent
from mdt_policy_tpu_torch.models.mdt_transformer import MDTTransformer
from mdt_policy_tpu_torch.models.resnet import (BesoResNetEncoder, ResNet18GN,
                                                SpatialSoftmax)
from mdt_policy_tpu_torch.utils import from_jax

TOL = dict(rtol=1e-4, atol=5e-5)
CHUNK_TOL = dict(rtol=1e-3, atol=1e-3)
B = 2


def _x(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _perturbed(params, seed):
    """Every parameter plus N(0, 0.1), so unit norm scales and zero biases
    cannot hide a swapped key."""
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(lambda p: (np.asarray(p) + rng.normal(size=np.shape(p)) * 0.1)
                        .astype(np.float32), jax.device_get(params))


def jinit(module, *args, seed=0, **kw):
    init = jax.jit(functools.partial(module.init, **kw))
    return _perturbed(init(jax.random.PRNGKey(seed), *args)["params"], seed)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_resnet18_gn_trunk():
    x = _x(2, 40, 36, 3)  # odd sizes after the strides exercise the padding
    jm = JResNet()
    p = jinit(jm, x)
    pm = ResNet18GN()
    sd = from_jax.resnet18_gn_from_jax({"backbone": p, "fc": {
        "kernel": np.zeros((512, 1), np.float32), "bias": np.zeros(1, np.float32)}})
    pm.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()
                        if k.startswith("backbone.")}, strict=True)
    with torch.no_grad():
        out = pm.eval()(torch.from_numpy(x))
    assert out.shape == (2, 512)
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.apply({"params": p}, x)), **TOL)


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (2, 1, 84, 84, 3)])
def test_beso_resnet_encoder(shape):
    x = _x(*shape, seed=1)
    jm = JResNetEncoder(latent_dim=24)
    p = jinit(jm, x, seed=1)
    pm = BesoResNetEncoder(24)
    pm.load_state_dict(from_jax.resnet18_gn_from_jax(p), strict=True)
    with torch.no_grad():
        out = pm.eval()(torch.from_numpy(x))
    ref = np.asarray(jm.apply({"params": p}, x))
    assert out.shape == ref.shape == shape[:-3] + (24,)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_spatial_softmax():
    x = _x(3, 5, 7, 4, seed=2, scale=3.0)
    ref = np.asarray(JSpatialSoftmax(temperature=0.7).apply({}, x))
    out = SpatialSoftmax(0.7)(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


C = 24
MDT_KW = dict(obs_dim=C, goal_dim=16, action_dim=7, embed_dim=C, n_enc_layers=2,
              n_dec_layers=2, n_heads=2)


@pytest.fixture(scope="module")
def mdt_pair():
    jm = JMDT(**MDT_KW, attn_pdrop=0.0, resid_pdrop=0.0, mlp_pdrop=0.0)
    states = {"static": _x(B, 1, C), "gripper": _x(B, 1, C, seed=1)}
    p = jinit(jm, states, _x(B, 10, 7), _x(B, 1, 16), np.ones(B, np.float32),
              modality="lang")
    pm = MDTTransformer(**MDT_KW)
    pm.load_state_dict(from_jax.mdt_transformer_from_jax(p), strict=True)
    return jm, p, pm.eval()


@pytest.mark.parametrize("modality,modality_embed", [("lang", False), ("vis", False),
                                                     ("lang", True)])
def test_mdt_transformer_encode_decode(mdt_pair, modality, modality_embed):
    jm, p, pm = mdt_pair
    states = {"static": _x(B, 1, C, seed=3), "gripper": _x(B, 1, C, seed=4)}
    goals = _x(B, 16, seed=5)  # (B, goal_dim): the 1-token goal path
    sigma = np.asarray([80.0, 1e-3], np.float32)
    actions = _x(B, 10, 7, seed=7)
    jctx = jm.apply({"params": p}, states, goals, sigma, modality=modality,
                    modality_embed=modality_embed, method="encode")
    jout = jm.apply({"params": p}, jctx, actions, sigma, method="decode")
    with torch.no_grad():
        pctx = pm.encode({k: torch.from_numpy(v) for k, v in states.items()},
                         torch.from_numpy(goals), modality=modality,
                         modality_embed=modality_embed)
        pout = pm.decode(pctx, torch.from_numpy(actions), torch.from_numpy(sigma))
    assert pctx.shape == (B, 3, C)
    np.testing.assert_allclose(pctx.numpy(), np.asarray(jctx), **TOL)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), **TOL)


def test_mdt_main_path_embeds_every_goal_with_goal_emb(mdt_pair):
    """The reference quirk: without `modality_embed` the modality does not
    change the context; with it, "lang" takes `lang_emb`."""
    _, _, pm = mdt_pair
    states = {"static": torch.from_numpy(_x(B, 1, C, seed=3)),
              "gripper": torch.from_numpy(_x(B, 1, C, seed=4))}
    goals = torch.from_numpy(_x(B, 16, seed=5))
    with torch.no_grad():
        lang, vis = (pm.encode(states, goals, modality=m) for m in ("lang", "vis"))
        embedded = pm.encode(states, goals, modality="lang", modality_embed=True)
    torch.testing.assert_close(lang, vis, rtol=0, atol=0)
    assert not torch.allclose(lang, embedded)


# ---------------------------------------------------------------------------
# the tiny agent, its chunk and the policy
# ---------------------------------------------------------------------------

TINY = dict(
    latent_dim=32, embed_dim=32, obs_dim=32, goal_dim=16, clip_embed_dim=16,
    n_enc_layers=2, n_dec_layers=2, n_heads=2, img_size=32,
    clip_vision_width=32, clip_vision_layers=1, clip_vision_patch=16,
    clip_text_width=16, clip_text_layers=1, clip_text_heads=2,
    clip_context_length=8, clip_vocab_size=100,
    gen_img_res=32, gen_patch_size=16, gen_decoder_depth=1, gen_decoder_dim=16,
    gen_decoder_heads=2, num_sampling_steps=10, compute_dtype="float32",
)


@functools.cache
def _agents():
    rng = np.random.default_rng(1)
    example = {
        "rgb_static": rng.uniform(size=(B, 2, 32, 32, 3)).astype(np.float32),
        "rgb_gripper": rng.uniform(size=(B, 2, 32, 32, 3)).astype(np.float32),
        "gen_static": rng.uniform(size=(B, 32, 32, 3)).astype(np.float32),
        "gen_gripper": rng.uniform(size=(B, 32, 32, 3)).astype(np.float32),
        "actions": rng.normal(size=(B, 10, 7)).astype(np.float32),
        "lang_tokens": rng.integers(1, 100, size=(B, 8)).astype(np.int32),
    }
    net, state = init_mdt_agent(JaxMDTConfig(**TINY), jax.random.PRNGKey(0), example)
    params = _perturbed(state.params, 3)
    port = MDTAgentNet(MDTConfig(**TINY), device="cpu")
    port.load_state_dict(from_jax.from_jax(params), strict=True)
    return net, params, port


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 98, size=(B, 8)).astype(np.int32)
    tokens[:, 5] = 99  # EOT: the largest id
    tokens[:, 6:] = 0
    return {"rgb_static": rng.normal(size=(B, 1, 32, 32, 3)).astype(np.float32),
            "rgb_gripper": rng.normal(size=(B, 1, 84, 84, 3)).astype(np.float32),
            "lang_tokens": tokens}


def test_from_jax_maps_every_leaf_of_the_mdt_tree():
    _, params, port = _agents()
    sd = from_jax.from_jax(params)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert "clip_proj" not in params  # the single-token head has no parameter
    assert len(sd) == len(leaves)
    assert sum(v.numel() for v in sd.values()) == sum(np.size(v) for _, v in leaves)
    assert set(sd) == set(port.state_dict())
    for name in ("visual_goal", "language_goal"):
        assert not any(p.requires_grad for p in getattr(port, name).parameters())
    assert all(p.requires_grad for p in port.static_resnet.parameters())


def test_mdt_agent_builds_on_cuda_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MDTAgentNet(MDTConfig(**TINY))


@pytest.mark.parametrize("field,value", [("sampler_type", "heun"),
                                         ("use_ada_conditioning", False),
                                         ("use_mlp_goal", False), ("goal_drop", 0.1)])
def test_mdt_unported_config_values_are_rejected(field, value):
    with pytest.raises(NotImplementedError, match=field):
        MDTAgentNet(MDTConfig(**{**TINY, field: value}), device="cpu")


def _jax_noises(seed, n):
    """The initial draws of the JAX policy's first `n` replans
    (mdtv_agent.py:702, :535-536)."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        rng, k = jax.random.split(rng)
        k_init, _ = jax.random.split(k)
        out.append(torch.from_numpy(np.array(jax.random.normal(k_init, (B, 10, 7)))))
    return out


def test_mdt_chunk_matches_jax():
    net, params, port = _agents()
    x = _inputs()
    apply = functools.partial(net.apply, {"params": params})
    emb = apply(x["rgb_static"], x["rgb_gripper"], method="perceive")
    goal = apply(x["lang_tokens"], method="encode_language_goal")
    chunk = jax.jit(functools.partial(jax_denoise, net, modality="lang"))(
        params, emb, goal, jax.random.PRNGKey(7))
    k_init, _ = jax.random.split(jax.random.PRNGKey(7))
    noise = torch.from_numpy(np.array(jax.random.normal(k_init, (B, 10, 7))))
    with torch.no_grad():
        p_emb = port.perceive(torch.from_numpy(x["rgb_static"]),
                              torch.from_numpy(x["rgb_gripper"]))
        p_goal = port.encode_language_goal(torch.from_numpy(x["lang_tokens"]))
        p_chunk = denoise_actions(port, p_emb, p_goal, noise=noise)
    for key in ("static", "gripper"):
        np.testing.assert_allclose(p_emb[key].numpy(), np.asarray(emb[key]), **TOL)
    np.testing.assert_allclose(p_goal.numpy(), np.asarray(goal), **TOL)
    np.testing.assert_allclose(p_chunk.numpy(), np.asarray(chunk), **CHUNK_TOL)


@pytest.mark.parametrize("goal_kind", ["lang_tokens", "rgb_static_goal"])
def test_mdt_policy_matches_jax_over_replans(goal_kind):
    """21 steps (three replans) through both policies with the same frames,
    goal and initial draws: every action agrees; the text tower runs once."""
    assert MDTPolicy is MDTVPolicy
    net, params, port = _agents()
    x = _inputs(seed=4)
    obs = {k: x[k] for k in ("rgb_static", "rgb_gripper")}
    goal = {goal_kind: x["lang_tokens"] if goal_kind == "lang_tokens"
            else x["rgb_static"][:, 0]}
    jpolicy = JaxPolicy(net, params, rng=jax.random.PRNGKey(11))
    jactions = [np.asarray(jpolicy.step(obs, goal)) for _ in range(21)]
    noises = iter(_jax_noises(11, 3))

    def with_noise(*args, generator, **kw):
        return denoise_actions(*args, noise=next(noises), **kw)
    policy = MDTPolicy(port, generator=torch.Generator().manual_seed(0))
    with mock.patch.object(port_agent, "denoise_actions", with_noise), \
            mock.patch.object(port, "encode_language_goal",
                              wraps=port.encode_language_goal) as encode:
        actions = [policy.step(obs, goal).numpy() for _ in range(21)]
    assert encode.call_count == (goal_kind == "lang_tokens")
    np.testing.assert_allclose(np.stack(actions), np.stack(jactions), **CHUNK_TOL)
