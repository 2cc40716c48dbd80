"""The whole MDT-V replan of the PyTorch port against the JAX package, at a
tiny config: the JAX agent from `init_agent`, its parameters carried into
the port by `from_jax`, then Voltron + perceiver, the CLIP text goal and
DDIM-10 on both sides with the same frames, tokens and initial noise."""

import ast
import functools
import pathlib
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from mdt_policy_tpu.agents import MDTVConfig as JaxConfig
from mdt_policy_tpu.agents import init_agent
from mdt_policy_tpu.agents.mdtv_agent import MDTVPolicy as JaxPolicy
from mdt_policy_tpu.agents.mdtv_agent import denoise_actions as jax_denoise
from mdt_policy_tpu_torch.agents import (MDTVAgentNet, MDTVConfig, MDTVPolicy,
                                         denoise_actions)
from mdt_policy_tpu_torch.agents import mdtv_agent as port_agent
from mdt_policy_tpu_torch.utils.from_jax import from_jax

# TINY_OVERRIDES of tests/test_training_cli.py, with the production DDIM-10
TINY = dict(
    latent_dim=32, embed_dim=32, obs_dim=32, goal_dim=16, clip_embed_dim=16,
    n_enc_layers=1, n_dec_layers=1, n_heads=2,
    perceiver_dim=32, perceiver_depth=1, perceiver_heads=2, perceiver_dim_head=8,
    num_latents=3, img_size=32, vit_patch=16, vit_depth=1, vit_heads=2,
    clip_vision_width=32, clip_vision_layers=1, clip_vision_patch=16,
    clip_text_width=16, clip_text_layers=1, clip_text_heads=2,
    clip_context_length=8, clip_vocab_size=100,
    gen_img_res=32, gen_patch_size=16, gen_decoder_depth=1, gen_decoder_dim=16,
    gen_decoder_heads=2, num_sampling_steps=10,
)
B = 2
REPO = pathlib.Path(__file__).resolve().parent.parent


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 98, size=(B, 8)).astype(np.int32)
    tokens[:, 5] = 99  # EOT: the largest id
    tokens[:, 6:] = 0
    return {
        "rgb_static": rng.normal(size=(B, 1, 32, 32, 3)).astype(np.float32),
        "rgb_gripper": rng.normal(size=(B, 1, 84, 84, 3)).astype(np.float32),
        "lang_tokens": tokens,
    }


@functools.cache
def _agents(compute_dtype):
    jcfg = JaxConfig(**TINY, compute_dtype=compute_dtype)
    rng = np.random.default_rng(1)
    example = {
        "rgb_static": rng.uniform(size=(B, 2, 32, 32, 3)).astype(np.float32),
        "rgb_gripper": rng.uniform(size=(B, 2, 84, 84, 3)).astype(np.float32),
        "gen_static": rng.uniform(size=(B, 32, 32, 3)).astype(np.float32),
        "gen_gripper": rng.uniform(size=(B, 32, 32, 3)).astype(np.float32),
        "actions": rng.normal(size=(B, 10, 7)).astype(np.float32),
        "lang_tokens": rng.integers(1, 100, size=(B, 8)).astype(np.int32),
    }
    net, state = init_agent(jcfg, jax.random.PRNGKey(0), example)
    params = jax.device_get(state.params)
    port = MDTVAgentNet(MDTVConfig(**TINY, compute_dtype=compute_dtype),
                        device="cpu")
    port.load_state_dict(from_jax(params), strict=True)
    return net, params, port


@functools.cache
def _replans(compute_dtype):
    """(JAX, port) perceiver latents, goal embeddings and action chunks."""
    net, params, port = _agents(compute_dtype)
    x = _inputs()
    apply = functools.partial(net.apply, {"params": params})
    emb = jax.jit(functools.partial(apply, method="compute_voltron_embeddings"))(
        x["rgb_static"], x["rgb_gripper"])
    goal = jax.jit(functools.partial(apply, method="encode_language_goal"))(
        x["lang_tokens"])
    key = jax.random.PRNGKey(7)
    chunk = jax.jit(functools.partial(jax_denoise, net, modality="lang"))(
        params, emb, goal, key)
    # JAX's own initial draw (agents/mdtv_agent.py:535-536), handed to the port
    k_init, _ = jax.random.split(key)
    noise = np.array(jax.random.normal(k_init, (B, 10, 7)))  # writable copy
    with torch.no_grad():
        p_emb = port.compute_voltron_embeddings(torch.from_numpy(x["rgb_static"]),
                                                torch.from_numpy(x["rgb_gripper"]))
        p_goal = port.encode_language_goal(torch.from_numpy(x["lang_tokens"]))
        p_chunk = denoise_actions(port, p_emb, p_goal, noise=torch.from_numpy(noise))
    return ({"emb": np.asarray(emb["state_images"], np.float32),
             "goal": np.asarray(goal), "chunk": np.asarray(chunk)},
            {"emb": p_emb["state_images"].float().numpy(),
             "goal": p_goal.numpy(), "chunk": p_chunk.numpy()})


# f32: every stage at the module bound (rtol 1e-4, atol 5e-5), the chunk at
# the chunk-parity bound of tests/test_torch_port.py (1e-3) after 10 steps
F32_TOL = {"emb": (1e-4, 5e-5), "goal": (1e-4, 5e-5), "chunk": (1e-3, 1e-3)}
# bf16 towers: the JAX towers run `sdpa`, which rounds the scores to bf16,
# while B1 keeps them in f32; the JAX RMSNorm rounds x/norm and then *g in
# bf16, while B3 rounds once; and bf16 keeps 8 significant bits (3.9e-3
# relative per rounding) through every block; latents and goal embeddings
# are O(1). Measured at this config with B1 only: 1.2e-2 (latents), 1.6e-2
# (goal), 2.7e-4 (chunk); with B1 and B3: 1.5e-2, 1.1e-2, 2.0e-4.
BF16_ATOL = {"emb": 5e-2, "goal": 5e-2, "chunk": 1e-2}


@pytest.mark.parametrize("stage", ["emb", "goal", "chunk"])
def test_replan_matches_jax_f32(stage):
    ref, out = _replans("float32")
    assert out[stage].shape == ref[stage].shape
    rtol, atol = F32_TOL[stage]
    np.testing.assert_allclose(out[stage], ref[stage], rtol=rtol, atol=atol)


@pytest.mark.parametrize("stage", ["emb", "goal", "chunk"])
def test_replan_matches_jax_bf16_towers(stage):
    ref, out = _replans("bfloat16")
    _, _, port = _agents("bfloat16")
    assert port.img_encoder.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert port.perceiver.layers[0][0].to_q.weight.dtype == torch.float32
    assert np.isfinite(out[stage]).all()
    # shown with `pytest -s`; PERF.md quotes it
    print(f"bf16 towers, {stage}: max |port - jax| = "
          f"{np.abs(out[stage] - ref[stage]).max():.3g}")
    np.testing.assert_allclose(out[stage], ref[stage], rtol=0,
                               atol=BF16_ATOL[stage])


def test_policy_caches_the_goal_and_replays_the_chunk():
    _, _, port = _agents("float32")
    x = _inputs(seed=3)
    obs = {k: x[k] for k in ("rgb_static", "rgb_gripper")}
    policy = MDTVPolicy(port, generator=torch.Generator().manual_seed(5))
    policy.reset()
    with mock.patch.object(port, "encode_language_goal",
                           wraps=port.encode_language_goal) as encode:
        actions = [policy.step(obs, {"lang_tokens": x["lang_tokens"]})
                   for _ in range(20)]
        assert encode.call_count == 1  # one goal, two replans
        other = x["lang_tokens"].copy()
        other[:, 1] += 1
        policy.step(obs, {"lang_tokens": other})
        assert encode.call_count == 2
    assert all(a.shape == (B, 7) and torch.isfinite(a).all() for a in actions)

    # the first chunk is denoise_actions on the same draws, replayed in order
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        emb = port.perceive(torch.from_numpy(obs["rgb_static"]),
                            torch.from_numpy(obs["rgb_gripper"]))
        goal = port.encode_language_goal(torch.from_numpy(x["lang_tokens"]))
        chunk = denoise_actions(port, emb, goal, generator=gen)
    torch.testing.assert_close(torch.stack(actions[:10], dim=1), chunk,
                               rtol=0, atol=0)

    # a precomputed goal embedding takes the same path without the text tower
    policy.reset()
    a = policy.step(obs, {"lang": goal.numpy()})
    assert a.shape == (B, 7)
    # a goal image runs the CLIP vision tower and the "vis" goal projection
    policy.reset()
    goal_image = x["rgb_static"][:, 0]
    with mock.patch.object(port, "encode_visual_goal",
                           wraps=port.encode_visual_goal) as encode_image:
        a = policy.step(obs, {"rgb_static_goal": goal_image})
        assert encode_image.call_count == 1
    assert a.shape == (B, 7) and torch.isfinite(a).all()


def test_policy_vis_goal_replan_matches_jax():
    """A goal-image replan through both policies' `step` (CLIP vision goal,
    the "vis" modality): the same frames, goal image and initial noise give
    the same chunk, at the chunk bound of the lang replan."""
    net, params, port = _agents("float32")
    x = _inputs(seed=6)
    obs = {k: x[k] for k in ("rgb_static", "rgb_gripper")}
    goal = {"rgb_static_goal": x["rgb_static"][:, 0]}
    jpolicy = JaxPolicy(net, params, rng=jax.random.PRNGKey(11))
    ja = jpolicy.step(obs, goal)
    # the JAX policy's initial draw (mdtv_agent.py:702, :535-536), for the port
    _, k = jax.random.split(jax.random.PRNGKey(11))
    k_init, _ = jax.random.split(k)
    noise = torch.from_numpy(np.array(jax.random.normal(k_init, (B, 10, 7))))

    def with_noise(*args, generator, **kw):
        return denoise_actions(*args, noise=noise, **kw)
    policy = MDTVPolicy(port, generator=torch.Generator().manual_seed(0))
    with mock.patch.object(port_agent, "denoise_actions", with_noise), \
            mock.patch.object(port, "encode_visual_goal",
                              wraps=port.encode_visual_goal) as encode_image:
        pa = policy.step(obs, goal)
        assert encode_image.call_count == 1
    rtol, atol = F32_TOL["chunk"]
    np.testing.assert_allclose(policy.pred_action_seq.numpy(),
                               np.asarray(jpolicy.pred_action_seq), rtol=rtol, atol=atol)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=rtol, atol=atol)


def test_denoise_actions_needs_a_generator_or_noise():
    _, _, port = _agents("float32")
    emb = {"state_images": torch.zeros(B, 3, 32)}
    with pytest.raises(ValueError, match="generator"):
        denoise_actions(port, emb, torch.zeros(B, 16))
    with pytest.raises(ValueError, match="noise"):
        denoise_actions(port, emb, torch.zeros(B, 16), noise=torch.zeros(B, 9, 7))


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py, imports without pulling
    in JAX or the JAX package; and no import statement anywhere in them,
    function-level ones included, names either."""
    code = ("import pkgutil, sys\n"
            "import mdt_policy_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'mdt_policy_tpu_torch.')]\n"
            "assert len(names) > 20, names\n"
            "for needed in ('ops.attention_halfblock', 'ops.mlp_halfblock', "
            "'data.extract_embeddings', 'data.transforms', 'utils.clip_tokenizer', "
            "'ops.small_seq_mha', 'models.resnet', 'models.mdt_transformer', "
            "'agents.mdt_agent', 'utils.fnv', 'data.loader', 'evaluation.tasks', "
            "'evaluation.sequences', 'evaluation.initial_states', "
            "'evaluation.annotations', 'evaluation.fake_env', 'evaluation.rollout', "
            "'evaluation.policy_adapter', 'evaluation.batched_rollout'):\n"
            "    assert 'mdt_policy_tpu_torch.' + needed in names, needed\n"
            "for name in names + ['chip_smoke']:\n"
            "    __import__(name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'mdt_policy_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr

    sources = sorted((REPO / "mdt_policy_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            else:
                continue
            assert not set(roots) & {"jax", "jaxlib", "flax", "mdt_policy_tpu"}, \
                (path, roots)


@pytest.mark.parametrize("field,value", [
    ("sampler_type", "heun"), ("use_ada_conditioning", False),
    ("use_noise_encoder", True), ("use_mlp_goal", False),
    ("use_modality_encoder", False), ("denoiser_compute_dtype", "bfloat16"),
    ("clip_vision_family", "resnet"), ("sigma_sample_density_type", "lognormal"),
    ("embed_pdrob", 0.1), ("goal_drop", 0.1),
])
def test_unported_config_values_are_rejected(field, value):
    with pytest.raises(NotImplementedError, match=field):
        MDTVAgentNet(MDTVConfig(**{**TINY, field: value}), device="cpu")
