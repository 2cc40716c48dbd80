"""The CLIP ResNet goal tower of the port (`models/clip.py::CLIPResNetTower`,
CLIP's ModifiedResNet, `clip_vision_family="resnet"`) against the JAX
package on the CPU: the frozen BatchNorm, the anti-aliased Bottleneck, the
mean-token attention pool and the whole tower on the same weights (carried
across by `from_jax`) and images, in float32 and in the towers' bf16; then
a tiny MDT-V agent with the ResNet goal tower: its JAX tree carried across,
a goal-image replan through both policies, and one train step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdt_policy_tpu.agents.mdtv_agent import MDTVPolicy as JaxPolicy
from mdt_policy_tpu.models import clip as jclip
from mdt_policy_tpu_torch.agents import MDTVPolicy
from mdt_policy_tpu_torch.models import clip
from mdt_policy_tpu_torch.utils.from_jax import clip_resnet_from_jax
from test_torch_denoiser_configs import _agents, check_round_trip, check_train_step

# module bound in f32 (tests/test_torch_modules.py), relative to max|ref|
F32_TOL = dict(rtol=1e-4, atol=5e-5)
# bf16 weights and activations: every conv, norm and the pool round to bf16
# (3.9e-3 relative each) in both packages, at other points (cuDNN and
# PyTorch accumulate a conv, a mean and a pool in f32 and round once); the
# embedding is O(1): the bound of the bf16 towers of tests/test_torch_slice.py
BF16_ATOL = 5e-2
# the whole tiny replan's bound (tests/test_torch_slice.py, F32_TOL["chunk"])
CHUNK_TOL = dict(rtol=1e-3, atol=1e-3)
LAYERS, WIDTH, RES, EMBED = (2, 1, 1, 1), 8, 64, 16


def _nhwc(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _perturbed(params, seed=3):
    """JAX's init with N(0, 0.1) added, and the BatchNorm variances kept
    positive, so that no statistic is at its trivial init value."""
    rng = np.random.default_rng(seed)

    def one(path, p):
        p = np.asarray(p) + rng.normal(size=np.shape(p)).astype(np.float32) * 0.1
        return np.abs(p) + 0.5 if path[-1].key == "var" else p.astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, params)


@functools.cache
def _tower():
    jm = jclip.CLIPResNetTower(embed_dim=EMBED, layers=LAYERS, width=WIDTH,
                               image_resolution=RES)
    x = _nhwc((2, RES, RES, 3), 0)
    params = _perturbed(jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), x)["params"]))
    pm = clip.CLIPResNetTower(EMBED, LAYERS, WIDTH, RES)
    pm.load_state_dict(clip_resnet_from_jax(params), strict=True)
    return jm, params, pm, x


def test_frozen_batchnorm_matches_jax():
    jm = jclip._FrozenBatchNorm()
    x = _nhwc((2, 5, 5, 6), 1)
    params = _perturbed(jax.device_get(jm.init(jax.random.PRNGKey(0), x)["params"]))
    pm = clip.FrozenBatchNorm2d(6)
    pm.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(params["mean"]),
                        "running_var": torch.from_numpy(params["var"])})
    ref = np.asarray(jm.apply({"params": params}, x))
    out = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stride,inplanes", [(1, 8), (1, 32), (2, 32)])
def test_bottleneck_matches_jax(stride, inplanes):
    """The Bottleneck with and without the downsample branch, anti-aliased
    (average pool after conv2 and before the downsample conv) at stride 2."""
    jm = jclip._Bottleneck(planes=8, stride=stride)
    x = _nhwc((2, 8, 8, inplanes), 2)
    params = _perturbed(jax.device_get(jm.init(jax.random.PRNGKey(1), x)["params"]))
    pm = clip.Bottleneck(inplanes, 8, stride)
    sd = clip_resnet_from_jax({"layer1_0": params, "attnpool": _tower()[1]["attnpool"],
                               **{k: _tower()[1][k] for k in ("conv1", "conv2", "conv3",
                                                              "bn1", "bn2", "bn3")}})
    pm.load_state_dict({k[len("layer1.0."):]: v for k, v in sd.items()
                        if k.startswith("layer1.0.")}, strict=True)
    assert (pm.downsample is None) == (stride == 1 and inplanes == 32)
    ref = np.asarray(jm.apply({"params": params}, x))
    out = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), ref, **F32_TOL)


def test_attention_pool_matches_jax():
    """Only the mean token's query is formed, as in JAX; 4 heads of 64."""
    jm = jclip.AttentionPool2d(embed_dim=256, num_heads=4, output_dim=EMBED, spacial_dim=2)
    x = _nhwc((2, 2, 2, 256), 4)
    params = _perturbed(jax.device_get(jm.init(jax.random.PRNGKey(2), x)["params"]))
    pm = clip.AttentionPool2d(2, 256, 4, EMBED)
    sd = clip_resnet_from_jax({"attnpool": params, **{k: v for k, v in _tower()[1].items()
                                                      if k != "attnpool"}})
    pm.load_state_dict({k[len("attnpool."):]: v for k, v in sd.items()
                        if k.startswith("attnpool.")}, strict=True)
    ref = np.asarray(jm.apply({"params": params}, x))
    out = pm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.detach().numpy(), ref, **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_tower_matches_jax(dtype):
    """The whole tower (stem, two Bottlenecks in the first stage, one in
    each of the others, the pool) from `clip_resnet_from_jax` of the JAX
    tree: f32 at the module bound; bf16 weights and images, as the agent
    runs its frozen towers, at BF16_ATOL."""
    jm, params, pm, x = _tower()
    if dtype == "float32":
        ref = np.asarray(jax.jit(jm.apply)({"params": params}, x))
        with torch.no_grad():
            out = pm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, ref, **F32_TOL)
        return
    jparams = jax.tree.map(lambda p: jnp.asarray(p, jnp.bfloat16), params)
    ref = np.asarray(jm.apply({"params": jparams}, jnp.asarray(x, jnp.bfloat16)), np.float32)
    low = clip.CLIPResNetTower(EMBED, LAYERS, WIDTH, RES)
    low.load_state_dict(pm.state_dict())
    low.to(torch.bfloat16)
    with torch.no_grad():
        out = low(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert out.dtype == np.float32 and np.isfinite(out).all()
    # shown with `pytest -s`; PERF.md quotes it
    print(f"bf16 ResNet tower: max |port - jax| = {np.abs(out - ref).max():.3g} "
          f"(max |jax| {np.abs(ref).max():.3g})")
    np.testing.assert_allclose(out, ref, rtol=0, atol=BF16_ATOL)


def test_resnet_agent_from_jax_round_trip():
    """A tiny MDT-V agent with the ResNet goal tower: its JAX tree loads
    into the port strictly, the tower's BatchNorm statistics as buffers."""
    check_round_trip("resnet_goal")
    _, _, port = _agents("resnet_goal")
    assert isinstance(port.visual_goal, clip.CLIPResNetTower)
    assert port.visual_goal.layer1[0].bn1.running_var.dtype == torch.float32
    assert not any(p.requires_grad for p in port.visual_goal.parameters())


def test_resnet_goal_image_replan_matches_jax_policy():
    """A goal-image replan through both policies' `step`: the ResNet tower
    embeds the goal frame, in the "vis" modality, from the same frames and
    the JAX policy's own initial draw; the chunk at the chunk bound."""
    net, state, port = _agents("resnet_goal")
    rng = np.random.default_rng(6)
    obs = {"rgb_static": rng.normal(size=(2, 1, 32, 32, 3)).astype(np.float32),
           "rgb_gripper": rng.normal(size=(2, 1, 84, 84, 3)).astype(np.float32)}
    goal = {"rgb_static_goal": obs["rgb_static"][:, 0]}
    jpolicy = JaxPolicy(net, state.params, rng=jax.random.PRNGKey(11))
    ja = jpolicy.step(obs, goal)
    _, k = jax.random.split(jax.random.PRNGKey(11))
    noise = torch.from_numpy(np.array(jax.random.normal(jax.random.split(k)[0], (2, 10, 7))))
    policy = MDTVPolicy(port, generator=torch.Generator().manual_seed(0))
    policy._draw_noise = lambda batch: noise
    pa = policy.step(obs, goal)
    np.testing.assert_allclose(policy.pred_action_seq.numpy(),
                               np.asarray(jpolicy.pred_action_seq), **CHUNK_TOL)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), **CHUNK_TOL)


def test_resnet_agent_train_step_matches_jax():
    """One train step with the ResNet goal tower (its embedding is the vis
    scope's goal and the contrastive loss's image goal), as the config
    parity tests hold the others."""
    check_train_step("resnet_goal")
