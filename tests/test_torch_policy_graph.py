"""The policy's replan of the PyTorch port (`MDTVPolicy._predict_emb` and
`_predict_vis`, the counterparts of the JAX policy's jitted methods of the
same names) against the JAX policy, for both agent families and both goal
modalities, run eagerly on the CPU; the `cuda_graph` flag; the graph route's
input and output handling and its launch counts with a stand-in for the
captured graph; and, on the card, the captured replan against the eager
one, for the production sampler and every other captured sampler, and
dpm_adaptive's eager route.

The JAX package is imported inside the parity tests, so that on a GPU
machine without JAX the `cuda` tests of this file run alone:

    python -m pytest tests/test_torch_policy_graph.py -m cuda --noconftest
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

from mdt_policy_tpu_torch.agents import (MDTAgentNet, MDTConfig, MDTVAgentNet, MDTVConfig,
                                         MDTVPolicy, init_random_)
from mdt_policy_tpu_torch.diffusion.samplers import SAMPLER_NAMES
from mdt_policy_tpu_torch.models import blocks
from mdt_policy_tpu_torch.ops import _build
from mdt_policy_tpu_torch.ops.small_seq_mha import small_seq_mha, small_seq_mha_reference

B = 2
_COMMON = dict(
    latent_dim=32, embed_dim=32, obs_dim=32, goal_dim=16, clip_embed_dim=16,
    n_heads=2, img_size=32, clip_vision_width=32, clip_vision_layers=1,
    clip_vision_patch=16, clip_text_width=16, clip_text_layers=1, clip_text_heads=2,
    clip_context_length=8, clip_vocab_size=100, gen_img_res=32, gen_patch_size=16,
    gen_decoder_depth=1, gen_decoder_dim=16, gen_decoder_heads=2,
    num_sampling_steps=10, compute_dtype="float32")
# the tiny configs of tests/test_torch_slice.py (MDT-V) and
# tests/test_torch_mdt.py (MDT), towers in f32
TINY = {"mdtv": dict(_COMMON, n_enc_layers=1, n_dec_layers=1, perceiver_dim=32,
                     perceiver_depth=1, perceiver_heads=2, perceiver_dim_head=8,
                     num_latents=3, vit_patch=16, vit_depth=1, vit_heads=2),
        "mdt": dict(_COMMON, n_enc_layers=2, n_dec_layers=2)}
# the whole tiny replan's bound (tests/test_torch_slice.py, F32_TOL["chunk"])
CHUNK_TOL = dict(rtol=1e-3, atol=1e-3)


def _port_net(family, device):
    cfg = (MDTVConfig if family == "mdtv" else MDTConfig)(**TINY[family])
    return (MDTVAgentNet if family == "mdtv" else MDTAgentNet)(cfg, device=device)


def _inputs(batch, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 98, size=(batch, 8)).astype(np.int32)
    tokens[:, 5] = 99  # EOT: the largest id
    tokens[:, 6:] = 0
    return {"rgb_static": rng.normal(size=(batch, 1, 32, 32, 3)).astype(np.float32),
            "rgb_gripper": rng.normal(size=(batch, 1, 84, 84, 3)).astype(np.float32),
            "lang_tokens": tokens}


def _obs_goal(x, modality):
    obs = {k: x[k] for k in ("rgb_static", "rgb_gripper")}
    goal = {"lang_tokens": x["lang_tokens"]} if modality == "lang" \
        else {"rgb_static_goal": x["rgb_static"][:, 0]}
    return obs, goal


@functools.cache
def _agents(family):
    """(JAX net, its parameters plus N(0, 0.1), the port net with them)."""
    import jax
    from mdt_policy_tpu.agents import MDTConfig as JaxMDTConfig
    from mdt_policy_tpu.agents import MDTVConfig as JaxMDTVConfig
    from mdt_policy_tpu.agents import init_agent, init_mdt_agent
    from mdt_policy_tpu_torch.utils.from_jax import from_jax
    rng = np.random.default_rng(1)
    gripper = 84 if family == "mdtv" else 32
    example = {
        "rgb_static": rng.uniform(size=(B, 2, 32, 32, 3)).astype(np.float32),
        "rgb_gripper": rng.uniform(size=(B, 2, gripper, gripper, 3)).astype(np.float32),
        "gen_static": rng.uniform(size=(B, 32, 32, 3)).astype(np.float32),
        "gen_gripper": rng.uniform(size=(B, 32, 32, 3)).astype(np.float32),
        "actions": rng.normal(size=(B, 10, 7)).astype(np.float32),
        "lang_tokens": rng.integers(1, 100, size=(B, 8)).astype(np.int32),
    }
    init, jcfg = (init_agent, JaxMDTVConfig) if family == "mdtv" \
        else (init_mdt_agent, JaxMDTConfig)
    net, state = init(jcfg(**TINY[family]), jax.random.PRNGKey(0), example)
    noise = np.random.default_rng(103)
    params = jax.tree.map(lambda p: (np.asarray(p) + noise.normal(size=np.shape(p)) * 0.1)
                          .astype(np.float32), jax.device_get(state.params))
    port = _port_net(family, "cpu")
    port.load_state_dict(from_jax(params), strict=True)
    return net, params, port


@pytest.mark.parametrize("family", ["mdtv", "mdt"])
@pytest.mark.parametrize("modality", ["lang", "vis"])
def test_replan_methods_match_jax_policy(family, modality):
    """One step through both policies from the same frames, goal and
    initial draw: the port's replan runs through `_predict_emb` (text goal)
    or `_predict_vis` (goal image) once, eagerly, and gives the JAX chunk."""
    import jax
    from mdt_policy_tpu.agents.mdtv_agent import MDTVPolicy as JaxPolicy
    net, params, port = _agents(family)
    obs, goal = _obs_goal(_inputs(B, seed=4), modality)
    jpolicy = JaxPolicy(net, params, rng=jax.random.PRNGKey(11))
    jaction = jpolicy.step(obs, goal)
    # the JAX policy's initial draw (mdtv_agent.py:702, :535-536), for the port
    _, k = jax.random.split(jax.random.PRNGKey(11))
    k_init, _ = jax.random.split(k)
    noise = torch.from_numpy(np.array(jax.random.normal(k_init, (B, 10, 7))))
    policy = MDTVPolicy(port, generator=torch.Generator().manual_seed(0))
    assert policy.cuda_graph is False
    method = "_predict_emb" if modality == "lang" else "_predict_vis"
    with mock.patch.object(policy, "_draw_noise", lambda batch: noise), \
            mock.patch.object(policy, method, wraps=getattr(policy, method)) as predict:
        action = policy.step(obs, goal)
    assert predict.call_count == 1
    np.testing.assert_allclose(policy.pred_action_seq.numpy(),
                               np.asarray(jpolicy.pred_action_seq), **CHUNK_TOL)
    np.testing.assert_allclose(action.numpy(), np.asarray(jaction), **CHUNK_TOL)


def test_cuda_graph_flag_follows_the_net_and_refuses_a_cpu_net():
    net = _port_net("mdtv", "cpu")
    assert MDTVPolicy(net).cuda_graph is False
    assert MDTVPolicy(net, cuda_graph=False).cuda_graph is False
    with pytest.raises(ValueError, match="cuda_graph=True needs a net on a CUDA device"):
        MDTVPolicy(net, cuda_graph=True)


class _Recomputed:
    """Stands in for a captured CUDAGraph: a replay recomputes the captured
    function from the static inputs into the static output (its launches
    are the ones the capture recorded, which the policy counts)."""

    def __init__(self, predict, static, out):
        self.predict, self.static, self.out = predict, static, out

    def replay(self):
        with _build.recording_launches():
            self.out.copy_(self.predict(*self.static))


def _counted_b2(q, k, v, causal=False):
    """B2's plain version, counting a launch as the kernel's wrapper does."""
    _build.count_launch(small_seq_mha)
    return small_seq_mha_reference(q, k, v, causal)


def test_launches_count_at_replay_not_at_capture():
    """A capture under `recording_launches` runs no kernel and counts none;
    each replay counts what the capture recorded; an eager launch counts
    one."""
    def wrapper():
        pass
    wrapper.launches = 0
    _build.count_launch(wrapper)
    with _build.recording_launches() as recorded:
        _build.count_launch(wrapper)
        _build.count_launch(wrapper)
    assert wrapper.launches == 1 and recorded == {wrapper: 2}
    for _ in range(3):
        _build.count_replay(recorded)
    assert wrapper.launches == 7
    _build.count_launch(wrapper)  # recording ended with the block
    assert wrapper.launches == 8


@pytest.mark.parametrize("family", ["mdtv", "mdt"])
def test_graph_route_feeds_new_inputs_and_returns_fresh_chunks(family):
    """The graph route with a stand-in for the capture (recording launches
    as `MDTVPolicy._capture` does): one capture per (method, input shapes);
    each replan copies its frames, goal and noise into the static buffers,
    so it gives the eager chunk for its own inputs; a returned chunk
    survives the next replay; B2's launches, counted at each replay and not
    at the capture, are the eager policy's."""
    net = _port_net(family, "cpu")
    init_random_(net, torch.Generator().manual_seed(0))
    graph = MDTVPolicy(net, generator=torch.Generator().manual_seed(3))
    graph.cuda_graph = True  # the route itself; a CPU net refuses the flag

    def capture(predict, inputs):
        static = [t.clone() for t in inputs]
        with _build.recording_launches() as launched:
            out = predict(*static)
        return _Recomputed(predict, static, out), static, out, launched
    eager = MDTVPolicy(net, generator=torch.Generator().manual_seed(3))
    frames = [_obs_goal(_inputs(b, seed), m) for b, seed, m in
              ((B, 1, "lang"), (B, 2, "lang"), (B, 3, "vis"), (3, 4, "lang"))]
    with mock.patch.object(blocks, "small_seq_mha", _counted_b2):
        small_seq_mha.launches = 0
        with mock.patch.object(graph, "_capture", side_effect=capture) as captured:
            chunks = [graph.plan(obs, goal) for obs, goal in frames]
        graph_launches, small_seq_mha.launches = small_seq_mha.launches, 0
        eager_chunks = [eager.plan(obs, goal) for obs, goal in frames]
        eager_launches, small_seq_mha.launches = small_seq_mha.launches, 0
    assert captured.call_count == 3  # lang at B=2, vis at B=2, lang at B=3
    for chunk, ref in zip(chunks, eager_chunks):
        torch.testing.assert_close(chunk, ref, rtol=0, atol=0)
    assert not torch.equal(chunks[0], chunks[1])
    assert graph_launches == eager_launches > 0


def test_graph_route_takes_a_stochastic_samplers_draws_as_inputs():
    """A stochastic sampler's per-step draws are graph inputs, drawn from
    the policy's generator outside the graph: with the capture stand-in,
    each replan of euler_ancestral gives the eager chunk of its own draws
    (a replay that kept the first draws would repeat its chunk)."""
    import dataclasses
    net = _port_net("mdtv", "cpu")
    init_random_(net, torch.Generator().manual_seed(0))
    net.cfg = dataclasses.replace(net.cfg, sampler_type="euler_ancestral")
    graph = MDTVPolicy(net, generator=torch.Generator().manual_seed(3))
    graph.cuda_graph = True

    def capture(predict, inputs):
        static = [t.clone() for t in inputs]
        with _build.recording_launches() as launched:
            out = predict(*static)
        return _Recomputed(predict, static, out), static, out, launched
    eager = MDTVPolicy(net, generator=torch.Generator().manual_seed(3))
    obs, goal = _obs_goal(_inputs(B, 1), "lang")
    with mock.patch.object(graph, "_capture", side_effect=capture) as captured:
        chunks = [graph.plan(obs, goal) for _ in range(2)]
    assert captured.call_count == 1
    static = next(iter(graph._graphs.values()))[1]
    assert len(static) == 5 and static[-1].shape == (10, B, 10, 7)
    for chunk in chunks:
        torch.testing.assert_close(chunk, eager.plan(obs, goal), rtol=0, atol=0)
    assert not torch.equal(*chunks)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graph is captured on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["mdtv", "mdt"])
@pytest.mark.parametrize("batch", [1, 3])
def test_cuda_graph_replan_matches_eager(cuda, family, batch):
    """The captured replan against the eager one from the same seed, for a
    text goal and a goal image, over two replans with other frames: each
    replay gives the eager chunk of its own frames, bit for bit: the two
    run the same kernels on the same inputs (and at the production widths
    `chip_smoke.py` measured them bit-equal)."""
    net = _port_net(family, cuda)
    init_random_(net, torch.Generator().manual_seed(0))
    for modality in ("lang", "vis"):
        frames = [_obs_goal(_inputs(batch, seed), modality) for seed in (1, 2)]
        chunks = {}
        for graph in (True, False):
            policy = MDTVPolicy(net, generator=torch.Generator(cuda).manual_seed(3),
                                cuda_graph=graph)
            assert policy.cuda_graph is graph
            chunks[graph] = [policy.plan(obs, goal) for obs, goal in frames]
        for mine, ref in zip(chunks[True], chunks[False]):
            assert mine.shape == (batch, 10, 7) and torch.isfinite(mine).all()
            torch.testing.assert_close(mine, ref, rtol=0, atol=0)
        assert not torch.equal(*chunks[True])


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", [s for s in SAMPLER_NAMES if s != "dpm_adaptive"])
def test_cuda_graph_replan_matches_eager_every_sampler(cuda, sampler):
    """Each captured sampler against its eager replan from the same seed
    (the initial noise and the per-step draws made outside the graph), at
    B=3 with a text goal, over two replans: bit for bit."""
    import dataclasses
    net = _port_net("mdtv", cuda)
    init_random_(net, torch.Generator().manual_seed(0))
    net.cfg = dataclasses.replace(net.cfg, sampler_type=sampler)
    frames = [_obs_goal(_inputs(3, seed), "lang") for seed in (1, 2)]
    chunks = {}
    for graph in (True, False):
        policy = MDTVPolicy(net, generator=torch.Generator(cuda).manual_seed(3),
                            cuda_graph=graph)
        chunks[graph] = [policy.plan(obs, goal) for obs, goal in frames]
    for mine, ref in zip(chunks[True], chunks[False]):
        assert torch.isfinite(mine).all()
        torch.testing.assert_close(mine, ref, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_dpm_adaptive_runs_eager_and_refuses_a_graph(cuda):
    """dpm_adaptive decides its steps on the host: on the card its policy
    defaults to the eager route and `cuda_graph=True` raises."""
    import dataclasses
    net = _port_net("mdtv", cuda)
    init_random_(net, torch.Generator().manual_seed(0))
    net.cfg = dataclasses.replace(net.cfg, sampler_type="dpm_adaptive")
    policy = MDTVPolicy(net, generator=torch.Generator(cuda).manual_seed(3))
    assert policy.cuda_graph is False
    obs, goal = _obs_goal(_inputs(2, 1), "lang")
    assert torch.isfinite(policy.plan(obs, goal)).all()
    with pytest.raises(ValueError, match="dpm_adaptive"):
        MDTVPolicy(net, cuda_graph=True)
