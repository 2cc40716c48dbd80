"""The port's sampler suite, log-likelihood and sigma densities against the
JAX package on the CPU: every sampler name on a toy denoiser with JAX's own
per-step draws, dpm_adaptive's step count, log_likelihood's Dormand-Prince
integration and its forward-mode product, every density on the same raw
draws; then every sampler through a tiny MDT-V replan, and a stochastic
sampler through both policies over three replans with the JAX policy's
draws.

The JAX samplers draw `jax.random.normal(keys[i], x.shape)` over
`jax.random.split(key, n)`; the port takes those n arrays as `noise`
(`samplers.n_step_draws` says how many), so both sides see the same
numbers.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdt_policy_tpu.agents.mdtv_agent import MDTVPolicy as JaxPolicy
from mdt_policy_tpu.agents.mdtv_agent import denoise_actions as jax_denoise
from mdt_policy_tpu.diffusion import densities as jdensities
from mdt_policy_tpu.diffusion import precond as jprecond
from mdt_policy_tpu.diffusion import samplers as jsamplers
from mdt_policy_tpu_torch.agents import MDTVPolicy, denoise_actions
from mdt_policy_tpu_torch.diffusion import densities, precond, samplers, schedules
from mdt_policy_tpu_torch.ops._plain_backward import launch_with_plain_backward
from mdt_policy_tpu_torch.ops.small_seq_mha import small_seq_mha_reference
from test_torch_slice import B, _agents, _inputs

SIGMAS = schedules.get_noise_schedule(10, "exponential", 0.001, 80.0)
SHAPE = (2, 10, 7)
W = (np.random.default_rng(1).normal(size=(7, 7)) * 0.3).astype(np.float32)
# |port - JAX| on the toy chunk (values of order 1): both run the same f32
# steps, but JAX's Euler, Heun and DPM-2 programs round differently from
# their own float64 result by up to 4e-4 (measured: the port stays within
# 1e-6 of float64 on every sampler, which the second bound holds)
TOY_TOL = dict(rtol=0, atol=1e-3)
F64_TOL = dict(rtol=0, atol=2e-5)
# the tiny replan's chunk bound (tests/test_torch_slice.py, F32_TOL["chunk"])
CHUNK_TOL = dict(rtol=1e-3, atol=1e-3)


def _inner_j(xin, s):
    return jnp.tanh(xin @ W) * jnp.log1p(s)[:, None, None]


def _inner_p(xin, s):
    w = torch.from_numpy(W).to(xin.dtype)
    return torch.tanh(xin @ w) * torch.log1p(s)[:, None, None]


def jden(x, sigma):
    return jprecond.precond_denoise(_inner_j, x, jnp.broadcast_to(
        jnp.asarray(sigma, jnp.float32), (x.shape[0],)), 0.5)


def pden(x, sigma, counter=None):
    if counter is not None:
        counter.append(float(sigma))
    s = torch.full((x.shape[0],), float(sigma), dtype=x.dtype)
    return precond.precond_denoise(_inner_p, x, s, 0.5)


def _x0(seed=0):
    return (np.random.default_rng(seed).normal(size=SHAPE) * 80.0).astype(np.float32)


def _jax_draws(key, n, shape):
    """JAX's per-step draws: normal(k) over split(key, n), as (n, *shape)."""
    if not n:
        return None
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, shape))
                                      for k in jax.random.split(key, n)]))


@pytest.mark.parametrize("name", samplers.SAMPLER_NAMES)
def test_sampler_matches_jax(name):
    """Each sampler of `sample_loop` on a toy denoiser, from the same x and
    JAX's own draws, at TOY_TOL against JAX and F64_TOL against the port's
    own float64 run; the port calls the denoiser as often as
    `denoiser_evaluations` says, and takes `n_step_draws` draws."""
    key = jax.random.PRNGKey(3)
    x0 = _x0()
    ref = np.asarray(jsamplers.sample_loop(name, jden, jnp.asarray(x0), SIGMAS, key=key))
    n = samplers.n_step_draws(name, SIGMAS)
    noise = _jax_draws(key, n, SHAPE)
    calls, stats = [], {}
    out = samplers.sample_loop(name, functools.partial(pden, counter=calls),
                               torch.from_numpy(x0), SIGMAS, noise=noise, stats=stats)
    out64 = samplers.sample_loop(name, pden, torch.from_numpy(x0).double(), SIGMAS,
                                 noise=None if noise is None else noise.double())
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, **TOY_TOL)
    np.testing.assert_allclose(out.numpy(), out64.numpy(), **F64_TOL)
    expected = samplers.denoiser_evaluations(name, SIGMAS)
    assert len(calls) == (stats["evaluations"] if name == "dpm_adaptive" else expected)
    if n:
        with pytest.raises(ValueError, match="per-step draws"):
            samplers.sample_loop(name, pden, torch.from_numpy(x0), SIGMAS)


def test_draw_and_evaluation_counts():
    """The per-step draws and denoiser calls of the DDIM-10 schedule: the
    ancestral samplers one draw a step, dpmpp_2m_sde two, Euler and Heun
    only under churn (JAX's sample_loop runs DPM-2 without it);
    second-order samplers a second call in the 9 steps that do not end at
    sigma = 0; dpm_fast len(schedule)."""
    draws = {name: samplers.n_step_draws(name, SIGMAS) for name in samplers.SAMPLER_NAMES}
    assert draws == {**{n: 0 for n in samplers.SAMPLER_NAMES}, "euler_ancestral": 10,
                     "ancestral": 10, "dpmpp_2s_ancestral": 10, "dpmpp_2m_sde": 20}
    assert samplers.n_step_draws("heun", SIGMAS, s_churn=1.0) == 10
    assert samplers.n_step_draws("dpm", SIGMAS, s_churn=1.0) == 0
    evals = {name: samplers.denoiser_evaluations(name, SIGMAS)
             for name in samplers.SAMPLER_NAMES}
    assert evals == {"ddim": 10, "euler": 10, "euler_ancestral": 10, "heun": 19, "dpm": 19,
                     "ancestral": 19, "dpmpp_2m": 10, "dpmpp_2s": 19,
                     "dpmpp_2s_ancestral": 19, "dpmpp_2m_sde": 19, "dpmpp_2_with_lms": 10,
                     "lms": 10, "dpm_fast": 11, "dpm_adaptive": None}
    with pytest.raises(ValueError, match="Unknown sampler type"):
        samplers.sample_loop("nope", pden, torch.zeros(SHAPE), SIGMAS)
    with pytest.raises(ValueError, match="Unknown sampler type"):
        samplers.n_step_draws("nope", SIGMAS)


@pytest.mark.parametrize("churn", [0.0, 2.0])
@pytest.mark.parametrize("name", ["euler", "heun", "dpm"])
def test_churn_samplers_match_jax(name, churn):
    """Karras churn (s_churn > 0) adds the step's draw scaled by
    sqrt(sigma_hat^2 - sigma^2) (JAX sample_euler/heun); `sample_loop`
    passes no churn to DPM-2, in both packages."""
    key = jax.random.PRNGKey(9)
    x0 = _x0(1)
    ref = np.asarray(jsamplers.sample_loop(name, jden, jnp.asarray(x0), SIGMAS, key=key,
                                           s_churn=churn))
    noise = _jax_draws(key, samplers.n_step_draws(name, SIGMAS, s_churn=churn), SHAPE)
    out = samplers.sample_loop(name, pden, torch.from_numpy(x0), SIGMAS, noise=noise,
                               s_churn=churn)
    np.testing.assert_allclose(out.numpy(), ref, **TOY_TOL)


def _jax_adaptive_calls(x0):
    """JAX dpm_adaptive's denoiser calls, counted at run time inside its
    while_loop: 4 for the half-step that seeds the controller and 4 a step
    (JAX evaluates the shared midpoint twice)."""
    calls = []

    def counted(x, sigma):
        jax.debug.callback(lambda: calls.append(1))
        return jden(x, sigma)
    out = jsamplers.sample_loop("dpm_adaptive", counted, jnp.asarray(x0), SIGMAS,
                                key=jax.random.PRNGKey(0))
    jax.block_until_ready(out)
    return np.asarray(out), len(calls)


def test_dpm_adaptive_takes_jaxs_steps():
    """dpm_adaptive accepts and rejects on the host: the same number of
    steps as JAX's on-device loop, and x at TOY_TOL. Every controller
    factor stays 0.05 or more from the acceptance threshold (0.81), so a
    rounding cannot flip a decision between the packages."""
    x0 = _x0(2)
    ref, jcalls = _jax_adaptive_calls(x0)
    stats = {}
    out = samplers.sample_loop("dpm_adaptive", pden, torch.from_numpy(x0), SIGMAS,
                               stats=stats)
    assert (jcalls - 4) % 4 == 0
    assert stats["steps"] == (jcalls - 4) // 4 and stats["steps"] > 3
    assert min(abs(f - 0.81) for f in stats["factors"]) > 0.05
    # a rejected step reuses its first evaluation: 3 calls seed, 3 a new x, 2 a retry
    assert stats["evaluations"] == 3 + 3 * stats["accepted"] + 2 * (
        stats["steps"] - stats["accepted"]) - (stats["steps"] > 0)
    np.testing.assert_allclose(out.numpy(), ref, **TOY_TOL)


def test_log_likelihood_matches_jax():
    """The probability-flow ODE from sigma_min to sigma_max with the same
    Rademacher draw: the port's Dormand-Prince (JAX odeint's steps) and
    forward-mode product give JAX's log-likelihood within 1e-4 relative
    (the integration tolerances are 1e-4)."""
    x0 = (np.random.default_rng(3).normal(size=SHAPE)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jsamplers.log_likelihood(jden, jnp.asarray(x0), 0.01, 80.0, key=key))
    v = torch.from_numpy(np.array(jax.random.rademacher(key, SHAPE, jnp.float32)))
    out = samplers.log_likelihood(pden, torch.from_numpy(x0), 0.01, 80.0, v=v)
    assert out.shape == (2,) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4)
    with pytest.raises(ValueError, match="Rademacher"):
        samplers.log_likelihood(pden, torch.from_numpy(x0), 0.01, 80.0)


def test_kernel_wrappers_pass_tangents_through_their_plain_version():
    """A kernel's wrapper under a forward-mode product (`torch.func.jvp`,
    as log_likelihood takes it) routes through `PlainBackward`, whose tangent is the plain version's: the
    launch itself never sees a dual tensor. Here the launch is the plain
    version on the CPU, standing in for the kernel."""
    launched = []

    def launch(q, k, v, causal):
        launched.append(torch._C._functorch.is_functorch_wrapped_tensor(q))
        return small_seq_mha_reference(q, k, v, causal)
    gen = torch.Generator().manual_seed(0)
    q, k, v, tq = (torch.randn(2, 3, 5, 8, generator=gen) for _ in range(4))
    wrapped = lambda q: launch_with_plain_backward(launch, small_seq_mha_reference,
                                                   {"causal": True}, q, k, v)
    out, tangent = torch.func.jvp(wrapped, (q,), (tq,))
    ref, ref_tangent = torch.func.jvp(lambda q: small_seq_mha_reference(q, k, v, True),
                                      (q,), (tq,))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(tangent, ref_tangent, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        wrapped(q)
    assert launched == [False, False]


DENSITY_ARGS = {"lognormal": {}, "loglogistic": {}, "loguniform": {}, "uniform": {},
                "v-diffusion": {},
                "split-lognormal": dict(loc=-0.5, scale_1=1.2, scale_2=0.6),
                "discrete": dict(discrete_values=[0.01, 0.3, 2.0, 80.0])}


@pytest.mark.parametrize("kind", sorted(DENSITY_ARGS))
def test_density_matches_jax(kind):
    """Every density of `make_sample_density` (sigma_data 0.5, sigma range
    [0.001, 80]) on the same raw draws as JAX's, patched into its
    `jax.random` calls: rtol 1e-6. `draw_sigma` makes what the density
    takes."""
    rng = np.random.default_rng(4)
    n = rng.normal(size=(64,)).astype(np.float32)
    u = rng.uniform(size=(64,)).astype(np.float32)
    idx = rng.integers(0, 4, size=(64,))
    jfn = jdensities.make_sample_density(kind, 0.5, 0.001, 80.0, **{
        k: (jnp.asarray(v) if k == "discrete_values" else v)
        for k, v in DENSITY_ARGS[kind].items()})
    fixed = lambda a: (lambda key, shape, *args, **kw: jnp.asarray(a))
    with mock.patch.object(jax.random, "normal", fixed(n)), \
            mock.patch.object(jax.random, "uniform", fixed(u)), \
            mock.patch.object(jax.random, "randint", fixed(idx)):
        ref = np.asarray(jfn(jax.random.PRNGKey(0), (64,)))
    draw = {"normal": torch.from_numpy(n), "uniform": torch.from_numpy(u),
            "normal_uniform": torch.stack([torch.from_numpy(n), torch.from_numpy(u)], 1),
            "index": torch.from_numpy(idx)}[densities.DRAW_KINDS[kind]]
    out = densities.make_sample_density(kind, 0.5, 0.001, 80.0, **DENSITY_ARGS[kind])(draw)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    made = densities.draw_sigma(kind, 8, torch.Generator().manual_seed(0), n_values=4)
    assert made.shape[0] == 8 and made.shape == draw[:8].shape and made.dtype == draw.dtype


def test_density_refusals_match_jax():
    """As in JAX: discrete needs its grid, split-lognormal its parameters,
    an unknown name raises."""
    for kind, match in (("discrete", "discrete_values"), ("split-lognormal", "loc"),
                        ("nope", "Unknown")):
        with pytest.raises(ValueError, match=match):
            jdensities.make_sample_density(kind, 0.5, 0.001, 80.0)
        with pytest.raises(ValueError, match=match):
            densities.make_sample_density(kind, 0.5, 0.001, 80.0)


def _replan(sampler_type, seed=2):
    """(JAX chunk, port chunk) of one tiny MDT-V replan (the lang goal)
    with `sampler_type`, from the same frames, goal, initial noise and
    per-step draws (JAX's own)."""
    net, params, port = _agents("float32")
    port.cfg = dataclasses.replace(port.cfg, sampler_type=sampler_type)
    x = _inputs(seed)
    apply = functools.partial(net.apply, {"params": params})
    emb = apply(x["rgb_static"], x["rgb_gripper"], method="compute_voltron_embeddings")
    goal = apply(x["lang_tokens"], method="encode_language_goal")
    key = jax.random.PRNGKey(7)
    chunk = jax.jit(functools.partial(jax_denoise, net, modality="lang",
                                      sampler_type=sampler_type))(params, emb, goal, key)
    k_init, k_samp = jax.random.split(key)
    noise = torch.from_numpy(np.array(jax.random.normal(k_init, (B, 10, 7))))
    steps = _jax_draws(k_samp, samplers.n_step_draws(sampler_type, SIGMAS), (B, 10, 7))
    try:
        with torch.no_grad():
            p_emb = port.compute_voltron_embeddings(torch.from_numpy(x["rgb_static"]),
                                                    torch.from_numpy(x["rgb_gripper"]))
            p_goal = port.encode_language_goal(torch.from_numpy(x["lang_tokens"]))
            p_chunk = denoise_actions(port, p_emb, p_goal, noise=noise, step_noise=steps)
    finally:
        port.cfg = dataclasses.replace(port.cfg, sampler_type="ddim")
    return np.asarray(chunk), p_chunk.numpy()


@pytest.mark.parametrize("name", samplers.SAMPLER_NAMES)
def test_sampler_replan_matches_jax(name):
    """Each sampler through a tiny MDT-V replan (`denoise_actions` against
    the JAX one), at the chunk bound of the DDIM replan."""
    ref, out = _replan(name)
    assert out.shape == ref.shape == (B, 10, 7) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **CHUNK_TOL)


def _jax_policy_draws(seed, n_replans, sampler_type, batch):
    """The JAX policy's draws over `n_replans` replans (mdtv_agent.py:702,
    :535-536; samplers.py:83): the initial noise and the sampler's per-step
    draws of each."""
    rng, out = jax.random.PRNGKey(seed), []
    n = samplers.n_step_draws(sampler_type, SIGMAS)
    for _ in range(n_replans):
        rng, k = jax.random.split(rng)
        k_init, k_samp = jax.random.split(k)
        out.append((torch.from_numpy(np.array(jax.random.normal(k_init, (batch, 10, 7)))),
                    _jax_draws(k_samp, n, (batch, 10, 7))))
    return out


def test_stochastic_sampler_policy_matches_jax_over_three_replans():
    """dpmpp_2m_sde (two correlated draws a step) through both policies'
    `step` for 30 env steps, three replans with other frames, fed the JAX
    policy's own draws: every action at the chunk bound."""
    net, params, port = _agents("float32")
    port.cfg = dataclasses.replace(port.cfg, sampler_type="dpmpp_2m_sde")
    try:
        jpolicy = JaxPolicy(net, params, rng=jax.random.PRNGKey(21),
                            sampler_type="dpmpp_2m_sde")
        draws = iter(_jax_policy_draws(21, 3, "dpmpp_2m_sde", B))
        policy = MDTVPolicy(port, generator=torch.Generator().manual_seed(0))
        current = {}

        def draw_noise(batch):
            current["noise"], current["steps"] = next(draws)
            return current["noise"]
        frames = [_inputs(seed) for seed in (11, 12, 13)]
        with mock.patch.object(policy, "_draw_noise", draw_noise), \
                mock.patch.object(policy, "_draw_steps", lambda batch: (current["steps"],)):
            for t in range(30):
                x = frames[t // 10]
                obs = {k: x[k] for k in ("rgb_static", "rgb_gripper")}
                goal = {"lang_tokens": x["lang_tokens"]}
                ja, pa = jpolicy.step(obs, goal), policy.step(obs, goal)
                np.testing.assert_allclose(pa.numpy(), np.asarray(ja), **CHUNK_TOL)
        with pytest.raises(StopIteration):
            next(draws)  # three replans, three draws
    finally:
        port.cfg = dataclasses.replace(port.cfg, sampler_type="ddim")


def test_policy_dpm_adaptive_runs_eager_and_refuses_a_graph():
    """dpm_adaptive's policy defaults to the eager route (here on the
    CPU, and on the card too) and refuses `cuda_graph=True` with the
    reason."""
    _, _, port = _agents("float32")
    port.cfg = dataclasses.replace(port.cfg, sampler_type="dpm_adaptive")
    try:
        assert MDTVPolicy(port).cuda_graph is False
        with pytest.raises(ValueError, match="dpm_adaptive"):
            MDTVPolicy(port, cuda_graph=True)
        x = _inputs(5)
        a = MDTVPolicy(port, generator=torch.Generator().manual_seed(1)).step(
            {k: x[k] for k in ("rgb_static", "rgb_gripper")},
            {"lang_tokens": x["lang_tokens"]})
        assert a.shape == (B, 7) and torch.isfinite(a).all()
    finally:
        port.cfg = dataclasses.replace(port.cfg, sampler_type="ddim")
