"""Every MDT-V config value of the denoiser and its training draws that the
port once refused, against the JAX package at a tiny config: the
sigma-token encoder (`use_ada_conditioning=False`), the noise-encoder
decoder, no `lang_emb`, linear goal projections, the bf16 denoiser,
`embed_pdrob`, `goal_drop`, `freeze_img_encoder=False` and the log-normal
sigma density. For each: the JAX tree carried across by `from_jax`, a
replan chunk in both modalities, and one train step (losses, gradients,
the AdamW update and the EMA, as tests/test_torch_train_step.py holds the
production step). This file runs the sigma-token and noise-encoder
configs; tests/test_torch_denoiser_goal_configs.py the goal projections,
tests/test_torch_denoiser_options.py and
tests/test_torch_denoiser_draw_options.py the values that keep
production's parameter tree, through the same checks.

Every case starts from the production JAX state; a case whose tree
differs gets the part it changes (the denoiser, or the goal image tower)
initialized by its own JAX net through the method that reaches it, and a
fresh optimizer state, as `init_agent` makes one.

The JAX step's draws are patched to numpy arrays that the port gets as its
`draws`: the density's draw (normal for the log-normal, else uniform), the
action noise, the foresight mask, and `jax.random.bernoulli`, which serves
both `goal_drop`'s masks (p = goal_drop) and flax's dropout (p = the keep
probability). The port's `embed_pdrob` dropout is patched to record its
keep masks, which JAX then takes in the same order.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdt_policy_tpu.agents import MDTConfig as JaxMDTConfig
from mdt_policy_tpu.agents import MDTVConfig as JaxConfig
from mdt_policy_tpu.agents import init_agent, init_mdt_agent
from mdt_policy_tpu.agents import mdtv_agent as jagent
from mdt_policy_tpu.agents.mdt_agent import MDTAgentNet as JaxMDTAgentNet
from mdt_policy_tpu.agents.mdt_agent import make_optimizer as jmdt_make_optimizer
from mdt_policy_tpu_torch.agents import (MDTAgentNet, MDTConfig, MDTVAgentNet, MDTVConfig,
                                         denoise_actions, init_train_state, train_step)
from mdt_policy_tpu_torch.diffusion.densities import DRAW_KINDS
from mdt_policy_tpu_torch.models import mdt_transformer, mdtv_transformer
from mdt_policy_tpu_torch.utils.from_jax import from_jax
from test_torch_mdt_train_step import TINY as MDT_TINY
from test_torch_mdt_train_step import _grad_atol, _update_floor
from test_torch_train_step import B, DTYPES, LOSSES, TINY, _assert_same_update, _batch

CASES = {
    "sigma_token": dict(use_ada_conditioning=False),
    "noise_encoder": dict(use_noise_encoder=True),
    "no_modality_encoder": dict(use_modality_encoder=False),
    "linear_goal": dict(use_mlp_goal=False),
    "bf16_denoiser": dict(denoiser_compute_dtype="bfloat16"),
    "embed_pdrob": dict(embed_pdrob=0.1),
    "goal_drop": dict(goal_drop=0.1),
    "trainable_img_encoder": dict(freeze_img_encoder=False),
    "lognormal": dict(sigma_sample_density_type="lognormal"),
    # CLIP's RN50 layout at a tiny size (tests/test_torch_clip_resnet.py)
    "resnet_goal": dict(clip_vision_family="resnet", clip_rn_layers=(1, 1, 1, 1),
                        clip_rn_width=8),
    # production, the reference of the bf16 denoiser's bounds
    "f32_denoiser": {},
}
# cases whose parameter tree differs from the production config's
STRUCTURAL = ("sigma_token", "noise_encoder", "no_modality_encoder", "linear_goal")
OWN_INIT = STRUCTURAL + ("resnet_goal",)
# (JAX config, port config, JAX init, JAX net, port net, tiny overrides)
FAMILIES = {"mdtv": (JaxConfig, MDTVConfig, init_agent, jagent.MDTVAgentNet, MDTVAgentNet,
                     TINY),
            "mdt": (JaxMDTConfig, MDTConfig, init_mdt_agent, JaxMDTAgentNet, MDTAgentNet,
                    MDT_TINY)}
# the whole tiny replan's bound (tests/test_torch_slice.py, F32_TOL["chunk"])
CHUNK_TOL = dict(rtol=1e-3, atol=1e-3)
# The bf16 denoiser: JAX's `sdpa` rounds the scores to bf16 before its f32
# softmax, B2 pre-scales q in bf16 and keeps the scores in f32, and both
# round every block GEMM's output to bf16 (3.9e-3 relative). So the port's
# bf16 chunk is held against JAX's f32 chunk no further than 1.5x JAX's own
# bf16 chunk is from it, and against JAX's bf16 chunk within BF16_CHUNK_ATOL
# (chunks of order 1). Its train step: the losses and norms at the bf16
# bound of tests/test_torch_train_step.py; over all trainable leaves
# together, the gradients, the AdamW updates (p1 - p0) and the EMA's no
# further from JAX's f32 step than BF16_RATIO x JAX's bf16 step is from it
# (L2 norms, the chunk's rule); leaf by leaf, the gradients within
# BF16_LEAF_NOISE x JAX's own bf16 rounding of the leaf (max |g_bf16 -
# g_f32| of JAX's steps) of JAX's bf16 ones, as two independent roundings
# of that size differ by up to twice it and a leaf's largest element by
# up to twice more, and the updates and the EMA held to JAX's bf16 ones by
# `_assert_same_update` above four times that bound (MDT's
# `_update_floor` rule).
BF16_RATIO = 1.5
BF16_CHUNK_ATOL = 5e-2
BF16_LOSS_RTOL = 2e-2
BF16_LEAF_NOISE = 4


@functools.cache
def _base(family):
    jcfg, _, init, _, _, tiny = FAMILIES[family]
    return init(jcfg(**tiny, **DTYPES["f32"]), jax.random.PRNGKey(0), _batch()["lang"])


def _new_part(net, family):
    """(name, params) of the part a structural case changes, initialized by
    the case's net through the one method that reaches it (the denoiser,
    or the goal image tower), without compiling the whole agent's init."""
    rng = np.random.default_rng(9)
    if net.cfg.clip_vision_family == "resnet":
        image = _batch()["lang"]["rgb_static"][:, -1]
        return "visual_goal", net.init(jax.random.PRNGKey(1), image,
                                       method="encode_visual_goal")["params"]["visual_goal"]
    shapes = {"state_images": (B, 3, 32)} if family == "mdtv" else \
        {"static": (B, 1, 32), "gripper": (B, 1, 32)}
    emb = {k: jnp.asarray(rng.normal(size=v), jnp.float32) for k, v in shapes.items()}
    sigma = jnp.ones((B,), jnp.float32)

    def denoise(m, emb, goal, sigma, actions):
        ctx = m.encode_context(emb, goal, sigma, modality="lang")
        return m.decode_actions(ctx, actions, sigma)
    params = net.init(jax.random.PRNGKey(1), emb, jnp.zeros((B, 1, 16)), sigma,
                      jnp.zeros((B, 10, 7)), method=denoise)["params"]
    return "inner", params["inner"]


@functools.cache
def _agents(case, family="mdtv"):
    """The JAX net and state of `case` (production's state under the case's
    config, with the part a structural case changes initialized anew, and
    a fresh optimizer state as `init_agent` makes it) and the port net with
    the same parameters."""
    jcfg, pcfg, init, jnet, pnet, tiny = FAMILIES[family]
    over = {**tiny, **DTYPES["f32"], **CASES[case]}
    net, state = jnet(jcfg(**over)), _base(family)[1]
    if case in OWN_INIT:
        name, part = _new_part(net, family)
        params = {**state.params, name: part}
        tx = (jagent.make_optimizer if family == "mdtv" else jmdt_make_optimizer)(net.cfg)
        trainable, _ = jagent.split_params(params, net.frozen_prefixes)
        state = jagent.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  opt_state=tx.init(trainable),
                                  ema_params=jax.tree.map(jnp.copy, params), tx=tx)
    port = pnet(pcfg(**over), device="cpu")
    port.load_state_dict(from_jax(jax.device_get(state.params)), strict=True)
    return net, state, port


def _draws(cfg, seed=1):
    """numpy draws per scope: the density's (B,), noise (B, 10, 7), mask
    (B, 4), and with goal_drop the goal masks (B, 2, 1, goal_dim)."""
    rng = np.random.default_rng(seed)
    out = {}
    for s in ("lang", "vis"):
        normal = DRAW_KINDS[cfg.sigma_sample_density_type] == "normal"
        d = {"sigma": (rng.normal(size=(B,)) if normal else rng.uniform(size=(B,))
                       ).astype(np.float32),
             "noise": rng.normal(size=(B, 10, 7)).astype(np.float32),
             "mask": rng.uniform(size=(B, 4)).astype(np.float32)}
        if cfg.goal_drop > 0:
            d["goal_mask"] = rng.uniform(size=(B, 2, 1, cfg.goal_dim)) < cfg.goal_drop
        out[s] = d
    return out


class _DropoutTape:
    """Records the keep masks of the port's embedding dropout (patched into
    the transformer modules) for JAX's flax dropout to replay."""

    def __init__(self, seed=8):
        self.rng, self.masks = np.random.default_rng(seed), []

    def __call__(self, x, p, generator):
        if generator is None or p == 0.0:
            return x
        keep = self.rng.uniform(size=tuple(x.shape)) < 1.0 - p
        self.masks.append((round(1.0 - p, 6), keep))
        return torch.where(torch.from_numpy(keep), x / (1.0 - p),
                           torch.zeros((), dtype=x.dtype))

    def patches(self):
        return [mock.patch.object(m, "dropout", self) for m in (mdtv_transformer,
                                                                 mdt_transformer)]


def _jax_patches(cfg, draws, tape):
    """jax.random.uniform / normal / bernoulli handing out the draws of the
    sorted scopes, by kind and shape, in the order JAX takes them."""
    queues = {}
    kind = "normal" if DRAW_KINDS[cfg.sigma_sample_density_type] == "normal" else "uniform"
    for scope in sorted(draws):
        d = draws[scope]
        for name, k in (("sigma", kind), ("noise", "normal"), ("mask", "uniform")):
            queues.setdefault((k, d[name].shape), []).append(d[name])
        if "goal_mask" in d:
            n = 2 if scope == "lang" else 1  # the contrastive encode's second mask
            for i in range(n):
                queues.setdefault(("bernoulli", round(cfg.goal_drop, 6),
                                   d["goal_mask"][:, i].shape), []).append(
                    d["goal_mask"][:, i])
    for p, keep in tape.masks:
        queues.setdefault(("bernoulli", p, keep.shape), []).append(keep)

    def fake(kind):
        def draw(key, shape=(), dtype=jnp.float32, *args, **kw):
            return jnp.asarray(queues[(kind, tuple(shape))].pop(0), dtype)
        return draw

    def bernoulli(key, p=0.5, shape=None, *args, **kw):
        return jnp.asarray(queues[("bernoulli", round(float(p), 6), tuple(shape))].pop(0))
    patches = [mock.patch.object(jax.random, "uniform", fake("uniform")),
               mock.patch.object(jax.random, "normal", fake("normal")),
               mock.patch.object(jax.random, "bernoulli", bernoulli)]
    return patches, queues


def _port_draws(draws):
    return {s: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
            for s, d in draws.items()}


def _jax_step(case, family, draws, tape):
    """JAX's metrics, gradients (AdamW's first moment over 1 - beta1),
    parameters and EMA after one train step of `case` from its state on
    `_batch()` and `draws`, its embedding dropout replaying `tape`."""
    net, state0, port = _agents(case, family)
    patches, queues = _jax_patches(port.cfg, draws, tape)
    with patches[0], patches[1], patches[2]:
        state1, jm = jax.jit(functools.partial(jagent.train_step, net))(
            state0, _batch(), jax.random.PRNGKey(3))
    assert not any(queues.values())  # every draw was taken
    jm = {k: float(v) for k, v in jax.device_get(jm).items()}
    b1 = net.cfg.optimizer.betas[0]
    mu = next(s.mu for s in state1.opt_state if hasattr(s, "mu"))
    jgrads = from_jax(jax.device_get(jax.tree.map(lambda m: m / (1 - b1), mu)))
    return (jm, jgrads, from_jax(jax.device_get(state1.params)),
            from_jax(jax.device_get(state1.ema_params)))


@functools.cache
def _steps(case, family="mdtv"):
    """(JAX, port) after one train step from the same state, batch and
    draws: metrics, gradients, parameters, EMA."""
    net, state0, port = _agents(case, family)
    batch, draws = _batch(), _draws(port.cfg)
    tape = _DropoutTape()
    state = init_train_state(port)
    pdraws = _port_draws(draws)
    for d in pdraws.values():
        d["dropout"] = torch.Generator().manual_seed(0)
    with tape.patches()[0], tape.patches()[1]:
        pm = train_step(state, batch, draws=pdraws)
    pm = {k: float(v) for k, v in pm.items()}
    pgrads = {n: p.grad.clone() for n, p in port.trainable_parameters()}
    pparams = {k: v.float().clone() for k, v in port.state_dict().items()}
    pema = {k: v.clone() for k, v in state.ema.items()}
    port.load_state_dict(from_jax(jax.device_get(state0.params)), strict=True)
    return _jax_step(case, family, draws, tape), (pm, pgrads, pparams, pema), len(tape.masks)


@functools.cache
def _f32_step(family):
    """JAX's step of production's f32 denoiser from the bf16 denoiser's
    state, batch and draws: the reference of the bf16 bounds."""
    cfg = _agents("bf16_denoiser", family)[2].cfg
    return _jax_step("f32_denoiser", family, _draws(cfg), _DropoutTape())


def check_round_trip(case, family="mdtv"):
    """The JAX tree of the config loads into the port strictly: one tensor
    per JAX leaf, the same numbers of elements, every key of the port's
    state_dict; the frozen towers take no gradient."""
    net, state, port = _agents(case, family)
    params = jax.device_get(state.params)
    sd = from_jax(params)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(sd) == len(leaves) == len(port.state_dict())
    assert sum(v.numel() for v in sd.values()) == sum(np.size(v) for _, v in leaves)
    assert set(sd) == set(port.state_dict())
    trainable = {n.split(".")[0] for n, _ in port.trainable_parameters()}
    assert not trainable & set(port.frozen_prefixes)
    if case == "no_modality_encoder":
        assert not any(k.startswith("inner.lang_emb") for k in sd)
    if case == "linear_goal":
        assert "inner.goal_emb.weight" in sd and "inner.lang_emb.weight" in sd
    if case == "sigma_token":
        assert "inner.decoder.blocks.0.cross_att.query.weight" in sd
        assert not any("adaLN" in k for k in sd)
    if case == "noise_encoder":
        assert "inner.decoder.blocks.0.ln3.weight" in sd
        assert not any("adaLN" in k for k in sd)


def _chunks(case, modality, family="mdtv", seed=2):
    """(JAX chunk, port chunk) from the same perception (MDT-V's latents,
    MDT's camera tokens), goal and initial noise (JAX's own draw), through
    each package's denoise_actions."""
    net, state, port = _agents(case, family)
    rng = np.random.default_rng(seed)
    shapes = {"state_images": (B, 3, 32)} if family == "mdtv" else \
        {"static": (B, 1, 32), "gripper": (B, 1, 32)}
    emb = {k: rng.normal(size=v).astype(np.float32) for k, v in shapes.items()}
    goal = rng.normal(size=(B, 16)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    chunk = jax.jit(functools.partial(jagent.denoise_actions, net, modality=modality))(
        state.params, {k: jnp.asarray(v) for k, v in emb.items()}, jnp.asarray(goal), key)
    noise = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[0],
                                                         (B, 10, 7))))
    out = denoise_actions(port, {k: torch.from_numpy(v) for k, v in emb.items()},
                          torch.from_numpy(goal), noise=noise, modality=modality)
    return np.asarray(chunk), out.numpy()


# the cases whose goal projection differs between the lang and the vis
# modality (MDT-V's `lang_emb` and `goal_emb`); the others, and MDT, whose
# replan embeds every goal with `goal_emb`, are checked in the lang modality
BOTH_MODALITIES = ("linear_goal", "no_modality_encoder")


def check_replan(case, family="mdtv"):
    """A replan chunk of the config from the same perception, goal and
    noise at the chunk bound, in the lang modality and, where the goal
    projections differ, the vis one; the bf16 denoiser at its stated
    bounds."""
    both = family == "mdtv" and case in BOTH_MODALITIES
    for modality in ("lang", "vis") if both else ("lang",):
        ref, out = _chunks(case, modality, family)
        assert out.shape == (B, 10, 7) and np.isfinite(out).all()
        if case != "bf16_denoiser":
            np.testing.assert_allclose(out, ref, **CHUNK_TOL)
            continue
        # production's f32 denoiser, the same parameters
        f32_ref, _ = _chunks("embed_pdrob", modality, family)
        port_err = np.abs(out - f32_ref).max()
        jax_err = np.abs(ref - f32_ref).max()
        # shown with `pytest -s`; PERF.md quotes them
        print(f"{family} bf16 denoiser, {modality}: |port bf16 - jax f32| = {port_err:.3g}, "
              f"|jax bf16 - jax f32| = {jax_err:.3g}, "
              f"|port bf16 - jax bf16| = {np.abs(out - ref).max():.3g}")
        assert port_err <= BF16_RATIO * jax_err
        np.testing.assert_allclose(out, ref, rtol=0, atol=BF16_CHUNK_ATOL)


def _check_bf16_train_step(family, jax_step, port_step):
    """The bf16 denoiser's step against JAX's bf16 and f32 steps at the
    bounds stated with BF16_RATIO and BF16_LEAF_NOISE."""
    (jm, jgrads, jparams, jema), (pm, pgrads, pparams, pema) = jax_step, port_step
    _, fgrads, fparams, fema = _f32_step(family)
    for k in LOSSES + ["train/grad_norm", "train/param_norm"]:
        assert np.isfinite(pm[k]), k
        np.testing.assert_allclose(pm[k], jm[k], rtol=BF16_LOSS_RTOL, err_msg=k)
    net, state0, port = _agents("bf16_denoiser", family)
    before = from_jax(jax.device_get(state0.params))
    dist = lambda a, b: float(np.sqrt(sum(float(((a[k] - b[k]).double() ** 2).sum())
                                          for k in jgrads)))
    moved = lambda t: {k: t[k] - before[k] for k in jgrads}
    for what, port_t, jax_t, f32_t in (
            ("gradients", pgrads, jgrads, fgrads),
            ("updates", moved(pparams), moved(jparams), moved(fparams)),
            ("EMA", moved(pema), moved(jema), moved(fema))):
        port_err, jax_err = dist(port_t, f32_t), dist(jax_t, f32_t)
        # shown with `pytest -s`; PERF.md quotes them
        print(f"{family} bf16 denoiser step, {what}: |port bf16 - jax f32| = {port_err:.4g}, "
              f"|jax bf16 - jax f32| = {jax_err:.4g}")
        assert port_err <= BF16_RATIO * jax_err, what
    for k in jgrads:
        bound = BF16_LEAF_NOISE * float((jgrads[k] - fgrads[k]).abs().max())
        np.testing.assert_allclose(pgrads[k].numpy(), jgrads[k].numpy(), rtol=0,
                                   atol=bound, err_msg=k)
        for new, ref in ((pparams[k], jparams[k]), (pema[k], jema[k])):
            _assert_same_update(k, new, ref, before[k], jgrads[k], 1e-5,
                                floor=max(1e-6, 4 * bound))
    for k in jparams:
        if k.startswith(port.frozen_prefixes):
            torch.testing.assert_close(pparams[k], before[k], rtol=0, atol=0)


def check_train_step(case, family="mdtv"):
    """One train step of the config from the same state, batch and draws:
    the 9 losses at 1e-4 relative, every trainable gradient at 1e-3
    relative (atol 1e-6; MDT's per-leaf floor), the AdamW update and the
    EMA as in tests/test_torch_train_step.py and
    tests/test_torch_mdt_train_step.py; the frozen towers do not move. The
    bf16 denoiser: the losses, the gradients, the updates and the EMA at
    its bf16 bounds (`_check_bf16_train_step`)."""
    jax_step, port_step, n_masks = _steps(case, family)
    (jm, jgrads, jparams, jema), (pm, pgrads, pparams, pema) = jax_step, port_step
    assert sorted(jgrads) == sorted(pgrads)
    assert pm["vis/cont_loss"] == 0.0 and pm["lang/cont_loss"] > 0.0
    if case == "embed_pdrob":
        # MDT-V: the action embedding's dropout, one a scope; MDT also the
        # goal and state tokens' at each encode, two in the lang scope
        assert n_masks == (2 if family == "mdtv" else 8)
    if case == "bf16_denoiser":
        _check_bf16_train_step(family, jax_step, port_step)
        return
    for k in LOSSES + ["train/grad_norm", "train/param_norm"]:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=k)
    # MDT's gradient floor scales with the leaf (tests/test_torch_mdt_train_step.py)
    atol = (lambda g: 1e-6) if family == "mdtv" else _grad_atol
    floor = (lambda g: 1e-6) if family == "mdtv" else _update_floor
    for k in jgrads:
        np.testing.assert_allclose(pgrads[k].numpy(), jgrads[k].numpy(), rtol=1e-3,
                                   atol=atol(jgrads[k]), err_msg=k)
    net, state0, port = _agents(case, family)
    before = from_jax(jax.device_get(state0.params))
    for k in jparams:
        if k.startswith(port.frozen_prefixes):
            torch.testing.assert_close(pparams[k], before[k], rtol=0, atol=0)
            continue
        for new, ref in ((pparams[k], jparams[k]), (pema[k], jema[k])):
            _assert_same_update(k, new, ref, before[k], jgrads[k], 1e-5,
                                floor=floor(jgrads[k]))


# this file's cases; the goal-projection ones run in
# tests/test_torch_denoiser_goal_configs.py
SIGMA_CASES = ("sigma_token", "noise_encoder")


@pytest.mark.parametrize("case", SIGMA_CASES)
def test_config_from_jax_round_trip(case):
    check_round_trip(case)


@pytest.mark.parametrize("case", SIGMA_CASES)
def test_config_replan_matches_jax(case):
    check_replan(case)


@pytest.mark.parametrize("case", SIGMA_CASES)
def test_config_train_step_matches_jax(case):
    check_train_step(case)


def test_sigma_token_encodes_at_every_denoiser_call():
    """The sigma-token and noise-encoder configs encode the context at
    each of DDIM-10's 10 denoiser calls (JAX `hoist_context`), the
    production config once; the chunk depends on sigma through the
    encoder."""
    counts = {}
    for case in ("sigma_token", "noise_encoder", "lognormal"):
        _, _, port = _agents(case)
        with mock.patch.object(port.inner, "encode", wraps=port.inner.encode) as enc:
            denoise_actions(port, {"state_images": torch.zeros(B, 3, 32)},
                            torch.zeros(B, 16), noise=torch.zeros(B, 10, 7))
        counts[case] = enc.call_count
    assert counts == {"sigma_token": 10, "noise_encoder": 10, "lognormal": 1}
