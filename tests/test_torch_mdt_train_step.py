"""One MDT (ResNet) train step of the PyTorch port against the JAX
package, at a tiny config, and a JAX train state carried into the port by
`state_from_jax` (the validation step is in
tests/test_torch_mdt_validation_step.py).

As in tests/test_torch_train_step.py: the JAX agent from `init_mdt_agent`,
its parameters carried into the port by `from_jax`, the same dual-scope
batch, and the JAX step's `jax.random` draws (the sigma density's uniform,
the action noise, the foresight mask's uniform, the validation's initial
noise) patched to numpy arrays that the port gets as its `draws`. Dropout
is 0 for parity. The bounds are those of the MDT-V step's test.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdt_policy_tpu.agents import MDTConfig as JaxMDTConfig
from mdt_policy_tpu.agents import init_mdt_agent
from mdt_policy_tpu.agents import mdtv_agent as jagent
from mdt_policy_tpu.agents.mdt_agent import MDTAgentNet as JaxMDTAgentNet
from mdt_policy_tpu_torch.agents import MDTAgentNet, MDTConfig, init_train_state, train_step
from mdt_policy_tpu_torch.utils.from_jax import from_jax, state_from_jax
from test_torch_train_step import (DTYPES, LOSSES, _assert_same_update, _batch, _draws,
                                   _patched_jax_random, _port_draws)

TINY = dict(
    latent_dim=32, embed_dim=32, obs_dim=32, goal_dim=16, clip_embed_dim=16,
    n_enc_layers=2, n_dec_layers=2, n_heads=2, img_size=32,
    clip_vision_width=32, clip_vision_layers=1, clip_vision_patch=16,
    clip_text_width=16, clip_text_layers=1, clip_text_heads=2,
    clip_context_length=8, clip_vocab_size=100,
    gen_img_res=32, gen_patch_size=16, gen_decoder_depth=1, gen_decoder_dim=16,
    gen_decoder_heads=2, num_sampling_steps=10,
    attn_pdrop=0.0, resid_pdrop=0.0, mlp_pdrop=0.0)
FROZEN = ("visual_goal", "language_goal")


def _agents(dtypes):
    """The JAX net and state from `init_mdt_agent`, and the port's net with
    the same parameters, a copy of its own for each caller: tests step it in
    place, and the files that import this helper (the validation step's
    among them) may run after them in the same process."""
    net, state0, port = _built_agents(dtypes)
    return net, state0, copy.deepcopy(port)


@functools.cache
def _built_agents(dtypes):
    """`_agents`, built once. The bf16 state is the f32 one with its frozen
    towers cast, which is what `init_mdt_agent` stores for them."""
    if dtypes == "f32":
        net, state0 = init_mdt_agent(JaxMDTConfig(**TINY, **DTYPES[dtypes]),
                                     jax.random.PRNGKey(0), _batch()["lang"])
    else:
        _, f32 = _agents("f32")[:2]
        net = JaxMDTAgentNet(JaxMDTConfig(**TINY, **DTYPES[dtypes]))
        state0 = f32.replace(params={k: jax.tree.map(lambda x: x.astype(jnp.bfloat16), v)
                                     if k in FROZEN else v for k, v in f32.params.items()})
    port = MDTAgentNet(MDTConfig(**TINY, **DTYPES[dtypes]), device="cpu")
    port.load_state_dict(from_jax(jax.device_get(state0.params)), strict=True)
    return net, state0, port


@functools.cache
def _jax_steps(dtypes):
    """The JAX states after 0, 1, ... train steps from `_agents` (three in
    f32, one in bf16), each on the same batch and draws (the patched draws
    are constants of the one traced program), and each step's metrics."""
    net, state0, _ = _agents(dtypes)
    patches, queues = _patched_jax_random(_draws(), ("sigma", "noise", "mask"))
    step = jax.jit(functools.partial(jagent.train_step, net))
    states, metrics = [state0], []
    with patches[0], patches[1]:
        for _ in range(3 if dtypes == "f32" else 1):
            state, m = step(states[-1], _batch(), jax.random.PRNGKey(3))
            states.append(state)
            metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    assert not any(queues.values())  # every draw was taken
    return states, metrics


def _jax_grads(net, states, i):
    """The gradient of JAX step i (1-based) from optax's first moment:
    mu_i = b1 * mu_{i-1} + (1 - b1) * g_i."""
    b1 = net.cfg.optimizer.betas[0]
    mu = [next(s.mu for s in st.opt_state if hasattr(s, "mu")) for st in states[i - 1:i + 1]]
    return from_jax(jax.device_get(jax.tree.map(lambda m1, m0: (m1 - b1 * m0) / (1 - b1),
                                                mu[1], mu[0])))


@functools.cache
def _steps(dtypes):
    """(JAX, port) after one train step from the same state, batch and
    draws: metrics, gradients, parameters, EMA."""
    net, _, port = _agents(dtypes)
    states, metrics = _jax_steps(dtypes)
    jgrads = _jax_grads(net, states, 1)
    jparams = from_jax(jax.device_get(states[1].params))
    jema = from_jax(jax.device_get(states[1].ema_params))

    state = init_train_state(port)
    pm = {k: float(v) for k, v in train_step(state, _batch(),
                                             draws=_port_draws(_draws())).items()}
    pgrads = {n: p.grad.clone() for n, p in port.trainable_parameters()}
    pparams = {k: v.float().clone() for k, v in port.state_dict().items()}
    pema = {k: v.clone() for k, v in state.ema.items()}
    return (metrics[0], jgrads, jparams, jema), (pm, pgrads, pparams, pema)


@pytest.mark.parametrize("key", LOSSES)
def test_mdt_train_step_losses_match_jax(key):
    """Each loss of each scope on its own, so that a swap of `goal_emb` and
    `lang_emb` in the contrastive path cannot hide inside the total."""
    (jm, *_), (pm, *_) = _steps("f32")
    assert pm["vis/cont_loss"] == 0.0 and pm["lang/cont_loss"] > 0.0
    np.testing.assert_allclose(pm[key], jm[key], rtol=1e-4, err_msg=key)


def test_mdt_optimizer_holds_both_resnets_and_logit_scale():
    """The trainables are every parameter outside the CLIP towers: both
    ResNets (which MDT-V would freeze) and `logit_scale` are in the one
    AdamW group, no frozen tower is; JAX's gradient tree has the same
    leaves."""
    net, _, port = _agents("f32")
    names = [n for n, _ in port.trainable_parameters()]
    state = init_train_state(port)
    group = {id(p) for p in state.optimizer.param_groups[0]["params"]}
    assert len(state.optimizer.param_groups) == 1
    assert group == {id(p) for _, p in port.trainable_parameters()}
    for prefix in ("static_resnet", "gripper_resnet", "inner", "gen_img"):
        assert any(n.startswith(prefix + ".") for n in names), prefix
    assert "logit_scale" in names
    assert not any(n.startswith(FROZEN) for n in names)
    assert sorted(names) == sorted(_steps("f32")[0][1])
    assert net.frozen_prefixes == port.frozen_prefixes == FROZEN


def _grad_atol(g) -> float:
    """The gradient bound's absolute term of a leaf: max(1e-6, 1e-5 * max|g|)
    (see the gradient test)."""
    return max(1e-6, 1e-5 * float(np.abs(np.asarray(g)).max()))


def _update_floor(g) -> float:
    """|g| above which `_assert_same_update` holds the port's AdamW update to
    JAX's at 1e-3: four times the leaf's gradient bound d. A gradient off
    by d moves Adam's first step lr * g / (|g| + eps) by about eps * d / g^2
    of itself, under 1e-8 / (16 d) <= 6.3e-4 there; below it the updates
    are held within 2 * lr."""
    return 4 * _grad_atol(g)


def test_mdt_train_step_gradients_match_jax():
    """f32 gradients of every trainable leaf, the ResNets' among them:
    rtol 1e-3 and atol max(1e-6, 1e-5 * max|g| of the leaf). The MDT-V
    step's atol, 1e-6, is a fixed rounding floor for leaves whose
    gradients stay under ~0.1; the token projections after the ResNets
    carry gradients up to ~0.9 here (`inner.tok_emb.weight`), and both
    packages round those to ~2e-6 of the leaf's largest element (the
    ResNet features of either package are 1e-6 relative off float64), so
    an element that is a cancellation of such terms needs the floor
    scaled with the leaf."""
    (_, jgrads, _, _), (_, pgrads, _, _) = _steps("f32")
    assert sorted(jgrads) == sorted(pgrads)
    assert any(k.startswith("static_resnet.backbone.0") for k in pgrads)
    for k in jgrads:
        np.testing.assert_allclose(pgrads[k].numpy(), jgrads[k].numpy(), rtol=1e-3,
                                   atol=_grad_atol(jgrads[k]), err_msg=k)


def test_mdt_train_step_params_ema_and_metrics_match_jax():
    """The AdamW update of every trainable leaf and its EMA against JAX's
    (`_assert_same_update`); the frozen towers do not move; grad and param
    norms, lr and EMA rate."""
    (jm, jgrads, jparams, jema), (pm, _, pparams, pema) = _steps("f32")
    _, state0, _ = _agents("f32")
    before = from_jax(jax.device_get(state0.params))
    assert sorted(jparams) == sorted(pparams)
    checked = 0
    for k in jparams:
        if k.startswith(FROZEN):
            assert k not in jgrads
            torch.testing.assert_close(pparams[k], before[k], rtol=0, atol=0)
            continue
        floor = _update_floor(jgrads[k])
        checked += _assert_same_update(k, pparams[k], jparams[k], before[k], jgrads[k],
                                       1e-5, floor)
        _assert_same_update(k, pema[k], jema[k], before[k], jgrads[k], 1e-5, floor)
        torch.testing.assert_close(pema[k], pparams[k], rtol=1e-6, atol=1e-12)
    assert checked > 0.5 * sum(v.numel() for v in jgrads.values())
    for k in ("train/grad_norm", "train/param_norm"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(pm["train/lr"], jm["train/lr"], rtol=1e-6)
    assert pm["train/ema_rate"] == jm["train/ema_rate"] == 0.0


def test_state_from_jax_takes_the_third_jax_step():
    """Two JAX steps, the state carried into the port by `state_from_jax`,
    then a third step on each side. The carried moments equal optax's
    exactly, with the count as torch's host `step`. After the step: the
    losses and norms at 1e-4, the lr and EMA rate (the step) at 1e-6, the
    new moments at 1e-3 plus what the leaf's gradient bound d moves them by
    ((1 - b1) d, and (1 - b2) 2 max|g| d), the EMA at 1e-4, and every
    parameter within 1e-2 * lr plus two ulps of JAX's. A third update
    lr * m / (sqrt(v) + eps) sums three gradients that can cancel, so it
    is held absolutely: a count off by one (Adam's bias correction) moves
    the updates of size lr by ~20 % of lr, wrong moments by all of it."""
    net, _, port = _agents("f32")
    states, metrics = _jax_steps("f32")
    tree = jax.device_get({"params": states[2].params, "ema_params": states[2].ema_params,
                           "opt_state": states[2].opt_state, "step": states[2].step})
    state = state_from_jax(port, tree)
    assert state.step == 2
    mu = from_jax(next(s.mu for s in tree["opt_state"] if hasattr(s, "mu")))
    for name, p in port.trainable_parameters():
        s = state.optimizer.state[p]
        assert float(s["step"]) == 2.0 and s["step"].device.type == "cpu"
        torch.testing.assert_close(s["exp_avg"], mu[name], rtol=0, atol=0)
    pm = train_step(state, _batch(), draws=_port_draws(_draws()))
    pm = {k: float(v) for k, v in pm.items()}
    jm = metrics[2]
    adam = next(s for s in jax.device_get(states[3].opt_state) if hasattr(s, "mu"))
    jmu, jnu = from_jax(adam.mu), from_jax(adam.nu)
    jgrads = _jax_grads(net, states, 3)
    jparams = from_jax(jax.device_get(states[3].params))
    jema = from_jax(jax.device_get(states[3].ema_params))
    b1, b2 = net.cfg.optimizer.betas
    lr = jm["train/lr"]
    for name, p in port.trainable_parameters():
        s, d = state.optimizer.state[p], _grad_atol(jgrads[name])
        assert float(s["step"]) == 3.0
        np.testing.assert_allclose(s["exp_avg"].numpy(), jmu[name].numpy(), rtol=1e-3,
                                   atol=(1 - b1) * d, err_msg=name)
        np.testing.assert_allclose(s["exp_avg_sq"].numpy(), jnu[name].numpy(), rtol=1e-3,
                                   atol=(1 - b2) * 2 * float(jgrads[name].abs().max()) * d,
                                   err_msg=name)
        new, want = p.detach().numpy(), jparams[name].numpy()
        excess = np.abs(new - want) - (1e-2 * lr + 2 * np.spacing(np.abs(want)))
        assert excess.max() <= 0, (name, float(np.abs(new - want).max()))
        np.testing.assert_allclose(state.ema[name].numpy(), jema[name].numpy(),
                                   rtol=1e-4, atol=1e-2 * lr, err_msg=name)
    for k in LOSSES + ["train/grad_norm", "train/param_norm"]:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=k)
    for k in ("train/lr", "train/ema_rate"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-6, err_msg=k)
    assert pm["train/ema_rate"] > 0.0 and state.step == 3
