"""Faults planted in the timed path, to show that the comparison fails
them: an answer altered where it is produced (the policy's chunk), a train
step that leaves the state unchanged, and a step that leaves out half of
each scope's rows and takes the mean over the rest. Each is a context
manager that patches the port while it is open."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def altered_answer(delta: float = 0.5):
    """Every chunk the policy plans has one action moved by `delta`."""
    from mdt_policy_tpu_torch.agents import MDTVPolicy
    plan = MDTVPolicy.plan

    def wrong(self, obs, goal):
        out = plan(self, obs, goal).clone()
        out[:, out.shape[1] // 2, 0] += delta
        return out
    MDTVPolicy.plan = wrong
    try:
        yield
    finally:
        MDTVPolicy.plan = plan


@contextlib.contextmanager
def train_fault(kind: str):
    """`unchanged`: the step runs and its state (parameters, EMA, AdamW's
    moments) is put back; `half`: the step sees the first half of each
    scope's rows and draws."""
    import mdt_policy_tpu_torch.agents as agents
    real = agents.train_step

    def unchanged(state, batch, *, draws=None, generator=None):
        keep = {n: p.detach().clone() for n, p in state.net.trainable_parameters()}
        ema = {n: v.clone() for n, v in state.ema.items()}
        m = real(state, batch, draws=draws, generator=generator)
        with torch.no_grad():
            for n, p in state.net.trainable_parameters():
                p.copy_(keep[n])
                for v in state.optimizer.state[p].values():
                    if torch.is_tensor(v) and v.ndim:
                        v.zero_()
            for n, v in state.ema.items():
                v.copy_(ema[n])
        return m

    def half(state, batch, *, draws=None, generator=None):
        rows = {s: b["actions"].shape[0] // 2 for s, b in batch.items()}
        cut = {s: {k: v[:rows[s]] for k, v in b.items()} for s, b in batch.items()}
        d = {s: {k: (v if k == "dropout" else v[:rows[s]]) for k, v in draws[s].items()}
             for s in draws}
        return real(state, cut, draws=d)
    agents.train_step = {"unchanged": unchanged, "half": half}[kind]
    try:
        yield
    finally:
        agents.train_step = real


def planted(kind: str):
    """The fault named `kind`: `answer`, `unchanged` or `half`."""
    return altered_answer() if kind == "answer" else train_fault(kind)
