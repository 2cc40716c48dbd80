"""Traffic kind `replan`: one robot in a closed loop, the way CALVIN's
rollout calls a policy.

Every env step calls the port's `make_rollout_policy(net)` once with a
fresh raw frame pair (uint8, `static_hw` and `gripper_hw` pixels, drawn
from the seed into a pool of `frame_pool` pairs that the steps walk
through) and the current goal; the policy replans every `multistep`
steps and replays its chunk in between. The goal is one of the traffic's
instructions (the token ids stored beside its sentence); it changes every
`goal_every_replans` replans to another instruction drawn from the seed.

Timing: the host clock from the call to the action on the host, for the
steps that replan; `replan_p50_ms` and `replan_p95_ms` are over all the
window's replans. Correctness: a sample of the window's replans, drawn
from the seed with the slowest among them, each one's 10 served actions
against the reference's chunk from the same raw frames, instruction and
initial noise (the noise is the policy generator's draw, which the
harness seeds at the window's start and replays).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from port_bench.harness import agent as A
from port_bench.harness import trace as T
from port_bench.harness.serving import (chunk_gap, frame_pool, goal_schedule, noise_draws,
                                        goal_tokens, reference_chunks)


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        self.doc, self.traffic = ctx.config, ctx.traffic
        self.seed, self.device = ctx.seed, ctx.device

    # ---- set-up ------------------------------------------------------------------

    def setup(self):
        from mdt_policy_tpu_torch.evaluation.policy_adapter import make_rollout_policy
        t = self.traffic
        self.cfg = self.ctx.agent_cfg or A.agent_config(self.doc)
        self.net, self.spec = A.build(self.doc, self.seed, self.device, self.cfg)
        self.tokens = goal_tokens(t, self.ctx.home, self.cfg.clip_context_length)
        self.pool = frame_pool(t, self.seed, self.device, t["frame_pool"])
        self.gen = torch.Generator(self.device).manual_seed(0)
        self.policy = make_rollout_policy(self.net, generator=self.gen)
        self.multistep = self.cfg.multistep
        # warm-up: captures the replan's graph and runs the text tower
        warm = goal_schedule(len(self.tokens), A.sub_seed(self.seed, "warm"), 64)
        self._loop(t["warmup_replans"], warm, record=False)

    def _obs(self, k: int):
        i = k % len(self.pool[0])
        return {"rgb_obs": {"rgb_static": self.pool[0][i][None, None],
                            "rgb_gripper": self.pool[1][i][None, None]}}

    def _loop(self, seconds_or_replans, goals, record: bool, rec=T.NO_SPANS):
        """Env steps from a replan boundary: for `seconds` of host time
        (record) or for a number of replans (warm-up)."""
        every = self.traffic["goal_every_replans"]
        lat, switch, acts = [], [], []
        k, prev = 0, None
        t_start = time.perf_counter()
        while True:
            r, j = divmod(k, self.multistep)
            if j == 0:
                if record and time.perf_counter() - t_start >= seconds_or_replans:
                    break
                if not record and r >= seconds_or_replans:
                    break
            g = int(goals[r // every])
            goal = {"lang_tokens": self.tokens[g][None]}
            name = "pb.step" if j else ("pb.replan_switch" if g != prev else "pb.replan_plain")
            with rec.span(name):
                t0 = time.perf_counter()
                a = self.policy.step(self._obs(k), goal)
                dt = time.perf_counter() - t0
            if record:
                acts.append(a)
                if j == 0:
                    lat.append(dt)
                    switch.append(g != prev)
            prev = g
            k += 1
        return np.asarray(lat), np.asarray(switch, bool), acts, k

    # ---- the window ----------------------------------------------------------------

    def window(self, seconds: float, traced: bool) -> Dict:
        self.goals = goal_schedule(len(self.tokens), self.seed, 100_000)
        self.window_seed = A.sub_seed(self.seed, "noise")
        self.gen.manual_seed(self.window_seed)
        with T.profiled(traced) as prof:
            with prof.span("pb.window"):
                t0 = time.perf_counter()
                lat, switch, acts, k = self._loop(seconds, self.goals, True, prof)
                torch.cuda.synchronize() if self.device.type == "cuda" else None
                elapsed = time.perf_counter() - t0
        self.lat, self.switch, self.acts = lat, switch, acts
        ms = lat * 1e3
        return {"values": {"replan_p50_ms": float(np.percentile(ms, 50)),
                           "replan_p95_ms": float(np.percentile(ms, 95))},
                "attempted": len(lat), "units": len(lat), "env_steps": k,
                "window_s": elapsed,
                "replan_ms": ms, "switch": switch, "trace": prof.trace}

    def release(self):
        del self.policy, self.net
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- correctness -------------------------------------------------------------------

    def sample(self) -> np.ndarray:
        """Replans to check: the slowest few and a seeded draw of the rest,
        each with its whole chunk served in the window."""
        n = min(len(self.lat), len(self.acts) // self.multistep)
        want = self.traffic["check_replans"]
        slow = list(np.argsort(-self.lat[:n])[:self.traffic["check_slowest"]])
        rng = np.random.default_rng(A.sub_seed(self.seed, "sample"))
        rest = [int(i) for i in rng.permutation(n) if i not in slow]
        return np.asarray(sorted(slow + rest[:max(0, want - len(slow))]), np.int64)

    def served_chunks(self, idx: np.ndarray) -> np.ndarray:
        m = self.multistep
        return np.stack([np.concatenate(self.acts[r * m:(r + 1) * m], axis=0) for r in idx])

    def reference_inputs(self, idx: np.ndarray):
        m, dev = self.multistep, self.device
        noise = noise_draws(self.window_seed, dev,
                            (1, self.cfg.act_window_size, self.cfg.action_dim), int(idx.max()) + 1)
        frames = [(r * m) % len(self.pool[0]) for r in idx]
        every = self.traffic["goal_every_replans"]
        return {"static": torch.from_numpy(self.pool[0][frames]).to(dev),
                "gripper": torch.from_numpy(self.pool[1][frames]).to(dev),
                "tokens": torch.from_numpy(self.tokens[[int(self.goals[r // every]) for r in idx]]
                                           ).to(dev),
                "noise": torch.cat([noise[r] for r in idx])}

    def readings(self, control: bool = False) -> Dict[str, float]:
        """The compared number: `chunk_gap` (`serving.chunk_gap`) over the
        sampled replans' served actions. With `control`, the control in the
        program's place."""
        idx = self.sample()
        x = self.reference_inputs(idx)
        rows = self.traffic["check_rows"]
        ref = reference_chunks(self.ctx, self.spec, x, rows, False)
        got = reference_chunks(self.ctx, self.spec, x, rows, True) if control \
            else self.served_chunks(idx)
        return {"chunk_gap": chunk_gap(got, ref)}
