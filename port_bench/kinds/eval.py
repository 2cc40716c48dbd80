"""Traffic kind `eval`: `envs` environments in lock-step, the way
`evaluate_policy_batched` runs CALVIN's chains.

Each tick is one call of the port's `make_batched_predict(net)` with a
fresh raw frame pair an env (uint8, drawn from the seed as `tick_pool`
stacked batches of `envs` pairs, which the ticks take in turn, so that the
harness copies no frame inside the window) and every env's current
instruction. Each env switches instruction every `goal_every_ticks` ticks
at its own phase, both drawn from the seed. The environments themselves
are left out, so the card paces the cell.

`eval_chunks_per_s` is ticks x envs over the window's seconds.
Correctness: the served chunks of a sample of the window's ticks, drawn
from the seed with the slowest among them, every env's, against the
reference's from the same frames, instructions and initial noise (the
policy generator's draws, seeded at the window's start and replayed).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from port_bench.harness import agent as A
from port_bench.harness import flops as Fl
from port_bench.harness import trace as T
from port_bench.harness.serving import (chunk_gap, frame_pool, goal_schedule, noise_draws,
                                        goal_tokens, reference_chunks)


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        self.doc, self.traffic = ctx.config, ctx.traffic
        self.seed, self.device = ctx.seed, ctx.device
        self.cfg = ctx.agent_cfg or A.agent_config(self.doc)
        self.N = self.traffic["envs"]

    def setup(self):
        from mdt_policy_tpu_torch.evaluation.policy_adapter import make_batched_predict
        t = self.traffic
        self.net, self.spec = A.build(self.doc, self.seed, self.device, self.cfg)
        self.tokens = goal_tokens(t, self.ctx.home, self.cfg.clip_context_length)
        self.pool = frame_pool(t, self.seed, self.device, t["tick_pool"] * self.N)
        self.batches = [{"rgb_static": self.pool[0][self.frames_of(b)][:, None],
                         "rgb_gripper": self.pool[1][self.frames_of(b)][:, None]}
                        for b in range(t["tick_pool"])]
        self.gen = torch.Generator(self.device).manual_seed(0)
        self.predict = make_batched_predict(self.net, generator=self.gen)
        warm = self._schedule(A.sub_seed(self.seed, "warm"), 64)
        self._loop(t["warmup_ticks"], warm, record=False)

    def _schedule(self, seed: int, n_ticks: int):
        """(phase a env, instruction index a (env, segment))."""
        every, n = self.traffic["goal_every_ticks"], len(self.tokens)
        rng = np.random.default_rng(A.sub_seed(seed, "phase"))
        phase = rng.integers(0, every, size=self.N)
        segs = n_ticks // every + 2
        return phase, np.stack([goal_schedule(n, A.sub_seed(seed, "env", e), segs)
                                for e in range(self.N)])

    def goal_of(self, sched, tick: int) -> np.ndarray:
        phase, table = sched
        return table[np.arange(self.N), (tick + phase) // self.traffic["goal_every_ticks"]]

    def frames_of(self, tick: int) -> np.ndarray:
        return (tick % self.traffic["tick_pool"]) * self.N + np.arange(self.N)

    def _loop(self, limit, sched, record: bool, rec=T.NO_SPANS):
        chunks, lat = [], []
        tick = 0
        t_start = time.perf_counter()
        while (time.perf_counter() - t_start < limit) if record else tick < limit:
            obs = self.batches[tick % len(self.batches)]
            goals = [{"lang_tokens": self.tokens[g]} for g in self.goal_of(sched, tick)]
            with rec.span("pb.tick"):
                t0 = time.perf_counter()
                out = self.predict(obs, goals)
                dt = time.perf_counter() - t0
            if record:
                chunks.append(out)
                lat.append(dt)
            tick += 1
        return chunks, np.asarray(lat), tick

    def window(self, seconds: float, traced: bool) -> Dict:
        from mdt_policy_tpu_torch.ops.fused_qkv_attention import fused_qkv_attention
        self.sched = self._schedule(self.seed, 200_000)
        self.window_seed = A.sub_seed(self.seed, "noise")
        self.gen.manual_seed(self.window_seed)
        if traced:
            self.tick_flops = self._count_flops()
        b1_before = fused_qkv_attention.launches
        with T.profiled(traced) as prof:
            with prof.span("pb.window"):
                t0 = time.perf_counter()
                chunks, lat, ticks = self._loop(seconds, self.sched, True, prof)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                elapsed = time.perf_counter() - t0
        self.chunks, self.lat = chunks, lat
        return {"values": {"eval_chunks_per_s": ticks * self.N / elapsed},
                "attempted": ticks * self.N, "ticks": ticks, "units": ticks,
                "window_s": elapsed,
                "b1_launches": fused_qkv_attention.launches - b1_before,
                "text_layers": self.cfg.clip_text_layers, "trace": prof.trace}

    def _count_flops(self) -> Dict[str, float]:
        """FLOPs by dtype of one tick's replan (the policy's eager route,
        which the graph replays) and of one text-tower encode at the envs'
        batch; B1's and B2's from their shapes."""
        from mdt_policy_tpu_torch.agents import MDTVPolicy
        c, N = self.cfg, self.N
        pol = MDTVPolicy(self.net, torch.Generator(self.device).manual_seed(1), cuda_graph=False)
        from mdt_policy_tpu_torch.data.loader import Preprocessor
        pp = Preprocessor(static_size=c.img_size, gripper_size=min(84, c.img_size),
                          gen_size=c.gen_img_res, device=self.device)
        batch = pp.eval_batch(self.batches[0])
        toks = torch.from_numpy(self.tokens[self.goal_of(self.sched, 0)]).to(self.device)
        emb = self.net.encode_language_goal(toks)
        with torch.no_grad():
            replan = Fl.count_by_dtype(lambda: pol.plan(batch, {"lang": emb}))
            text = Fl.count_by_dtype(lambda: self.net.encode_language_goal(toks))
        L, W = c.clip_text_layers, c.clip_text_width
        text["bfloat16"] = text.get("bfloat16", 0.0) + L * Fl.attention_flops(
            N, c.clip_context_length, W, causal=True)
        E, D = c.n_enc_layers, c.embed_dim
        n_ctx = 1 + (2 if self.doc["family"] == "mdt" else c.num_latents)
        b2 = E * Fl.attention_flops(N * c.n_heads, n_ctx, D // c.n_heads) + \
            c.n_dec_layers * c.num_sampling_steps * Fl.attention_flops(
                N * c.n_heads, c.act_window_size, D // c.n_heads, causal=True)
        replan["float32"] = replan.get("float32", 0.0) + b2
        return {"replan": replan, "text": text}

    def release(self):
        del self.predict, self.net
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- correctness -------------------------------------------------------------------

    def sample(self) -> np.ndarray:
        n = len(self.chunks)
        slow = list(np.argsort(-self.lat)[:self.traffic["check_slowest"]])
        rng = np.random.default_rng(A.sub_seed(self.seed, "sample"))
        rest = [int(i) for i in rng.permutation(n) if i not in slow]
        want = self.traffic["check_ticks"]
        return np.asarray(sorted(slow + rest[:max(0, want - len(slow))]), np.int64)

    def readings(self, control: bool = False) -> Dict[str, float]:
        """The compared number: `chunk_gap` (`serving.chunk_gap`) over every
        env's chunk of the sampled ticks. With `control`, the control in the
        program's place."""
        idx, dev = self.sample(), self.device
        noise = noise_draws(self.window_seed, dev, (self.N, self.cfg.act_window_size,
                                                    self.cfg.action_dim), int(idx.max()) + 1)
        frames = np.concatenate([self.frames_of(int(t)) for t in idx])
        x = {"static": torch.from_numpy(self.pool[0][frames]).to(dev),
             "gripper": torch.from_numpy(self.pool[1][frames]).to(dev),
             "tokens": torch.from_numpy(np.concatenate(
                 [self.tokens[self.goal_of(self.sched, int(t))] for t in idx])).to(dev),
             "noise": torch.cat([noise[int(t)] for t in idx])}
        rows = self.traffic["check_rows"]
        ref = reference_chunks(self.ctx, self.spec, x, rows, False)
        got = reference_chunks(self.ctx, self.spec, x, rows, True) if control \
            else np.concatenate([self.chunks[int(t)] for t in idx])
        return {"chunk_gap": chunk_gap(got, ref)}
