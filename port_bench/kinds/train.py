"""Traffic kind `train`: the port's training step at a fixed dual-scope
batch, fed the way `training.train()` feeds it.

Set-up makes a pool of `pool` raw uint8 batches on the device from the
seed (both cameras at `static_hw` and `gripper_hw` pixels, observation and
goal frame; the foresight frames at the same sizes; actions uniform in
[-1, 1]; in the lang scope token ids of the traffic's sentences) and keeps
them in pinned host memory. A `DevicePrefetcher` copies them to the card
and runs `Preprocessor.train_batch` on its side stream with the DrQ
offsets drawn from the seed; `train_step` takes each batch with the step's
draws (sigma, action noise, foresight mask, a dropout generator a scope)
drawn from the seed. The first three steps, through that same feed and
call and on three different batches, are the compared ones; more steps
warm the allocator and cuDNN up; the window then steps for its seconds,
without a sync until its end.

`train_chunks_per_s` is the chunks of both scopes stepped in the window
over its seconds. Correctness: the reference follows the first three
steps from the same weights, batches and draws; compared are each step's
total loss, the first gradient as the optimizer got it (from AdamW's first
moment after one step), the parameters' change after three steps and the
EMA's, each by the worst leaf (see `readings`).
"""

from __future__ import annotations

import itertools
import time
from typing import Dict

import numpy as np
import torch

from port_bench.harness import agent as A
from port_bench.harness import trace as T
from port_bench.harness.serving import goal_tokens

COMPARED_STEPS = 3


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        self.doc, self.traffic = ctx.config, ctx.traffic
        self.seed, self.device = ctx.seed, ctx.device
        self.cfg = ctx.agent_cfg or A.agent_config(self.doc)
        t = self.traffic
        self.B = t["batch_per_stream"]
        self.tokens = goal_tokens(t, ctx.home, self.cfg.clip_context_length)

    # ---- inputs, all from the seed -------------------------------------------------

    def raw_batch(self, i: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Pool batch `i` on the device: {scope: {key: tensor}}."""
        t, dev, B = self.traffic, self.device, self.B
        gen = torch.Generator(dev).manual_seed(A.sub_seed(self.seed, "pool", i))
        s, g = t["static_hw"], t["gripper_hw"]
        u8 = lambda *shape: torch.randint(0, 256, shape, generator=gen, device=dev,
                                          dtype=torch.uint8)
        out = {}
        for scope in ("lang", "vis"):
            d = {"rgb_static": u8(B, 2, s, s, 3), "rgb_gripper": u8(B, 2, g, g, 3),
                 "gen_static": u8(B, s, s, 3), "gen_gripper": u8(B, g, g, 3),
                 "actions": torch.rand((B, self.cfg.act_window_size, self.cfg.action_dim),
                                       generator=gen, device=dev) * 2 - 1}
            if scope == "lang":
                rows = torch.randint(0, len(self.tokens), (B,), generator=gen, device=dev)
                d["lang_tokens"] = torch.from_numpy(self.tokens).to(dev)[rows]
            out[scope] = d
        return out

    def offsets(self, i: int, scope: str) -> Dict[str, torch.Tensor]:
        """The DrQ shift offsets of batch `i`'s scope, on the device."""
        gen = torch.Generator(self.device).manual_seed(A.sub_seed(self.seed, "drq", i, scope))
        frames = self.B * 2
        return {"rgb_static": torch.randint(0, 21, (frames, 2), generator=gen, device=self.device),
                "rgb_gripper": torch.randint(0, 9, (frames, 2), generator=gen,
                                             device=self.device)}

    def draws(self, step: int) -> Dict[str, Dict]:
        """Step `step`'s random numbers a scope: `make_draws`' layout."""
        out, dev, c = {}, self.device, self.cfg
        n_patches = (c.gen_img_res // c.gen_patch_size) ** 2
        for scope in ("lang", "vis"):
            gen = torch.Generator(dev).manual_seed(A.sub_seed(self.seed, "step", step, scope))
            out[scope] = {
                "sigma": torch.rand((self.B,), generator=gen, device=dev),
                "noise": torch.randn((self.B, c.act_window_size, c.action_dim), generator=gen,
                                     device=dev),
                "mask": torch.rand((self.B, n_patches), generator=gen, device=dev),
                "dropout": torch.Generator(dev).manual_seed(
                    A.sub_seed(self.seed, "dropout", step, scope))}
        return out

    # ---- set-up --------------------------------------------------------------------

    def setup(self):
        from mdt_policy_tpu_torch.agents import init_train_state
        from mdt_policy_tpu_torch.data.loader import DevicePrefetcher, Preprocessor
        c, t = self.cfg, self.traffic
        self.net, self.spec = A.build(self.doc, self.seed, self.device, c)
        self.state = init_train_state(self.net)
        pp = Preprocessor(static_size=c.img_size, gripper_size=min(84, c.img_size),
                          gen_size=c.gen_img_res, device=self.device)
        cuda = self.device.type == "cuda"
        host = lambda x: x.cpu().pin_memory() if cuda else x.cpu()
        pool = [{s: {k: host(v) for k, v in b.items()} for s, b in self.raw_batch(i).items()}
                for i in range(t["pool"])]

        def device_fn(i, raw):
            return {s: pp.train_batch(raw[s], draws=self.offsets(i, s)) for s in sorted(raw)}

        self.prefetcher = DevicePrefetcher((pool[i % len(pool)] for i in itertools.count()),
                                           device_fn, device=self.device, depth=2)
        self.step = 0
        losses = []
        for s in range(COMPARED_STEPS + t["warmup_steps"]):
            m = self._step()
            if s == 0:
                self.first_grad = self._snapshot(
                    lambda p: self.state.optimizer.state[p]["exp_avg"]
                    / (1 - self.state.optimizer.param_groups[0]["betas"][0]))
            if s < COMPARED_STEPS:
                losses.append(m["train/total_loss"])
            if s == COMPARED_STEPS - 1:
                self.after = self._snapshot(lambda p: p.detach())
                self.ema_after = {n: v.detach().to("cpu", copy=True)
                                  for n, v in self.state.ema.items()}
        self.losses = [float(x) for x in losses]
        self._sync()

    def _snapshot(self, fn) -> Dict[str, torch.Tensor]:
        return {n: fn(p).detach().to("cpu", copy=True) for n, p in self.net.trainable_parameters()}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self):
        from mdt_policy_tpu_torch.agents import train_step
        batch = next(self.prefetcher)
        m = train_step(self.state, batch, draws=self.draws(self.step))
        self.step += 1
        return m

    # ---- the window ------------------------------------------------------------------

    def b1_calls(self):
        """(batch, tokens, width, causal) of every B1 call of a step: the
        Voltron tower over both cameras of both scopes (MDT-V), the CLIP
        vision tower over both scopes' goal frames, the text tower over the
        lang scope; a call a layer."""
        c, B = self.cfg, self.B
        calls = []
        if self.doc["family"] == "mdtv":
            calls += [(2 * B, (c.img_size // c.vit_patch) ** 2, c.perceiver_dim, False)] \
                * (2 * c.vit_depth)
        calls += [(B, (c.img_size // c.clip_vision_patch) ** 2 + 1, c.clip_vision_width,
                   False)] * (2 * c.clip_vision_layers)
        calls += [(B, c.clip_context_length, c.clip_text_width, True)] * c.clip_text_layers
        return calls

    def _count_flops(self) -> Dict[str, float]:
        """FLOPs by dtype of one step, the B1 calls' from their shapes."""
        from mdt_policy_tpu_torch.agents import train_step
        from port_bench.harness import flops as Fl
        batch, draws = next(self.prefetcher), self.draws(self.step)
        out = Fl.count_by_dtype(lambda: train_step(self.state, batch, draws=draws))
        self.step += 1
        out["bfloat16"] = out.get("bfloat16", 0.0) + sum(
            Fl.attention_flops(*call) for call in self.b1_calls())
        self._sync()
        return out

    def window(self, seconds: float, traced: bool) -> Dict:
        from mdt_policy_tpu_torch.agents import train_step
        waits, issues = [], []
        self.step_flops = self._count_flops() if traced else None
        with T.profiled(traced) as prof:
            with prof.span("pb.window"):
                t0 = time.perf_counter()
                n = 0
                while time.perf_counter() - t0 < seconds:
                    with prof.span("pb.next_batch"):
                        tb = time.perf_counter()
                        batch = next(self.prefetcher)
                        waits.append(time.perf_counter() - tb)
                    draws = self.draws(self.step)
                    with prof.span("pb.train_step"):
                        ts = time.perf_counter()
                        train_step(self.state, batch, draws=draws)
                        issues.append(time.perf_counter() - ts)
                    self.step += 1
                    n += 1
                self._sync()
                elapsed = time.perf_counter() - t0
        chunks = n * 2 * self.B
        return {"values": {"train_chunks_per_s": chunks / elapsed},
                "attempted": n, "steps": n, "units": n, "window_s": elapsed,
                "issue_ms": np.asarray(issues) * 1e3, "wait_ms": np.asarray(waits) * 1e3,
                "trace": prof.trace}

    def release(self):
        self.prefetcher.close()
        self.prefetcher._thread.join(timeout=10)
        del self.prefetcher, self.state, self.net
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- correctness -------------------------------------------------------------------

    def reference_steps(self, control: bool = False):
        from port_bench.reference.common import Prec
        ref, fields = self.ctx.reference, self.ctx.cfg_fields

        def step(i):
            def make():
                raw = self.raw_batch(i)
                frames = {s: ref.train_frames_of(fields, raw[s], self.offsets(i, s))
                          for s in raw}
                d = self.draws(i)
                draws = {s: {k: v for k, v in d[s].items() if k != "dropout"} for s in d}
                return frames, draws, {s: d[s]["dropout"] for s in d}
            return make

        P = A.weights_of(fields, self.spec, self.seed, self.device)
        return ref.train_steps(fields, P, Prec(control),
                               [step(i) for i in range(COMPARED_STEPS)])

    def readings(self, control: bool = False) -> Dict[str, float]:
        """The compared numbers, each a worst case: `loss_gap`, the largest
        relative gap of a step's total loss; `grad_gap`, `step_gap` and
        `ema_gap`, the largest gap between the norms of a leaf's first
        gradient, of its change over the three steps and of its EMA's
        change, over the larger of the reference's norm of that leaf and of
        the median leaf. Leaves whose reference gradient is under a
        thousandth of the median leaf's are left out (their updates are
        round-off under AdamW). With `control`, the control in the
        program's place."""
        if getattr(self, "_reference", None) is None:
            self._reference = self.reference_steps()
        losses, g1, p3, e3 = self._reference
        P0 = A.weights_of(self.ctx.cfg_fields, self.spec, self.seed, self.device)
        if control:
            c_losses, c_g1, c_p3, c_e3 = self.reference_steps(control=True)
            got = (c_losses, c_g1, {k: c_p3[k] - P0[k] for k in p3},
                   {k: c_e3[k] - P0[k] for k in e3})
        else:
            dev = self.device
            got = (self.losses, {k: self.first_grad[k].to(dev) for k in g1},
                   {k: self.after[k].to(dev).float() - P0[k] for k in p3},
                   {k: self.ema_after[k].to(dev).float() - P0[k] for k in e3})
        want = (losses, g1, {k: p3[k] - P0[k] for k in p3}, {k: e3[k] - P0[k] for k in e3})
        gnorm = {k: float(torch.linalg.vector_norm(v)) for k, v in g1.items()}
        med = float(np.median(list(gnorm.values())))
        kept = [k for k, v in gnorm.items() if v >= 1e-3 * med]
        out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got[0], want[0]))}
        self.worst = {}
        for name, i in (("grad_gap", 1), ("step_gap", 2), ("ema_gap", 3)):
            norm = lambda d: {k: float(torch.linalg.vector_norm(d[k].float())) for k in kept}
            g, w = norm(got[i]), norm(want[i])
            floor = float(np.median(list(w.values())))
            gaps = {k: abs(g[k] - w[k]) / max(w[k], floor) for k in kept}
            out[name] = max(gaps.values())
            self.worst[name] = sorted(gaps, key=gaps.get)[-3:]
        return out
