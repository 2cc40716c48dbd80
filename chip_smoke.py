#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mdt_policy_tpu_torch`) on one GPU.

    python3 chip_smoke.py        # from the root of the repository

Drives the port's two paths at the production width (`MDTVConfig()`, seeded
random weights): the MDT-V closed-loop replan through `MDTVPolicy`, and the
dual-modality train step through `train_step` at B=128 per stream. Prints
one JSON line per phase:

  1. device   card name and power limit (nvidia-smi); TF32 off.
  2. build    nvcc of every kernel source, all started together, in seconds.
  3. kernel   each kernel against its plain PyTorch version on the card at
              the paths' shapes, bf16 and f32, with CUDA-event times of the
              kernel, the plain version and the PyTorch library call, the
              kernel's device time from the profiler (`device_ms`), and the
              least time the card could take (`bound_ms`).
  4. replan   reset() and 20 step() calls at B=1; B1 launches must be 24
              then 12, B3 launches 50 then 25.
  5. e2e      the same replan through the kernels and through the plain
              versions: the (1, 10, 7) chunks must agree.
  6. timing   replan p50/p90 at B=1 and B=32, goal-encode time; then 5
              replans under the profiler (device events and busy share).
  7. train    3 train steps at B=128 per stream: finite losses and
              grad_norm, trainables and EMA moved, frozen towers not; per
              step 60 B1 and 157 B3 launches.
  8. train_e2e  one step from the same state and draws through the kernels
              and through the plain versions: losses and grad_norm agree.
  9. train_timing  step ms p50/p90 over 10 steps after 3 warm-up steps,
              chunks/s, peak memory; then a profiled window of 2 steps.

Then the kernel summary line, and last `{"ok": true, "device": ...}`. Any
failure raises and exits non-zero; without a CUDA device it exits 1.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, FLOP/s by dtype
# (f32 outside the tensor cores: no TF32 here)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# B1 (name, B, T, C, H, causal): the replan's shapes, the train step's at
# B=128 per stream (Voltron 256 images, CLIP vision 128), and the training
# batch of the JAX package's benchmark
KERNEL_SHAPES = (
    ("voltron", 2, 196, 384, 6, False),
    ("voltron_train", 256, 196, 384, 6, False),
    ("voltron_batch", 1024, 196, 384, 6, False),
    ("clip_text", 1, 77, 512, 8, True),
    ("clip_vision", 2, 197, 768, 12, False),
    ("clip_vision_train", 128, 197, 768, 12, False),
)
# |kernel - plain| bounds. f32: both accumulate in f32 and differ only in
# summation order (~1e-6). bf16: the output is rounded to bf16 (8 significant
# bits, 3.9e-3 relative on values of order 1), and a probability can round
# to the neighbouring bf16 value when the two f32 scores differ in the last bit.
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# B3 (function, name, rows, D): Voltron at one replan (2 images) and at one
# train scope (256 images), CLIP vision (128 images x 197), CLIP text (128
# goals x 77), the foresight decoder (128 x (4 context + 98 patch tokens))
NORM_SHAPES = (
    ("rms", "voltron", 392, 384),
    ("rms", "voltron_train", 50176, 384),
    ("ln", "clip_vision_train", 25216, 768),
    ("ln", "clip_text_train", 9856, 512),
    ("rms", "decoder_train", 13056, 192),
)
# B3 bounds relative to max(1, max|ref|): f32 summation order (~1e-6); bf16
# one rounding of the output (3.9e-3) and its neighbour when the f32 results
# differ in the last bit
NORM_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# Bound on the replan chunk, kernel path vs plain path, relative to
# max(1, max|chunk|): the towers are bf16, so a one-ulp difference in a token
# (3.9e-3 relative) can propagate through the perceiver into the f32 denoiser.
E2E_REL_TOL = 2e-2
# Bound on the train step's losses and grad_norm, kernel path vs plain path,
# relative to max(1, |value|): the same bf16 one-ulp differences in the
# frozen towers' outputs, averaged over 128 samples per scope.
TRAIN_E2E_REL_TOL = 2e-2
REPLANS_TIMED = 100
TRAIN_BATCH = 128  # per stream (configs/mdtv_calvin_d.yaml: batch_size)
TRAIN_STEPS_TIMED = 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def event_ms(fn, iters: int, torch) -> float:
    """Mean milliseconds per call of `fn` on the card, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel_name: str, iters: int, torch):
    """Mean device time per launch of the kernels whose name holds
    `kernel_name`, from torch.profiler over `iters` calls: the kernel's own
    time, which the event times above hide where the host's per-call cost
    is the larger. None when the profiler records no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in _device_events(torch, prof)
             if kernel_name in e.name]
    return sum(times) / len(times) / 1e3 if times else None


def bound_ms(n_bytes: float, flops: float, dtype_name: str):
    """(least ms on the card, "bytes" or "operations"): the larger of the
    traffic over HBM bandwidth and the operations over the dtype's peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[torch.cuda.current_device()]
    print(smi, flush=True)
    # f32 matmuls and the f32 patch conv must run in full f32, not TF32,
    # or the f32 checks drift by TF32 rounding
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build():
    """One nvcc per source, all started together."""
    from mdt_policy_tpu_torch.ops import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))

    def build(name):
        t0 = time.perf_counter()
        _build.load_library(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        seconds = dict(zip(names, pool.map(build, names)))
    total = time.perf_counter() - t0
    emit({"phase": "build", "kernels": seconds, "seconds": total})
    return total


def _sdpa_views(qkv, H, torch):
    """q, k, v of the packed (B, T, 3C) qkv as contiguous (B, H, T, dh)."""
    B, T, C3 = qkv.shape
    q, k, v = qkv.view(B, T, 3, H, C3 // (3 * H)).permute(2, 0, 3, 1, 4)
    return q.contiguous(), k.contiguous(), v.contiguous()


def phase_kernel_b1(torch, device):
    import torch.nn.functional as F
    from mdt_policy_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention, fused_qkv_attention_reference)
    gen = torch.Generator(device).manual_seed(0)
    rows = []
    for name, B, T, C, H, causal in KERNEL_SHAPES:
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            qkv = torch.randn((B, T, 3 * C), generator=gen, device=device).to(dtype)
            out = fused_qkv_attention(qkv, H, causal)
            ref = fused_qkv_attention_reference(qkv, H, causal)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            iters = 20 if B > 64 else 200
            ms = event_ms(lambda: fused_qkv_attention(qkv, H, causal), iters, torch)
            plain_ms = event_ms(lambda: fused_qkv_attention_reference(qkv, H, causal),
                                iters, torch)

            def library():  # the same function from the same packed input
                y = F.scaled_dot_product_attention(*_sdpa_views(qkv, H, torch),
                                                   is_causal=causal)
                return y.transpose(1, 2).reshape(B, T, C)
            views = _sdpa_views(qkv, H, torch)
            library_ms = event_ms(library, iters, torch)
            sdpa_only_ms = event_ms(lambda: F.scaled_dot_product_attention(
                *views, is_causal=causal), iters, torch)
            pairs = T * (T + 1) // 2 if causal else T * T
            bms, by = bound_ms(qkv.numel() * qkv.element_size() * 4 / 3,
                               4 * B * H * pairs * (C // H), dtype_name)
            row = {"phase": "kernel", "kernel": "fused_qkv_attention",
                   "shape": name, "qkv": [B, T, 3 * C], "heads": H,
                   "causal": causal, "dtype": dtype_name, "max_abs_err": err,
                   "tol": KERNEL_TOL[dtype_name], "ms": ms,
                   "device_ms": device_ms(lambda: fused_qkv_attention(qkv, H, causal),
                                          "fused_qkv_attention_kernel", 10, torch),
                   "plain_ms": plain_ms,
                   "library_ms": library_ms, "sdpa_only_ms": sdpa_only_ms,
                   "bound_ms": bms, "bound_by": by}
            emit(row)
            if not err <= KERNEL_TOL[dtype_name]:
                raise AssertionError(f"B1 disagrees with its plain version: {row}")
            rows.append(row)
    return rows


def phase_kernel_b3(torch, device):
    import torch.nn.functional as F
    from mdt_policy_tpu_torch.ops.fused_norm import (
        fused_layer_norm, fused_layer_norm_reference, fused_rms_norm,
        fused_rms_norm_reference)
    gen = torch.Generator(device).manual_seed(1)
    rows = []
    for kind, name, n, D in NORM_SHAPES:
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            x = (torch.randn((n, D), generator=gen, device=device) * 3).to(dtype)
            w = torch.randn((D,), generator=gen, device=device).to(dtype)
            b = torch.randn((D,), generator=gen, device=device).to(dtype)
            if kind == "ln":
                fn = "fused_layer_norm"
                kernel = lambda: fused_layer_norm(x, w, b, 1e-5)
                plain = lambda: fused_layer_norm_reference(x, w, b, 1e-5)
                library = lambda: F.layer_norm(x, (D,), w, b, 1e-5)
            else:
                fn = "fused_rms_norm"
                kernel = lambda: fused_rms_norm(x, w, 1e-8)
                plain = lambda: fused_rms_norm_reference(x, w, 1e-8)
                # eps sits inside the square root there: the same work, not
                # quite the same function
                library = lambda: F.rms_norm(x, (D,), w, 1e-8)
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            bound = NORM_TOL[dtype_name] * max(1.0, ref.float().abs().max().item())
            iters = 200
            n_weights = 2 if kind == "ln" else 1
            bms, by = bound_ms((2 * n + n_weights) * D * x.element_size(),
                               8 * n * D, dtype_name)
            row = {"phase": "kernel", "kernel": fn, "shape": name, "x": [n, D],
                   "dtype": dtype_name, "max_abs_err": err, "bound": bound,
                   "ms": event_ms(kernel, iters, torch),
                   "device_ms": device_ms(kernel, "fused_norm_kernel", 20, torch),
                   "plain_ms": event_ms(plain, iters, torch),
                   "library_ms": event_ms(library, iters, torch),
                   "bound_ms": bms, "bound_by": by}
            emit(row)
            if not err <= bound:
                raise AssertionError(f"B3 disagrees with its plain version: {row}")
            rows.append(row)
    return rows


def make_inputs(torch, cfg, batch: int, seed: int, device):
    """Camera frames (B, 1, H, W, 3) and a 77-token goal whose EOT id is its
    largest, drawn from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    static = torch.randn((batch, 1, cfg.img_size, cfg.img_size, 3), generator=gen)
    gripper = torch.randn((batch, 1, 84, 84, 3), generator=gen)
    obs = {"rgb_static": static.to(device), "rgb_gripper": gripper.to(device)}
    return obs, {"lang_tokens": make_tokens(torch, cfg, batch, gen).to(device)}


def make_tokens(torch, cfg, batch: int, gen):
    tokens = torch.zeros((batch, cfg.clip_context_length), dtype=torch.long)
    tokens[:, 0] = cfg.clip_vocab_size - 2  # start-of-text
    tokens[:, 1:9] = torch.randint(1, cfg.clip_vocab_size - 2, (batch, 8), generator=gen)
    tokens[:, 9] = cfg.clip_vocab_size - 1  # end-of-text, the largest id
    return tokens


def build_net(torch, cfg, device):
    from mdt_policy_tpu_torch.agents import MDTVAgentNet, init_random_
    net = MDTVAgentNet(cfg, device=device)
    init_random_(net, torch.Generator().manual_seed(0))
    return net


class Launches:
    """The kernels' launch counters: reset, read."""

    def __init__(self):
        from mdt_policy_tpu_torch.ops.fused_norm import fused_layer_norm, fused_rms_norm
        from mdt_policy_tpu_torch.ops.fused_qkv_attention import fused_qkv_attention
        self.fns = {"fused_qkv_attention": fused_qkv_attention,
                    "fused_layer_norm": fused_layer_norm,
                    "fused_rms_norm": fused_rms_norm}

    def reset(self):
        for fn in self.fns.values():
            fn.launches = 0

    def read(self):
        return {name: fn.launches for name, fn in self.fns.items()}


def phase_replan(torch, net, device, launches: Launches):
    """reset() and 20 step() calls at B=1, counting launches per replan."""
    from mdt_policy_tpu_torch.agents import MDTVPolicy
    cfg = net.cfg
    obs, goal = make_inputs(torch, cfg, 1, seed=1, device=device)
    policy = MDTVPolicy(net, generator=torch.Generator(device).manual_seed(1))
    policy.reset()
    launches.reset()
    per_replan, actions = [], []
    for step in range(20):
        before = launches.read()
        action = policy.step(obs, goal)
        if step % cfg.multistep == 0:
            after = launches.read()
            per_replan.append({k: after[k] - before[k] for k in after})
        actions.append(action)
    torch.cuda.synchronize()
    total = launches.read()
    acts = torch.stack(actions)
    ok = all(tuple(a.shape) == (1, cfg.action_dim) for a in actions) \
        and bool(torch.isfinite(acts).all())
    b3 = [r["fused_layer_norm"] + r["fused_rms_norm"] for r in per_replan]
    emit({"phase": "replan", "steps": 20, "launches_per_replan": per_replan,
          "b1_per_replan": [r["fused_qkv_attention"] for r in per_replan],
          "b3_per_replan": b3, "launches": total,
          "actions_finite_and_shaped": ok, "first_action": actions[0].tolist()})
    if not ok:
        raise AssertionError("replan produced non-finite or misshaped actions")
    # Voltron blocks (+ causal text blocks on the first replan; then the goal
    # is cached): B1 one per block; B3 two RMSNorms per Voltron block and
    # its encoder_norm, two LayerNorms per text block and ln_final
    text_ln = 2 * cfg.clip_text_layers + 1
    expected = [{"fused_qkv_attention": cfg.vit_depth + cfg.clip_text_layers,
                 "fused_layer_norm": 1 + text_ln, "fused_rms_norm": 2 * cfg.vit_depth},
                {"fused_qkv_attention": cfg.vit_depth, "fused_layer_norm": 1,
                 "fused_rms_norm": 2 * cfg.vit_depth}]
    if per_replan != expected:
        raise AssertionError(f"launches per replan {per_replan}, expected {expected}")
    return total


def plain_kernels():
    """Patches every kernel call site with the kernel's plain version."""
    from mdt_policy_tpu_torch.models import blocks, clip, voltron_vit
    from mdt_policy_tpu_torch.ops.fused_norm import (fused_layer_norm_reference,
                                                     fused_rms_norm_reference)
    from mdt_policy_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention_reference)
    patches = [mock.patch.object(voltron_vit, "fused_qkv_attention",
                                 fused_qkv_attention_reference),
               mock.patch.object(clip, "fused_qkv_attention",
                                 fused_qkv_attention_reference),
               mock.patch.object(blocks, "fused_layer_norm", fused_layer_norm_reference),
               mock.patch.object(blocks, "fused_rms_norm", fused_rms_norm_reference)]
    stack = contextlib.ExitStack()
    for p in patches:
        stack.enter_context(p)
    return stack


def phase_e2e(torch, net, device, launches: Launches):
    """One replan through the kernels and through the plain versions."""
    from mdt_policy_tpu_torch.agents import denoise_actions
    obs, goal = make_inputs(torch, net.cfg, 1, seed=2, device=device)
    noise = torch.randn((1, net.cfg.act_window_size, net.cfg.action_dim),
                        generator=torch.Generator().manual_seed(3)).to(device)

    def chunk():
        with torch.no_grad():
            emb = net.perceive(obs["rgb_static"], obs["rgb_gripper"])
            lang = net.encode_language_goal(goal["lang_tokens"])
            return denoise_actions(net, emb, lang, noise=noise)

    kernel_chunk = chunk()
    before = launches.read()
    with plain_kernels():
        plain_chunk = chunk()
    if launches.read() != before:
        raise AssertionError("the plain path launched a kernel")
    err = (kernel_chunk - plain_chunk).abs().max().item()
    scale = max(1.0, plain_chunk.abs().max().item())
    row = {"phase": "e2e", "chunk_shape": list(kernel_chunk.shape),
           "max_abs_err": err, "max_abs_chunk": plain_chunk.abs().max().item(),
           "bound": E2E_REL_TOL * scale,
           "finite": bool(torch.isfinite(kernel_chunk).all())}
    emit(row)
    if not (row["finite"] and err <= row["bound"]):
        raise AssertionError(f"kernel path and plain path disagree: {row}")
    return err


def time_replans(torch, net, batch: int, device):
    """Replan latency at `batch` parallel envs (goal cached): CUDA events
    around policy.step() with the action fetched to the host; then 5
    replans under torch.profiler."""
    from mdt_policy_tpu_torch.agents import MDTVPolicy
    obs, goal = make_inputs(torch, net.cfg, batch, seed=4, device=device)
    policy = MDTVPolicy(net, generator=torch.Generator(device).manual_seed(5))
    policy.step(obs, goal)  # encodes and caches the goal

    def replan():
        policy.rollout_step_counter = 0  # the next step replans
        return policy.step(obs, goal).cpu()

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for i in range(3 + REPLANS_TIMED):
        torch.cuda.synchronize()
        start.record()
        replan()
        end.record()
        torch.cuda.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    encode_ms = event_ms(lambda: net.encode_language_goal(goal["lang_tokens"]),
                         20, torch)
    return times, encode_ms, profile_calls(torch, replan, 5)


def phase_timing(torch, net, device, smi):
    rows = {}
    for batch in (1, 32):
        torch.cuda.reset_peak_memory_stats()
        times, encode_ms, prof = time_replans(torch, net, batch, device)
        row = {"phase": "timing", "batch": batch, "replans": len(times),
               "replan_ms_p50": float(np.percentile(times, 50)),
               "replan_ms_p90": float(np.percentile(times, 90)),
               "replan_ms_min": min(times), "replan_ms_max": max(times),
               "goal_encode_ms": encode_ms,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "card": smi}
        emit(row)
        emit({"phase": "replan_profile", "batch": batch, **prof, "card": smi})
        rows[batch] = row
    return rows


def make_train_batch(torch, cfg, batch: int, device):
    """A synthetic, already-normalized dual-scope batch on the card: static
    frames at 224 px and gripper frames at 84 px (T+1 = 2: observation and
    goal frame), foresight frames at 112 px, (B, 10, 7) actions, 77-token
    goals."""
    gen = torch.Generator(device).manual_seed(6)
    cpu_gen = torch.Generator().manual_seed(6)
    g = cfg.gen_img_res

    def scope():
        return {
            "rgb_static": torch.randn((batch, 2, cfg.img_size, cfg.img_size, 3),
                                      generator=gen, device=device),
            "rgb_gripper": torch.randn((batch, 2, 84, 84, 3), generator=gen, device=device),
            "gen_static": torch.randn((batch, g, g, 3), generator=gen, device=device),
            "gen_gripper": torch.randn((batch, g, g, 3), generator=gen, device=device),
            "actions": torch.randn((batch, cfg.act_window_size, cfg.action_dim),
                                   generator=gen, device=device),
            "lang_tokens": make_tokens(torch, cfg, batch, cpu_gen).to(device),
        }
    return {"vis": scope(), "lang": scope()}


def expected_train_launches(cfg):
    """Per train step (both scopes): B1 in every Voltron and CLIP vision
    block (each scope) and every CLIP text block (lang scope); B3 LayerNorm
    in Voltron's encoder_norm and CLIP vision's ln_pre, ln_1/ln_2, ln_post
    (each scope) and CLIP text's ln_1/ln_2, ln_final (lang scope); B3 RMSNorm
    in the Voltron and foresight-decoder blocks and decoder_norm (each
    scope) and the MAP head's two norms (twice, lang scope)."""
    return {"fused_qkv_attention": 2 * cfg.vit_depth + 2 * cfg.clip_vision_layers
            + cfg.clip_text_layers,
            "fused_layer_norm": 2 * (1 + 2 * cfg.clip_vision_layers + 2)
            + 2 * cfg.clip_text_layers + 1,
            "fused_rms_norm": 2 * 2 * cfg.vit_depth
            + 2 * (2 * cfg.gen_decoder_depth + 1) + 2 * 2}


def _frozen_and_trainable(torch, net):
    from mdt_policy_tpu_torch.agents import FROZEN_PREFIXES
    frozen = {n: p.detach().clone() for n, p in net.named_parameters()
              if n.split(".", 1)[0] in FROZEN_PREFIXES}
    trainable = {n: p.detach().clone() for n, p in net.trainable_parameters()}
    return frozen, trainable


def phase_train(torch, net, device, launches: Launches):
    """3 train steps at B=128 per stream, counting launches per step."""
    from mdt_policy_tpu_torch.agents import init_train_state, train_step
    cfg = net.cfg
    batch = make_train_batch(torch, cfg, TRAIN_BATCH, device)
    state = init_train_state(net)
    gen = torch.Generator(device).manual_seed(7)
    frozen0, trainable0 = _frozen_and_trainable(torch, net)
    launches.reset()
    per_step, metrics = [], []
    for _ in range(3):
        before = launches.read()
        m = train_step(state, batch, generator=gen)
        torch.cuda.synchronize()
        after = launches.read()
        per_step.append({k: after[k] - before[k] for k in after})
        metrics.append({k: float(v) for k, v in m.items()})
    total = launches.read()
    frozen1, trainable1 = _frozen_and_trainable(torch, net)
    checks = {
        "finite": all(np.isfinite(v) for m in metrics for v in m.values()),
        "trainables_moved": sum(not torch.equal(trainable0[k], trainable1[k])
                                for k in trainable0),
        "n_trainables": len(trainable0),
        "ema_moved": sum(not torch.equal(trainable0[k], state.ema[k]) for k in state.ema),
        "frozen_unchanged": all(torch.equal(frozen0[k], frozen1[k]) for k in frozen0),
    }
    expected = expected_train_launches(cfg)
    emit({"phase": "train", "batch_per_stream": TRAIN_BATCH, "steps": 3,
          "metrics": metrics, "launches_per_step": per_step,
          "expected_per_step": expected, "launches": total, **checks})
    if not (checks["finite"] and checks["trainables_moved"] > 0
            and checks["ema_moved"] > 0 and checks["frozen_unchanged"]):
        raise AssertionError(f"train steps failed their checks: {checks}")
    if any(step != expected for step in per_step):
        raise AssertionError(f"launches per train step {per_step}, expected {expected}")
    return state, batch, total


def phase_train_e2e(torch, state, batch, device, launches: Launches):
    """One step from the same state and draws, kernels vs plain versions."""
    from mdt_policy_tpu_torch.agents import make_draws, train_step
    twin = copy.deepcopy(state)
    cfg = state.net.cfg

    def step(s):
        gen = torch.Generator(device).manual_seed(8)
        draws = {k: make_draws(cfg, TRAIN_BATCH, gen) for k in sorted(batch)}
        m = train_step(s, batch, draws=draws)
        return {k: float(v) for k, v in m.items()}

    kernel = step(state)
    before = launches.read()
    with plain_kernels():
        plain = step(twin)
    if launches.read() != before:
        raise AssertionError("the plain train step launched a kernel")
    keys = [k for k in kernel if k.endswith("_loss") or k == "train/grad_norm"]
    rel = {k: abs(kernel[k] - plain[k]) / max(1.0, abs(plain[k])) for k in keys}
    row = {"phase": "train_e2e", "kernel": {k: kernel[k] for k in keys},
           "plain": {k: plain[k] for k in keys}, "max_rel_err": max(rel.values()),
           "worst": max(rel, key=rel.get), "bound": TRAIN_E2E_REL_TOL}
    emit(row)
    del twin
    if not row["max_rel_err"] <= TRAIN_E2E_REL_TOL:
        raise AssertionError(f"kernel and plain train steps disagree: {row}")
    return row


def _device_events(torch, prof):
    """Work on the card: kernels, copies and sets, without the ranges that
    `record_function` annotations (such as Optimizer.step) mirror there."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]


def profile_calls(torch, fn, n: int):
    """`n` calls of `fn` under torch.profiler: wall and device ms per call,
    device events (kernels, copies, sets) per call, the device's busy share,
    B1's and B3's shares of the device time, and the costliest kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(torch, prof)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    share = lambda key: sum(v for k, v in by_name.items() if key in k) / max(device_ms, 1e-9)
    return {"calls": n, "wall_ms_per_call": wall_ms / n,
            "device_ms_per_call": device_ms / n,
            "device_events_per_call": len(events) / n,
            "busy_share": device_ms / wall_ms,
            "b1_share": share("fused_qkv_attention_kernel"),
            "b3_share": share("fused_norm_kernel"),
            "top_kernels_ms_per_call": [[k[:90], v / n] for k, v in top]}


def phase_train_timing(torch, state, batch, device, smi):
    """Step time on the host clock (each step ends in a synchronize), after
    3 warm-up steps; then 2 steps under torch.profiler."""
    from mdt_policy_tpu_torch.agents import train_step
    gen = torch.Generator(device).manual_seed(9)
    for _ in range(3):
        train_step(state, batch, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_STEPS_TIMED):
        t0 = time.perf_counter()
        train_step(state, batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.percentile(times, 50))
    row = {"phase": "train_timing", "batch_per_stream": TRAIN_BATCH,
           "steps": len(times), "step_ms_p50": p50,
           "step_ms_p90": float(np.percentile(times, 90)),
           "step_ms_min": min(times), "step_ms_max": max(times),
           "chunks_per_s": 2 * TRAIN_BATCH / (p50 / 1e3),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": smi}
    emit(row)
    prof = profile_calls(torch, lambda: train_step(state, batch, generator=gen), 2)
    emit({"phase": "train_profile", **prof, "card": smi})
    return row


def kernel_entry(name, source, replaces, launches, rows, main):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            "dtype": main["dtype"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from mdt_policy_tpu_torch.agents import MDTVConfig
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    smi = phase_device(torch)
    phase_build()
    b1_rows = phase_kernel_b1(torch, device)
    b3_rows = phase_kernel_b3(torch, device)
    net = build_net(torch, MDTVConfig(), device)
    launches = Launches()
    replan_launches = phase_replan(torch, net, device, launches)
    phase_e2e(torch, net, device, launches)
    phase_timing(torch, net, device, smi)
    state, batch, train_launches = phase_train(torch, net, device, launches)
    phase_train_e2e(torch, state, batch, device, launches)
    phase_train_timing(torch, state, batch, device, smi)
    emit(summary(b1_rows, b3_rows, replan_launches, train_launches))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def summary(b1_rows, b3_rows, replan_launches, train_launches):
    """The kernels line: each kernel at its bf16 train-step shape, with its
    launches on both paths; fails if a path did not launch it."""

    def main_row(rows, kernel, shape):
        return next(r for r in rows if r["kernel"] == kernel and r["shape"] == shape
                    and r["dtype"] == "bfloat16")

    entries = []
    for name, source, replaces, rows, shape in (
            ("fused_qkv_attention", "fused_qkv_attention.cu",
             "mdt_policy_tpu/ops/fused_qkv_attention.py:124", b1_rows, "voltron_train"),
            ("fused_layer_norm", "fused_norm.cu", "mdt_policy_tpu/ops/fused_norm.py:134",
             b3_rows, "clip_vision_train"),
            ("fused_rms_norm", "fused_norm.cu", "mdt_policy_tpu/ops/fused_norm.py:159",
             b3_rows, "voltron_train")):
        mine = [r for r in rows if r["kernel"] == name]
        entry = kernel_entry(name, f"mdt_policy_tpu_torch/csrc/{source}", replaces,
                             replan_launches[name] + train_launches[name], mine,
                             main_row(mine, name, shape))
        entry["launches_replan"] = replan_launches[name]
        entry["launches_train"] = train_launches[name]
        if entry["launches_replan"] == 0 or entry["launches_train"] == 0:
            raise AssertionError(f"{name} was not launched on a path: {entry}")
        entries.append(entry)
    return {"kernels": entries}


if __name__ == "__main__":
    sys.exit(main())
