#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mdt_policy_tpu_torch`) on one GPU.

    python3 chip_smoke.py        # from the root of the repository

Drives the port's four paths at the production width (`MDTVConfig()`,
seeded random weights): the MDT-V closed-loop replan through `MDTVPolicy`,
the dual-modality train step through `train_step` at B=128 per stream, the
frozen-tower embedding extraction through `extract_embeddings` and
`extract_lang_goals` over a synthetic split, and the cache-mode train step
from the rows it wrote. Prints one JSON line per phase:

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
 10. kernel   B4 and B5 (the attention and MLP half-blocks) at the
              extraction's six shapes against their plain versions in bf16
              and in float64, with the kernel, device, plain and unfused
              route (B3 + F.linear + B1 or the activation + F.linear) times;
              device kernels per call must be 3 (B4) and 2 (B5).
 11. extract  512 synthetic frames (200 px static, 84 px gripper) at batch
              64 with one shift variant, and 512 annotation sentences: file
              layout, the bit-exact self-check, B4/B5 and B3 launches, the
              first batch against the B1 + B3 route; frames/s of both routes.
 12. cache_train  3 train steps at B=128 per stream from the written cache:
              no tower kernel, B3 only at the decoder and the MAP head; one
              step kernels vs plain; one validation step; step times and a
              profiled window.

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
import tempfile
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
# B4/B5 (kernel, tower, B, T, C, heads or hidden width): extraction at batch
# 64 (Voltron 128 images: both cameras in one call; CLIP vision 64) and the
# text tower over 512 annotation sentences
HALFBLOCK_SHAPES = (
    ("b4", "voltron", 128, 196, 384, 6), ("b5", "voltron", 128, 196, 384, 1536),
    ("b4", "clip_vision", 64, 197, 768, 12), ("b5", "clip_vision", 64, 197, 768, 3072),
    ("b4", "clip_text", 512, 77, 512, 8), ("b5", "clip_text", 512, 77, 512, 2048),
)
# (norm, eps, LayerScale, causal, activation) of each tower's blocks
TOWER_BLOCKS = {"voltron": ("rms", 1e-8, True, False, "swishglu"),
                "clip_vision": ("ln", 1e-5, False, False, "quickgelu"),
                "clip_text": ("ln", 1e-5, False, True, "quickgelu")}
# device kernels per half-block call: B4 qkv GEMM, attention core, projection
# GEMM; B5 W1 GEMM, W2 GEMM
HALFBLOCK_KERNELS_PER_CALL = {"b4": 3, "b5": 2}
# B4/B5 bounds relative to max(1, max|ref|). Against the plain version in
# bf16, which rounds at the same points: two bf16 ulps (7.8e-3 each at the
# top of a binade: the output's own rounding and a flip of the branch before
# the residual add). Against float64 of the plain version from the same bf16
# inputs: the chain of bf16 roundings, 6.3e-3 at worst when the plain bf16
# version is held against float64 on the CPU at these widths, with 3x margin.
HALFBLOCK_TOL = {"plain": 1.6e-2, "float64": 2e-2}
EXTRACT_FRAMES = 512
EXTRACT_BATCH = 64  # extract_embeddings' default
EXTRACT_SENTENCES = 512
# Bound on the cached tokens and goal embeddings (B4 + B5 route) against the
# B1 + B3 route on the same frames, relative to max(1, max|ref|): the routes
# round at other points (B4/B5 divide by the RMS norm and multiply g in
# bf16, B3 rounds once; B4/B5 add the bias after rounding the product,
# cuBLAS before), a few bf16 ulps (3.9e-3 relative each) through 12 blocks;
# the bf16 tower bound of the port's CPU tests (5e-2).
EXTRACT_ROUTE_TOL = 5e-2


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


def device_ms(fn, kernel_name: str, iters: int, torch, per_call: bool = False):
    """Mean device time per launch of the kernels whose name holds
    `kernel_name`, from torch.profiler over `iters` calls: the kernel's own
    time, which the event times above hide where the host's per-call cost
    is the larger. None when the profiler records no such kernel. With
    `per_call`, (device ms per call, such kernels per call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in _device_events(torch, prof)
             if kernel_name in e.name]
    if per_call:
        return sum(times) / iters / 1e3, len(times) / iters
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
        from mdt_policy_tpu_torch.ops.attention_halfblock import attention_halfblock
        from mdt_policy_tpu_torch.ops.fused_norm import fused_layer_norm, fused_rms_norm
        from mdt_policy_tpu_torch.ops.fused_qkv_attention import fused_qkv_attention
        from mdt_policy_tpu_torch.ops.mlp_halfblock import mlp_halfblock
        self.fns = {"fused_qkv_attention": fused_qkv_attention,
                    "fused_layer_norm": fused_layer_norm,
                    "fused_rms_norm": fused_rms_norm,
                    "attention_halfblock": attention_halfblock,
                    "mlp_halfblock": mlp_halfblock}

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
                 "fused_layer_norm": 1 + text_ln, "fused_rms_norm": 2 * cfg.vit_depth,
                 **NO_HALFBLOCKS},
                {"fused_qkv_attention": cfg.vit_depth, "fused_layer_norm": 1,
                 "fused_rms_norm": 2 * cfg.vit_depth, **NO_HALFBLOCKS}]
    if per_replan != expected:
        raise AssertionError(f"launches per replan {per_replan}, expected {expected}")
    return total


NO_HALFBLOCKS = {"attention_halfblock": 0, "mlp_halfblock": 0}


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
            + 2 * (2 * cfg.gen_decoder_depth + 1) + 2 * 2, **NO_HALFBLOCKS}


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


def phase_train_e2e(torch, state, batch, device, launches: Launches,
                    phase: str = "train_e2e"):
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
    row = {"phase": phase, "kernel": {k: kernel[k] for k in keys},
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
            "b4_b5_share": share("halfblock_"),
            "top_kernels_ms_per_call": [[k[:90], v / n] for k, v in top]}


def phase_train_timing(torch, state, batch, device, smi, phase: str = "train_timing"):
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
    row = {"phase": phase, "batch_per_stream": TRAIN_BATCH,
           "steps": len(times), "step_ms_p50": p50,
           "step_ms_p90": float(np.percentile(times, 90)),
           "step_ms_min": min(times), "step_ms_max": max(times),
           "chunks_per_s": 2 * TRAIN_BATCH / (p50 / 1e3),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": smi}
    emit(row)
    prof = profile_calls(torch, lambda: train_step(state, batch, generator=gen), 2)
    emit({"phase": phase.replace("timing", "profile"), **prof, "card": smi})
    return row


def halfblock_inputs(torch, kernel, tower, B, T, C, n, device, seed=0):
    """bf16 inputs of one B4 or B5 call: x ~ N(0, 1), gains near 1, weights
    N(0, 1/fan_in), so that every stage is O(1); the weights are torch
    Linear weights (out, in). Returns (tensors, keyword arguments)."""
    norm, eps, has_gamma, causal, act = TOWER_BLOCKS[tower]
    gen = torch.Generator(device).manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).bfloat16()
    x, g = r(B, T, C), (1 + r(C, scale=0.1).float()).bfloat16()
    b = r(C, scale=0.1) if norm == "ln" else None
    gamma = r(C, scale=0.5) if has_gamma else None
    if kernel == "b4":
        return (x, g, b, r(3 * C, C, scale=C ** -0.5), r(3 * C, scale=0.02),
                r(C, C, scale=C ** -0.5), r(C, scale=0.02), gamma), \
            dict(n_heads=n, norm=norm, eps=eps, causal=causal)
    n1 = 2 * n if act == "swishglu" else n
    return (x, g, b, r(n1, C, scale=C ** -0.5), r(n1, scale=0.02),
            r(C, n, scale=n ** -0.5), r(C, scale=0.02), gamma), \
        dict(act=act, norm=norm, eps=eps)


def unfused_halfblock(torch, kernel, tensors, kw):
    """The port's B1 + B3 route for the same half-block: the B3 norm,
    F.linear, B1 or the activation, F.linear, * gamma, + x."""
    import torch.nn.functional as F
    from mdt_policy_tpu_torch.models.clip import quick_gelu
    from mdt_policy_tpu_torch.ops.fused_norm import fused_layer_norm, fused_rms_norm
    from mdt_policy_tpu_torch.ops.fused_qkv_attention import fused_qkv_attention
    x, g, b, w1, b1, w2, b2, gamma = tensors
    xn = fused_rms_norm(x, g, kw["eps"]) if kw["norm"] == "rms" \
        else fused_layer_norm(x, g, b, kw["eps"])
    h = F.linear(xn, w1, b1)
    if kernel == "b4":
        h = fused_qkv_attention(h, kw["n_heads"], kw["causal"])
    elif kw["act"] == "swishglu":
        proj, gate = h.chunk(2, dim=-1)
        h = proj * F.silu(gate)
    else:
        h = quick_gelu(h)
    y = F.linear(h, w2, b2)
    return x + (y * gamma if gamma is not None else y)


def halfblock_cost(kernel, tensors, kw):
    """(bytes, FLOP) of one call: every input read once and the output
    written once; B4 8*T*C^2 per image in its products plus 4*C per
    attended (query, key) pair (half the pairs when causal); B5
    2*T*C*(rows of W1 + H) per image."""
    x, w1, w2 = tensors[0], tensors[3], tensors[5]
    B, T, C = x.shape
    n_bytes = sum(t.numel() * t.element_size() for t in tensors if t is not None) \
        + x.numel() * x.element_size()
    if kernel == "b4":
        pairs = T * (T + 1) // 2 if kw["causal"] else T * T
        return n_bytes, 8 * B * T * C * C + 4 * B * pairs * C
    return n_bytes, 2 * B * T * C * (w1.shape[0] + w2.shape[1])


def phase_kernel_halfblocks(torch, device):
    """B4 and B5 against their plain versions (bf16) and float64 of the plain
    versions, at the extraction's shapes; times of the kernel, its device
    kernels, the plain version and the unfused B1 + B3 route."""
    from mdt_policy_tpu_torch.ops.attention_halfblock import (
        attention_halfblock, attention_halfblock_reference)
    from mdt_policy_tpu_torch.ops.mlp_halfblock import mlp_halfblock, mlp_halfblock_reference
    rows = []
    for kernel, tower, B, T, C, n in HALFBLOCK_SHAPES:
        tensors, kw = halfblock_inputs(torch, kernel, tower, B, T, C, n, device)
        fn, ref = (attention_halfblock, attention_halfblock_reference) if kernel == "b4" \
            else (mlp_halfblock, mlp_halfblock_reference)
        out = fn(*tensors, **kw)
        plain = ref(*tensors, **kw)
        f64 = ref(*(None if t is None else t.double() for t in tensors), **kw)
        torch.cuda.synchronize()
        errs, bounds = {}, {}
        for label, r in (("plain", plain), ("float64", f64)):
            errs[label] = (out.double() - r.double()).abs().max().item()
            bounds[label] = HALFBLOCK_TOL[label] * max(1.0, r.abs().max().item())
        del plain, f64
        iters = 20
        dev_ms, per_call = device_ms(lambda: fn(*tensors, **kw), "halfblock_", 5, torch,
                                     per_call=True)
        n_bytes, flops = halfblock_cost(kernel, tensors, kw)
        bms, by = bound_ms(n_bytes, flops, "bfloat16")
        row = {"phase": "kernel", "kernel": fn.__name__, "shape": tower,
               "x": [B, T, C], "width": n, **{k: v for k, v in kw.items() if k != "eps"},
               "dtype": "bfloat16", "max_abs_err": errs["plain"], "bound": bounds["plain"],
               "max_abs_err_float64": errs["float64"], "bound_float64": bounds["float64"],
               "ms": event_ms(lambda: fn(*tensors, **kw), iters, torch),
               "device_ms": dev_ms, "device_kernels_per_call": per_call,
               "plain_ms": event_ms(lambda: ref(*tensors, **kw), iters, torch),
               "unfused_ms": event_ms(lambda: unfused_halfblock(torch, kernel, tensors, kw),
                                      iters, torch),
               "library_ms": None, "bound_ms": bms, "bound_by": by,
               "flop": flops, "bytes": n_bytes}
        emit(row)
        if not (errs["plain"] <= bounds["plain"] and errs["float64"] <= bounds["float64"]):
            raise AssertionError(f"{fn.__name__} disagrees with its plain version: {row}")
        if per_call != HALFBLOCK_KERNELS_PER_CALL[kernel]:
            raise AssertionError(f"{fn.__name__} ran {per_call} device kernels per call, "
                                 f"expected {HALFBLOCK_KERNELS_PER_CALL[kernel]}")
        rows.append(row)
    return rows


def write_split(root, seed: int = 10):
    """A synthetic split at CALVIN's frame sizes: extracted uint8 frame
    arrays (200 px static, 84 px gripper), their row names, and annotation
    sentences, all from a seeded generator."""
    rng = np.random.default_rng(seed)
    ex = os.path.join(root, "extracted")
    os.makedirs(ex)
    np.save(os.path.join(ex, "ep_rgb_static.npy"),
            rng.integers(0, 256, (EXTRACT_FRAMES, 200, 200, 3), dtype=np.uint8))
    np.save(os.path.join(ex, "ep_rgb_gripper.npy"),
            rng.integers(0, 256, (EXTRACT_FRAMES, 84, 84, 3), dtype=np.uint8))
    with open(os.path.join(ex, "ep_npz_names.list"), "w") as f:
        f.write("".join(f"{i}\n" for i in range(EXTRACT_FRAMES)))
    verbs = ("open", "close", "push", "lift", "rotate", "slide", "place", "stack",
             "turn on", "turn off")
    things = ("the drawer", "the red block", "the blue block", "the pink block",
              "the switch", "the led light", "the door", "the light bulb")
    where = ("to the left", "to the right", "in the slider", "on top", "", "gently")
    texts = [" ".join(w for w in (verbs[rng.integers(len(verbs))],
                                  things[rng.integers(len(things))],
                                  where[rng.integers(len(where))]) if w)
             for _ in range(EXTRACT_SENTENCES)]
    lang = os.path.join(root, "lang_clip_resnet50")
    os.makedirs(lang)
    np.save(os.path.join(lang, "auto_lang_ann.npy"), {"language": {"ann": texts}},
            allow_pickle=True)
    return texts


def extract_forwards():
    """Tower forwards of one extraction run (extract_embeddings with one
    shift variant and its self-check of 2 batches): the clean and the
    augmented pass over every batch, and the recomputed batches."""
    n_batches = -(-EXTRACT_FRAMES // EXTRACT_BATCH)
    return 2 * n_batches + 2 * min(2, n_batches)


def phase_extract(torch, net, device, launches: Launches, smi, root):
    """extract_embeddings and extract_lang_goals at the production config:
    layout, self-check, launches, the B1 + B3 route on the first batch, and
    frames/s of both routes."""
    from mdt_policy_tpu_torch.data.extract_embeddings import (
        extract_embeddings, extract_lang_goals, load_embeddings, make_fwd)
    from mdt_policy_tpu_torch.utils.clip_tokenizer import tokenize
    cfg = net.cfg
    texts = write_split(root)
    out = os.path.join(root, "extracted")
    launches.reset()
    t0 = time.perf_counter()
    extract_embeddings(root, net, batch_size=EXTRACT_BATCH, aug_variants=1)
    extract_lang_goals(root, net, context_length=cfg.clip_context_length)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = launches.read()

    # the text tower encodes every sentence in one call
    fwd_calls = extract_forwards()
    per_batch = cfg.vit_depth + cfg.clip_vision_layers
    expected = {"fused_qkv_attention": 0, "fused_rms_norm": 0,
                # Voltron's encoder_norm, CLIP's ln_pre and ln_post; ln_final
                "fused_layer_norm": 3 * fwd_calls + 1,
                "attention_halfblock": per_batch * fwd_calls + cfg.clip_text_layers,
                "mlp_halfblock": per_batch * fwd_calls + cfg.clip_text_layers}
    n_tokens = 2 * (cfg.img_size // cfg.vit_patch) ** 2
    shapes = {"ep_voltron_tokens.npy": ((EXTRACT_FRAMES, n_tokens, cfg.perceiver_dim), "uint16"),
              "ep_clip_img_emb.npy": ((EXTRACT_FRAMES, cfg.clip_embed_dim), "float32"),
              "ep_voltron_tokens_aug.npy": ((EXTRACT_FRAMES, 1, n_tokens, cfg.perceiver_dim),
                                            "uint16"),
              "ep_clip_img_emb_aug.npy": ((EXTRACT_FRAMES, 1, cfg.clip_embed_dim), "float32"),
              "ep_lang_goal_emb.npy": ((EXTRACT_SENTENCES, cfg.clip_embed_dim), "float32")}
    files = {}
    for name, (shape, dtype) in shapes.items():
        a = np.load(os.path.join(out, name), mmap_mode="r")
        files[name] = {"shape": list(a.shape), "dtype": str(a.dtype),
                       "ok": tuple(a.shape) == shape and str(a.dtype) == dtype}
    tensors, meta = load_embeddings(out)
    finite = all(bool(torch.isfinite(t.float()).all()) for t in tensors.values())

    # the first batch through the B1 + B3 route, against the cache rows
    static = np.load(os.path.join(out, "ep_rgb_static.npy"), mmap_mode="r")
    gripper = np.load(os.path.join(out, "ep_rgb_gripper.npy"), mmap_mode="r")
    first = slice(0, EXTRACT_BATCH)
    before = launches.read()
    sizes = dict(static_size=cfg.img_size, gripper_size=min(84, cfg.img_size))
    tok, emb = make_fwd(net, **sizes, halfblocks=False)(static[first], gripper[first])
    lang = net.encode_language_goal(torch.from_numpy(
        tokenize(texts[:EXTRACT_BATCH], cfg.clip_context_length)).long().to(device))
    torch.cuda.synchronize()
    if launches.read()["attention_halfblock"] != before["attention_halfblock"]:
        raise AssertionError("the B1 + B3 route launched a half-block")
    route = {}
    for key, mine, ref in (("voltron_tokens", tensors["voltron_tokens"][first], tok),
                           ("image_latent_goal", tensors["image_latent_goal"][first], emb),
                           ("lang_latent_goal", tensors["lang_latent_goal"][first], lang)):
        err = (mine.to(device).float() - ref.float()).abs().max().item()
        bound = EXTRACT_ROUTE_TOL * max(1.0, ref.float().abs().max().item())
        route[key] = {"max_abs_err": err, "bound": bound}

    # frames/s of both routes on the same frames: clean pass only, no
    # self-check, in turns (B4/B5, B1/B3, B1/B3, B4/B5)
    timed = {"halfblocks": [], "b1_b3": []}
    for halfblocks in (True, False, False, True):
        t1 = time.perf_counter()
        extract_embeddings(root, net, batch_size=EXTRACT_BATCH, self_check=0,
                           out_dir=os.path.join(root, "timed"), halfblocks=halfblocks)
        torch.cuda.synchronize()
        timed["halfblocks" if halfblocks else "b1_b3"].append(
            EXTRACT_FRAMES / (time.perf_counter() - t1))
    profiles = {}
    for name, halfblocks in (("halfblocks", True), ("b1_b3", False)):
        fwd = make_fwd(net, **sizes, halfblocks=halfblocks)
        profiles[name] = profile_calls(torch, lambda: fwd(static[first], gripper[first]), 2)
    row = {"phase": "extract", "frames": EXTRACT_FRAMES, "batch": EXTRACT_BATCH,
           "sentences": EXTRACT_SENTENCES, "aug_variants": 1, "seconds": seconds,
           "tower_forwards": fwd_calls, "launches": total, "expected": expected,
           "files": files, "meta_keys": sorted(meta), "finite": finite,
           "route_vs_b1_b3": route,
           "frames_per_s": {k: v for k, v in timed.items()},
           "frames_per_s_mean": {k: float(np.mean(v)) for k, v in timed.items()},
           "card": smi}
    emit(row)
    for name, prof in profiles.items():
        emit({"phase": "extract_profile", "route": name, "batch": EXTRACT_BATCH, **prof,
              "card": smi})
    if total != expected:
        raise AssertionError(f"extraction launches {total}, expected {expected}")
    if not (finite and all(f["ok"] for f in files.values())):
        raise AssertionError(f"extraction wrote a bad cache: {files}, finite={finite}")
    if any(r["max_abs_err"] > r["bound"] for r in route.values()):
        raise AssertionError(f"the cache disagrees with the B1 + B3 route: {route}")
    return total


def make_cache_batch(torch, cfg, batch: int, out, device):
    """A dual-scope cache batch from the written cache: the vis scope takes
    frame rows [0, B), the lang scope [B, 2B) and annotation rows [0, B);
    foresight frames and actions are synthetic."""
    from mdt_policy_tpu_torch.data.extract_embeddings import load_embeddings
    gen = torch.Generator(device).manual_seed(11)
    g = cfg.gen_img_res

    def scope(lo):
        tensors, _ = load_embeddings(out, rows=np.arange(lo, lo + batch))
        return {"voltron_tokens": tensors["voltron_tokens"].to(device),
                "image_latent_goal": tensors["image_latent_goal"].to(device),
                "lang_latent_goal": tensors["lang_latent_goal"][:batch].to(device),
                "gen_static": torch.randn((batch, g, g, 3), generator=gen, device=device),
                "gen_gripper": torch.randn((batch, g, g, 3), generator=gen, device=device),
                "actions": torch.randn((batch, cfg.act_window_size, cfg.action_dim),
                                       generator=gen, device=device)}
    return {"vis": scope(0), "lang": scope(batch)}


def expected_cache_train_launches(cfg):
    """Per cache-mode step: no tower kernel; B3 RMSNorm in the foresight
    decoder's blocks and decoder_norm (each scope) and the MAP head's two
    norms (twice, lang scope)."""
    return {"fused_qkv_attention": 0, "fused_layer_norm": 0,
            "fused_rms_norm": 2 * (2 * cfg.gen_decoder_depth + 1) + 2 * 2, **NO_HALFBLOCKS}


def phase_cache_train(torch, net, device, launches: Launches, smi, out):
    """3 cache-mode train steps at B=128 per stream, counting launches per
    step; then kernels vs plain, a validation step, and the step's times."""
    from mdt_policy_tpu_torch.agents import init_train_state, train_step, validation_step
    cfg = net.cfg
    batch = make_cache_batch(torch, cfg, TRAIN_BATCH, out, device)
    state = init_train_state(net)
    gen = torch.Generator(device).manual_seed(12)
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
    expected = expected_cache_train_launches(cfg)
    emit({"phase": "cache_train", "batch_per_stream": TRAIN_BATCH, "steps": 3,
          "metrics": metrics, "launches_per_step": per_step,
          "expected_per_step": expected, "launches": total, **checks})
    if not (checks["finite"] and checks["trainables_moved"] > 0
            and checks["ema_moved"] > 0 and checks["frozen_unchanged"]):
        raise AssertionError(f"cache-mode steps failed their checks: {checks}")
    if any(step != expected for step in per_step):
        raise AssertionError(f"launches per cache-mode step {per_step}, expected {expected}")
    phase_train_e2e(torch, state, batch, device, launches, phase="cache_train_e2e")
    val = {k: float(v) for k, v in validation_step(
        net, batch, generator=torch.Generator(device).manual_seed(13)).items()}
    emit({"phase": "cache_validation", "metrics": val})
    if not all(np.isfinite(v) for v in val.values()):
        raise AssertionError(f"cache-mode validation step not finite: {val}")
    phase_train_timing(torch, state, batch, device, smi, phase="cache_train_timing")
    return total


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
    hb_rows = phase_kernel_halfblocks(torch, device)
    net = build_net(torch, MDTVConfig(), device)
    launches = Launches()
    paths = {"replan": phase_replan(torch, net, device, launches)}
    phase_e2e(torch, net, device, launches)
    phase_timing(torch, net, device, smi)
    state, batch, paths["train"] = phase_train(torch, net, device, launches)
    phase_train_e2e(torch, state, batch, device, launches)
    phase_train_timing(torch, state, batch, device, smi)
    del state, batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        paths["extract"] = phase_extract(torch, net, device, launches, smi, root)
        paths["cache_train"] = phase_cache_train(torch, net, device, launches, smi,
                                                 os.path.join(root, "extracted"))
    emit(summary(b1_rows, b3_rows, hb_rows, paths))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def summary(b1_rows, b3_rows, hb_rows, paths):
    """The kernels line: each kernel at its main bf16 shape, with its
    launches on each path; fails if a kernel was not launched on one of the
    paths it belongs to."""

    def main_row(rows, kernel, shape):
        return next(r for r in rows if r["kernel"] == kernel and r["shape"] == shape
                    and r["dtype"] == "bfloat16")

    entries = []
    for name, source, replaces, rows, shape, own in (
            ("fused_qkv_attention", "fused_qkv_attention.cu",
             "mdt_policy_tpu/ops/fused_qkv_attention.py:124", b1_rows, "voltron_train",
             ("replan", "train")),
            ("fused_layer_norm", "fused_norm.cu", "mdt_policy_tpu/ops/fused_norm.py:134",
             b3_rows, "clip_vision_train", ("replan", "train", "extract")),
            ("fused_rms_norm", "fused_norm.cu", "mdt_policy_tpu/ops/fused_norm.py:159",
             b3_rows, "voltron_train", ("replan", "train", "cache_train")),
            ("attention_halfblock", "attention_halfblock.cu",
             "mdt_policy_tpu/ops/attention_halfblock.py:145", hb_rows, "voltron", ("extract",)),
            ("mlp_halfblock", "mlp_halfblock.cu", "mdt_policy_tpu/ops/mlp_halfblock.py:94",
             hb_rows, "voltron", ("extract",))):
        mine = [r for r in rows if r["kernel"] == name]
        main = main_row(mine, name, shape)
        entry = kernel_entry(name, f"mdt_policy_tpu_torch/csrc/{source}", replaces,
                             sum(p[name] for p in paths.values()), mine, main)
        if "unfused_ms" in main:
            entry["unfused_ms"] = main["unfused_ms"]
        entry["paths"] = list(own)
        for path, counts in paths.items():
            entry[f"launches_{path}"] = counts[name]
        if any(entry[f"launches_{path}"] == 0 for path in own):
            raise AssertionError(f"{name} was not launched on one of its paths: {entry}")
        entries.append(entry)
    return {"kernels": entries}


if __name__ == "__main__":
    sys.exit(main())
