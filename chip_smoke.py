#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mdt_policy_tpu_torch`) on one GPU.

    python3 chip_smoke.py        # from the root of the repository

Drives the port's paths at the production widths (`MDTVConfig()` and
`MDTConfig()`, seeded random weights): the MDT-V and the MDT closed-loop
replans through `MDTVPolicy` (alias `MDTPolicy`), CALVIN's chain evaluation
on the fake env through `evaluate_policy` and `evaluate_policy_batched`
for both, the dual-modality train step through `train_step` at B=128 per
stream, the frozen-tower embedding extraction through `extract_embeddings`
and `extract_lang_goals` over a synthetic split, and the cache-mode train
step from the rows it wrote. Prints one JSON line per phase:

  1. device   card name and power limit (nvidia-smi); TF32 off for f32
              matmuls and convolutions.
  2. build    nvcc of every kernel source, all started together, in seconds.
  3. kernel   B1, B3 and B2 against their plain PyTorch versions on the card
              at the paths' shapes, bf16 and f32, with CUDA-event times of
              the kernel, the plain version and the PyTorch library call,
              the kernel's device time from the profiler (`device_ms`), and
              the least time the card could take (`bound_ms`); B2 at the
              replans' shapes at B=1 and B=32 and the four of the JAX
              package's ops/bench_pallas.py. Then B4 and B5 (the attention
              and MLP half-blocks) at the extraction's six shapes against
              their plain versions in bf16 and in float64, with the kernel,
              device, plain and unfused route (B3 + F.linear + B1 or the
              activation + F.linear) times; device kernels per call must be
              3 (B4) and 2 (B5).
  4. replan   MDT-V: reset() and 20 step() calls at B=1; per replan B1 24
              then 12, B3 50 then 25, B2 44 and 44 (4 encoder blocks + 4
              decoder blocks x 10 DDIM steps).
  5. e2e      the same replan through the kernels and through the plain
              versions: the (1, 10, 7) chunks must agree.
  6. timing   replan p50/p90 at B=1 and B=32, goal-encode time; then 5
              replans under the profiler (device events and busy share).
  7. b2_ab    MDT-V replan p50/p90 at B=1 and B=32 with B2 and with B2
              swapped alone for `sdpa`, in turns (B2, sdpa, sdpa, B2).
  8. replan, e2e, timing  the same three for MDT: B1 12 then 0, B3 25 then
              0, B2 64 and 64 (4 + 6 x 10) per replan.
  9. rollout  per family, `evaluate_policy` over 4 chains (200 px static,
              84 px gripper frames, episodes of 360 steps) through
              `make_rollout_policy`, a scripted oracle solving every task at
              25 steps but one that never solves: results, env steps and
              replans per chain must follow from that rule, actions finite;
              env steps/s and replans/s. Then `evaluate_policy_batched`
              over 32 fake envs and 32 chains, one B=32 replan per policy
              call: results and policy calls by the same rule.
 10. train    3 train steps at B=128 per stream: finite losses and
              grad_norm, trainables and EMA moved, frozen towers not; per
              step 60 B1, 157 B3 and 0 B2 launches (dropout is on).
 11. train_e2e  one step from the same state and draws through the kernels
              and through the plain versions: losses and grad_norm agree.
 12. train_timing  step ms p50/p90 over 10 steps after 3 warm-up steps,
              chunks/s, peak memory; then a profiled window of 2 steps.
 13. extract  512 synthetic frames (200 px static, 84 px gripper) at batch
              64 with one shift variant, and 512 annotation sentences: file
              layout, the bit-exact self-check, B4/B5 and B3 launches, the
              first batch against the B1 + B3 route; frames/s of both routes.
 14. cache_train  3 train steps at B=128 per stream from the written cache:
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
# (3.9e-3 relative) can propagate through the perceiver (MDT-V) or the goal
# embedding (both families) into the f32 denoiser, whose B2 differs from its
# plain version by summation order only.
E2E_REL_TOL = 2e-2
# Bound on the train step's losses and grad_norm, kernel path vs plain path,
# relative to max(1, |value|): the same bf16 one-ulp differences in the
# frozen towers' outputs, averaged over 128 samples per scope.
TRAIN_E2E_REL_TOL = 2e-2
REPLANS_TIMED = 100
REPLANS_AB = 25  # per turn of the B2 / sdpa A/B (4 turns)
# B2 (name, B, H, T, D, causal): the denoisers' self-attention at the
# replan's B=1 (MDT-V: 4-token encoder, 10-token causal decoder, D=48; MDT:
# 3-token encoder, causal decoder, D=64), the same at the batched rollout's
# B=32, and the four shapes of the JAX package's ops/bench_pallas.py
SMALL_SEQ_SHAPES = (
    ("mdtv_enc", 1, 8, 4, 48, False), ("mdtv_dec", 1, 8, 10, 48, True),
    ("mdt_enc", 1, 8, 3, 64, False), ("mdt_dec", 1, 8, 10, 64, True),
    ("mdtv_enc_b32", 32, 8, 4, 48, False), ("mdtv_dec_b32", 32, 8, 10, 48, True),
    ("mdt_enc_b32", 32, 8, 3, 64, False), ("mdt_dec_b32", 32, 8, 10, 64, True),
    ("bench_dec_T10", 1024, 8, 10, 48, True), ("bench_enc_T4", 1024, 8, 4, 48, False),
    ("bench_enc_T23", 1024, 8, 23, 48, False), ("bench_dec_T10_B4096", 4096, 8, 10, 48, True),
)
# rollout phase: CALVIN's camera sizes, chains and episode length, and the
# scripted oracle's step at which every task but one solves
ROLLOUT_CHAINS, ROLLOUT_EP_LEN, ROLLOUT_SOLVE_AT = 4, 360, 25
BATCHED_ENVS = 32
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


def small_seq_bound(dtype_name: str, ref, v) -> float:
    """|B2 - plain| bound. f32: summation order only, 1e-5 relative to
    max(1, max|ref|). bf16: one bf16 ulp of the largest output (2^-7
    relative at the top of its binade) plus one flipped rounding of a
    probability (2^-8) times the largest |v|."""
    amax = max(1.0, ref.float().abs().max().item())
    if dtype_name == "float32":
        return 1e-5 * amax
    return 2.0 ** -7 * amax + 2.0 ** -8 * v.float().abs().max().item()


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


def phase_kernel_b2(torch, device):
    """B2 against its plain version on the transposed (B, T, H, D) views the
    denoisers pass, at SMALL_SEQ_SHAPES in f32 and bf16, with the times of
    the kernel, its device kernel, the plain version and
    F.scaled_dot_product_attention."""
    import torch.nn.functional as F
    from mdt_policy_tpu_torch.ops.small_seq_mha import small_seq_mha, small_seq_mha_reference
    gen = torch.Generator(device).manual_seed(2)
    rows = []
    for name, B, H, T, D, causal in SMALL_SEQ_SHAPES:
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            q, k, v = (torch.randn((B, T, H, D), generator=gen, device=device).to(dtype)
                       .transpose(1, 2) for _ in range(3))
            out = small_seq_mha(q, k, v, causal)
            ref = small_seq_mha_reference(q, k, v, causal)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            bound = small_seq_bound(dtype_name, ref, v)
            iters = 50 if B >= 1024 else 200
            pairs = T * (T + 1) // 2 if causal else T * T
            bms, by = bound_ms(4 * q.numel() * q.element_size(), 4 * B * H * pairs * D,
                               dtype_name)
            row = {"phase": "kernel", "kernel": "small_seq_mha", "shape": name,
                   "q": [B, H, T, D], "causal": causal, "dtype": dtype_name,
                   "max_abs_err": err, "bound": bound,
                   "ms": event_ms(lambda: small_seq_mha(q, k, v, causal), iters, torch),
                   "device_ms": device_ms(lambda: small_seq_mha(q, k, v, causal),
                                          "small_seq_mha_kernel", 20, torch),
                   "plain_ms": event_ms(lambda: small_seq_mha_reference(q, k, v, causal),
                                        iters, torch),
                   "library_ms": event_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=causal), iters, torch),
                   "bound_ms": bms, "bound_by": by}
            emit(row)
            if not err <= bound:
                raise AssertionError(f"B2 disagrees with its plain version: {row}")
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
    """The agent of `cfg`'s family (MDTConfig: MDT, else MDT-V) with seeded
    random weights."""
    from mdt_policy_tpu_torch.agents import (MDTAgentNet, MDTConfig, MDTVAgentNet,
                                             init_random_)
    net = (MDTAgentNet if isinstance(cfg, MDTConfig) else MDTVAgentNet)(cfg, device=device)
    init_random_(net, torch.Generator().manual_seed(0))
    return net


class Launches:
    """The kernels' launch counters: reset, read."""

    def __init__(self):
        from mdt_policy_tpu_torch.ops.attention_halfblock import attention_halfblock
        from mdt_policy_tpu_torch.ops.fused_norm import fused_layer_norm, fused_rms_norm
        from mdt_policy_tpu_torch.ops.fused_qkv_attention import fused_qkv_attention
        from mdt_policy_tpu_torch.ops.mlp_halfblock import mlp_halfblock
        from mdt_policy_tpu_torch.ops.small_seq_mha import small_seq_mha
        self.fns = {"fused_qkv_attention": fused_qkv_attention,
                    "fused_layer_norm": fused_layer_norm,
                    "fused_rms_norm": fused_rms_norm,
                    "attention_halfblock": attention_halfblock,
                    "mlp_halfblock": mlp_halfblock,
                    "small_seq_mha": small_seq_mha}

    def reset(self):
        for fn in self.fns.values():
            fn.launches = 0

    def read(self):
        return {name: fn.launches for name, fn in self.fns.items()}


def b2_per_replan(cfg):
    """Self-attentions of one replan: each encoder block once, each decoder
    block at every step of the sampler (len(schedule) - 1 denoiser calls)."""
    from mdt_policy_tpu_torch.diffusion import get_noise_schedule
    steps = len(get_noise_schedule(cfg.num_sampling_steps, cfg.noise_scheduler,
                                   cfg.sigma_min, cfg.sigma_max)) - 1
    return cfg.n_enc_layers + cfg.n_dec_layers * steps


def expected_replan_launches(cfg, family: str):
    """Launches of the first replan (the text goal encoded) and of a later
    one (the goal cached). B1 one per Voltron block (MDT-V) and per causal
    text block; B3 two RMSNorms per Voltron block and its encoder_norm
    (MDT-V), two LayerNorms per text block and ln_final; B2 at every
    self-attention of the denoiser. MDT's ResNets and GroupNorms run no
    kernel of the port."""
    camera = {"fused_qkv_attention": cfg.vit_depth, "fused_layer_norm": 1,
              "fused_rms_norm": 2 * cfg.vit_depth} if family == "mdtv" else \
        {"fused_qkv_attention": 0, "fused_layer_norm": 0, "fused_rms_norm": 0}
    text = {"fused_qkv_attention": cfg.clip_text_layers,
            "fused_layer_norm": 2 * cfg.clip_text_layers + 1, "fused_rms_norm": 0}
    rest = {**NO_HALFBLOCKS, "small_seq_mha": b2_per_replan(cfg)}
    return [{**{k: camera[k] + text[k] for k in camera}, **rest}, {**camera, **rest}]


def phase_replan(torch, net, device, launches: Launches, family: str):
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
    expected = expected_replan_launches(cfg, family)
    emit({"phase": "replan", "family": family, "steps": 20,
          "launches_per_replan": per_replan, "expected_per_replan": expected,
          "b1_per_replan": [r["fused_qkv_attention"] for r in per_replan],
          "b3_per_replan": b3, "b2_per_replan": [r["small_seq_mha"] for r in per_replan],
          "launches": total, "actions_finite_and_shaped": ok,
          "first_action": actions[0].tolist()})
    if not ok:
        raise AssertionError("replan produced non-finite or misshaped actions")
    if per_replan != expected:
        raise AssertionError(f"{family} launches per replan {per_replan}, expected {expected}")
    return total


NO_HALFBLOCKS = {"attention_halfblock": 0, "mlp_halfblock": 0}
NO_DENOISER = {"small_seq_mha": 0}


def plain_kernels():
    """Patches every kernel call site with the kernel's plain version."""
    from mdt_policy_tpu_torch.models import blocks, clip, voltron_vit
    from mdt_policy_tpu_torch.ops.fused_norm import (fused_layer_norm_reference,
                                                     fused_rms_norm_reference)
    from mdt_policy_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention_reference)
    from mdt_policy_tpu_torch.ops.small_seq_mha import small_seq_mha_reference
    patches = [mock.patch.object(blocks, "small_seq_mha", small_seq_mha_reference),
               mock.patch.object(voltron_vit, "fused_qkv_attention",
                                 fused_qkv_attention_reference),
               mock.patch.object(clip, "fused_qkv_attention",
                                 fused_qkv_attention_reference),
               mock.patch.object(blocks, "fused_layer_norm", fused_layer_norm_reference),
               mock.patch.object(blocks, "fused_rms_norm", fused_rms_norm_reference)]
    stack = contextlib.ExitStack()
    for p in patches:
        stack.enter_context(p)
    return stack


def b2_as_sdpa():
    """Swaps kernel B2 alone for the plain `sdpa` route the denoisers took
    before it (the route of the A/B timing)."""
    from mdt_policy_tpu_torch.models import blocks
    return mock.patch.object(blocks, "small_seq_mha",
                             lambda q, k, v, causal=False: blocks.sdpa(q, k, v, causal=causal))


def phase_e2e(torch, net, device, launches: Launches, family: str):
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
    row = {"phase": "e2e", "family": family, "chunk_shape": list(kernel_chunk.shape),
           "max_abs_err": err, "max_abs_chunk": plain_chunk.abs().max().item(),
           "bound": E2E_REL_TOL * scale,
           "finite": bool(torch.isfinite(kernel_chunk).all())}
    emit(row)
    if not (row["finite"] and err <= row["bound"]):
        raise AssertionError(f"kernel path and plain path disagree: {row}")
    return err


def replanner(torch, net, batch: int, device, seed: int = 4):
    """A policy at `batch` parallel envs whose goal is encoded and cached,
    and a function that runs one replan and fetches the action to the host."""
    from mdt_policy_tpu_torch.agents import MDTVPolicy
    obs, goal = make_inputs(torch, net.cfg, batch, seed=seed, device=device)
    policy = MDTVPolicy(net, generator=torch.Generator(device).manual_seed(seed + 1))
    policy.step(obs, goal)  # encodes and caches the goal

    def replan():
        policy.rollout_step_counter = 0  # the next step replans
        return policy.step(obs, goal).cpu()
    return replan, goal


def event_times(torch, fn, n: int, warmup: int = 3):
    """CUDA-event milliseconds of each of `n` calls of `fn`, after warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for i in range(warmup + n):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return times


def phase_timing(torch, net, device, smi, family: str):
    """Replan latency at B=1 and B=32 (goal cached): CUDA events around
    policy.step() with the action fetched to the host; the goal encode; then
    5 replans under torch.profiler."""
    rows = {}
    for batch in (1, 32):
        torch.cuda.reset_peak_memory_stats()
        replan, goal = replanner(torch, net, batch, device)
        times = event_times(torch, replan, REPLANS_TIMED)
        encode_ms = event_ms(lambda: net.encode_language_goal(goal["lang_tokens"]), 20, torch)
        row = {"phase": "timing", "family": family, "batch": batch, "replans": len(times),
               "replan_ms_p50": float(np.percentile(times, 50)),
               "replan_ms_p90": float(np.percentile(times, 90)),
               "replan_ms_min": min(times), "replan_ms_max": max(times),
               "goal_encode_ms": encode_ms,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": smi}
        emit(row)
        emit({"phase": "replan_profile", "family": family, "batch": batch,
              **profile_calls(torch, replan, 5), "card": smi})
        rows[batch] = row
    return rows


def phase_b2_ab(torch, net, device, smi):
    """MDT-V replan p50 with B2 routed and with B2 swapped alone for `sdpa`,
    in turns (B2, sdpa, sdpa, B2) of REPLANS_AB replans each, at B=1 and
    B=32; device events per replan of both routes from the profiler."""
    rows = []
    for batch in (1, 32):
        replan, _ = replanner(torch, net, batch, device, seed=20)
        times = {"b2": [], "sdpa": []}
        for route in ("b2", "sdpa", "sdpa", "b2"):
            with b2_as_sdpa() if route == "sdpa" else contextlib.nullcontext():
                times[route] += event_times(torch, replan, REPLANS_AB)
        with b2_as_sdpa():
            sdpa_prof = profile_calls(torch, replan, 3)
        b2_prof = profile_calls(torch, replan, 3)
        row = {"phase": "b2_ab", "family": "mdtv", "batch": batch,
               "replans_per_route": len(times["b2"]),
               **{f"replan_ms_p50_{r}": float(np.percentile(t, 50)) for r, t in times.items()},
               **{f"replan_ms_p90_{r}": float(np.percentile(t, 90)) for r, t in times.items()},
               "device_events_per_replan_b2": b2_prof["device_events_per_call"],
               "device_events_per_replan_sdpa": sdpa_prof["device_events_per_call"],
               "device_ms_per_replan_b2": b2_prof["device_ms_per_call"],
               "device_ms_per_replan_sdpa": sdpa_prof["device_ms_per_call"],
               "card": smi}
        emit(row)
        rows.append(row)
    return rows

def oracle_results(seqs, never):
    """Chain scores under the scripted oracle: every task solves
    ROLLOUT_SOLVE_AT steps into its rollout except `never`, so a chain
    scores the tasks before its first `never`."""
    return [next((j for j, t in enumerate(chain) if t == never), 5) for _, chain in seqs]


def expected_rollout(results, multistep: int):
    """Env steps and replans of each chain under that oracle: a solved task
    takes ROLLOUT_SOLVE_AT steps, the failed one the whole episode; a replan
    every `multistep` steps."""
    replans = lambda steps: -(-steps // multistep)
    steps = [ROLLOUT_SOLVE_AT * r + (ROLLOUT_EP_LEN if r < 5 else 0) for r in results]
    plans = [replans(ROLLOUT_SOLVE_AT) * r + (replans(ROLLOUT_EP_LEN) if r < 5 else 0)
             for r in results]
    return steps, plans


def expected_batched_replans(results, multistep: int):
    """Policy calls of one wave of the batched loop: per subtask position,
    the wave runs until its slowest live env is done."""
    calls = 0
    for j in range(5):
        live = [r for r in results if r >= j]
        if not live:
            break
        ticks = ROLLOUT_EP_LEN if any(r == j for r in live) else ROLLOUT_SOLVE_AT
        calls += -(-ticks // multistep)
    return calls


class WatchedPolicy:
    """A rollout policy that counts its steps and checks that every action
    is finite and (1, action_dim)."""

    def __init__(self, policy, action_dim: int):
        self.policy, self.action_dim = policy, action_dim
        self.steps, self.ok = 0, True

    def reset(self):
        self.policy.reset()

    def step(self, obs, goal):
        action = self.policy.step(obs, goal)
        self.steps += 1
        self.ok &= action.shape == (1, self.action_dim) and bool(np.isfinite(action).all())
        return action


def phase_rollout(torch, nets, device, launches: Launches, smi):
    """CALVIN's chain evaluation on the fake env at CALVIN's camera sizes
    (200 px static, 84 px gripper) for each agent family: `evaluate_policy`
    over ROLLOUT_CHAINS chains through `make_rollout_policy`, one chain at a
    time, then `evaluate_policy_batched` over BATCHED_ENVS envs and as many
    chains, one B=BATCHED_ENVS replan per policy call. The scripted oracle
    solves every task at ROLLOUT_SOLVE_AT steps except the third task of the
    first chain, which never solves; results, env steps and replans must be
    the ones that rule gives."""
    from mdt_policy_tpu_torch.evaluation import (BatchedPolicyAdapter, FakeEnv,
                                                 ScriptedOracle, TASKS, evaluate_policy,
                                                 evaluate_policy_batched, get_sequences,
                                                 make_batched_predict, make_rollout_policy)
    from mdt_policy_tpu_torch.evaluation.annotations import make_goal_fn
    never = get_sequences(ROLLOUT_CHAINS)[0][1][2]
    oracle = ScriptedOracle({t: ROLLOUT_SOLVE_AT for t in TASKS if t != never})
    launches.reset()
    rows = []
    for family, net in nets.items():
        cfg = net.cfg
        goal_fn = make_goal_fn(cfg.clip_context_length)
        env = FakeEnv(img_hw=200, gripper_hw=84, seed=0)
        policy = make_rollout_policy(net, generator=torch.Generator(device).manual_seed(30))
        watched = WatchedPolicy(policy, cfg.action_dim)
        want = oracle_results(get_sequences(ROLLOUT_CHAINS), never)
        want_steps, want_plans = expected_rollout(want, cfg.multistep)
        results, steps, plans = [], [], []
        t0 = time.perf_counter()
        with mock.patch.object(policy.inner, "plan", wraps=policy.inner.plan) as plan:
            for i in range(ROLLOUT_CHAINS):
                before_steps, before_plans = watched.steps, plan.call_count
                results += evaluate_policy(watched, env, oracle, goal_fn,
                                           num_sequences=ROLLOUT_CHAINS, ep_len=ROLLOUT_EP_LEN,
                                           sequence_indices=[i], progress=False)
                steps.append(watched.steps - before_steps)
                plans.append(plan.call_count - before_plans)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        serial = {"phase": "rollout", "family": family, "loop": "serial",
                  "chains": ROLLOUT_CHAINS, "ep_len": ROLLOUT_EP_LEN, "never_solves": never,
                  "results": results, "expected": want, "env_steps": steps,
                  "expected_env_steps": want_steps, "replans": plans,
                  "expected_replans": want_plans, "actions_ok": watched.ok,
                  "seconds": seconds, "env_steps_per_s": sum(steps) / seconds,
                  "replans_per_s": sum(plans) / seconds, "card": smi}
        emit(serial)
        if not (results == want and steps == want_steps and plans == want_plans
                and watched.ok):
            raise AssertionError(f"serial rollout disagrees with the oracle's rule: {serial}")

        calls = []
        predict = make_batched_predict(net, generator=torch.Generator(device).manual_seed(31))

        def counted(obs_batch, goals):
            chunks = predict(obs_batch, goals)
            calls.append(bool(np.isfinite(chunks).all()) and chunks.shape == (
                len(goals), cfg.act_window_size, cfg.action_dim))
            return chunks
        envs = [FakeEnv(img_hw=200, gripper_hw=84, seed=i) for i in range(BATCHED_ENVS)]
        want = oracle_results(get_sequences(BATCHED_ENVS), never)
        t0 = time.perf_counter()
        results = evaluate_policy_batched(
            BatchedPolicyAdapter(counted, multistep=cfg.multistep), envs, oracle, goal_fn,
            num_sequences=BATCHED_ENVS, ep_len=ROLLOUT_EP_LEN, progress=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        env_steps = sum(expected_rollout(want, cfg.multistep)[0])
        batched = {"phase": "rollout", "family": family, "loop": "batched",
                   "envs": BATCHED_ENVS, "chains": BATCHED_ENVS, "ep_len": ROLLOUT_EP_LEN,
                   "results": results, "expected": want, "policy_calls": len(calls),
                   "expected_policy_calls": expected_batched_replans(want, cfg.multistep),
                   "chunks_ok": all(calls), "env_steps": env_steps, "seconds": seconds,
                   "env_steps_per_s": env_steps / seconds,
                   "replans_per_s": BATCHED_ENVS * len(calls) / seconds, "card": smi}
        emit(batched)
        if not (results == want and batched["chunks_ok"]
                and len(calls) == batched["expected_policy_calls"]):
            raise AssertionError(f"batched rollout disagrees with the oracle's rule: {batched}")
        rows += [serial, batched]
    return launches.read(), rows


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
            + 2 * (2 * cfg.gen_decoder_depth + 1) + 2 * 2, **NO_HALFBLOCKS, **NO_DENOISER}


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
    the kernels' shares of the device time, and the costliest kernels."""
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
            "b2_share": share("small_seq_mha_kernel"),
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
                "mlp_halfblock": per_batch * fwd_calls + cfg.clip_text_layers,
                **NO_DENOISER}
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
            "fused_rms_norm": 2 * (2 * cfg.gen_decoder_depth + 1) + 2 * 2, **NO_HALFBLOCKS,
            **NO_DENOISER}


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
    from mdt_policy_tpu_torch.agents import MDTConfig, MDTVConfig
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    smi = phase_device(torch)
    phase_build()
    rows = {"b1": phase_kernel_b1(torch, device), "b3": phase_kernel_b3(torch, device),
            "b2": phase_kernel_b2(torch, device),
            "hb": phase_kernel_halfblocks(torch, device)}
    launches = Launches()
    net = build_net(torch, MDTVConfig(), device)
    paths = {"replan": phase_replan(torch, net, device, launches, "mdtv")}
    phase_e2e(torch, net, device, launches, "mdtv")
    phase_timing(torch, net, device, smi, "mdtv")
    phase_b2_ab(torch, net, device, smi)
    mdt = build_net(torch, MDTConfig(), device)
    paths["mdt_replan"] = phase_replan(torch, mdt, device, launches, "mdt")
    phase_e2e(torch, mdt, device, launches, "mdt")
    phase_timing(torch, mdt, device, smi, "mdt")
    paths["rollout"], _ = phase_rollout(torch, {"mdtv": net, "mdt": mdt}, device,
                                        launches, smi)
    del mdt
    torch.cuda.empty_cache()
    state, batch, paths["train"] = phase_train(torch, net, device, launches)
    phase_train_e2e(torch, state, batch, device, launches)
    phase_train_timing(torch, state, batch, device, smi)
    del state, batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        paths["extract"] = phase_extract(torch, net, device, launches, smi, root)
        paths["cache_train"] = phase_cache_train(torch, net, device, launches, smi,
                                                 os.path.join(root, "extracted"))
    emit(summary(rows, paths))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def summary(rows, paths):
    """The kernels line: each kernel at its main shape (bf16 for the towers'
    kernels, f32 for B2, whose path is the f32 denoiser), with its launches
    on each path; fails if a kernel was not launched on one of the paths it
    belongs to."""
    replans = ("replan", "mdt_replan", "rollout")
    entries = []
    for name, source, replaces, kind, shape, dtype, own in (
            ("fused_qkv_attention", "fused_qkv_attention.cu",
             "mdt_policy_tpu/ops/fused_qkv_attention.py:124", "b1", "voltron_train",
             "bfloat16", replans + ("train",)),
            ("fused_layer_norm", "fused_norm.cu", "mdt_policy_tpu/ops/fused_norm.py:134",
             "b3", "clip_vision_train", "bfloat16", replans + ("train", "extract")),
            ("fused_rms_norm", "fused_norm.cu", "mdt_policy_tpu/ops/fused_norm.py:159",
             "b3", "voltron_train", "bfloat16", ("replan", "rollout", "train", "cache_train")),
            ("small_seq_mha", "small_seq_mha.cu",
             "mdt_policy_tpu/ops/pallas_attention.py:77", "b2", "mdtv_dec_b32", "float32",
             replans),
            ("attention_halfblock", "attention_halfblock.cu",
             "mdt_policy_tpu/ops/attention_halfblock.py:145", "hb", "voltron", "bfloat16",
             ("extract",)),
            ("mlp_halfblock", "mlp_halfblock.cu", "mdt_policy_tpu/ops/mlp_halfblock.py:94",
             "hb", "voltron", "bfloat16", ("extract",))):
        mine = [r for r in rows[kind] if r["kernel"] == name]
        main = next(r for r in mine if r["shape"] == shape and r["dtype"] == dtype)
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
