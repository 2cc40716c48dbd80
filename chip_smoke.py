#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mdt_policy_tpu_torch`) on one GPU.

    python3 chip_smoke.py        # from the root of the repository

Drives the port's main path, one MDT-V closed-loop replan at the production
width (`MDTVConfig()`, seeded random weights), through `MDTVPolicy`, and
prints one JSON line per phase:

  1. device   card name and power limit (nvidia-smi); TF32 off.
  2. build    nvcc build of every kernel of the path, in seconds.
  3. kernel   each kernel against its plain PyTorch version on the card, at
              the shapes of the path, in bf16 and f32, with CUDA-event times.
  4. replan   reset() and 20 step() calls at B=1; B1 launch counts must be
              exactly 24 on the first replan and 12 on the second.
  5. e2e      the same replan through the kernel and through the plain
              attention: the (1, 10, 7) chunks must agree.
  6. timing   replan p50/p90 at B=1 and B=32, goal-encode time.

Then the kernel summary line, and last `{"ok": true, "device": ...}`. Any
failure raises and exits non-zero; without a CUDA device it exits 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# (name, B, T, C, H, causal): the path's shapes, plus the training batch and
# the CLIP vision tower (odd T) that later slices run
KERNEL_SHAPES = (
    ("voltron", 2, 196, 384, 6, False),
    ("voltron_batch", 1024, 196, 384, 6, False),
    ("clip_text", 1, 77, 512, 8, True),
    ("clip_vision", 2, 197, 768, 12, False),
)
# |kernel - plain| bounds. f32: both accumulate in f32 and differ only in
# summation order (~1e-6). bf16: the output is rounded to bf16 (8 significant
# bits, 3.9e-3 relative on values of order 1), and a probability can round
# to the neighbouring bf16 value when the two f32 scores differ in the last bit.
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# Bound on the replan chunk, kernel path vs plain path, relative to
# max(1, max|chunk|): the towers are bf16, so a one-ulp difference in a token
# (3.9e-3 relative) can propagate through the perceiver into the f32 denoiser.
E2E_REL_TOL = 2e-2
REPLANS_TIMED = 100


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
    from mdt_policy_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library("fused_qkv_attention")
    seconds = time.perf_counter() - t0
    emit({"phase": "build", "kernel": "fused_qkv_attention", "seconds": seconds})
    return seconds


def phase_kernel(torch, device):
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
            row = {"phase": "kernel", "kernel": "fused_qkv_attention",
                   "shape": name, "qkv": [B, T, 3 * C], "heads": H,
                   "causal": causal, "dtype": dtype_name, "max_abs_err": err,
                   "tol": KERNEL_TOL[dtype_name], "ms": ms, "plain_ms": plain_ms}
            emit(row)
            if not err <= KERNEL_TOL[dtype_name]:
                raise AssertionError(f"B1 disagrees with its plain version: {row}")
            rows.append(row)
    return rows


def make_inputs(torch, cfg, batch: int, seed: int, device):
    """Camera frames (B, 1, H, W, 3) and a 77-token goal whose EOT id is its
    largest, drawn from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    static = torch.randn((batch, 1, cfg.img_size, cfg.img_size, 3), generator=gen)
    gripper = torch.randn((batch, 1, 84, 84, 3), generator=gen)
    tokens = torch.zeros((batch, cfg.clip_context_length), dtype=torch.long)
    tokens[:, 0] = cfg.clip_vocab_size - 2  # start-of-text
    tokens[:, 1:9] = torch.randint(1, cfg.clip_vocab_size - 2, (batch, 8), generator=gen)
    tokens[:, 9] = cfg.clip_vocab_size - 1  # end-of-text, the largest id
    obs = {"rgb_static": static.to(device), "rgb_gripper": gripper.to(device)}
    return obs, {"lang_tokens": tokens.to(device)}


def build_net(torch, cfg, device):
    from mdt_policy_tpu_torch.agents import MDTVAgentNet, init_random_
    net = MDTVAgentNet(cfg, device=device)
    init_random_(net, torch.Generator().manual_seed(0))
    return net


def phase_replan(torch, net, device):
    """reset() and 20 step() calls at B=1, counting B1 launches per replan."""
    from mdt_policy_tpu_torch.agents import MDTVPolicy
    from mdt_policy_tpu_torch.ops.fused_qkv_attention import fused_qkv_attention
    obs, goal = make_inputs(torch, net.cfg, 1, seed=1, device=device)
    policy = MDTVPolicy(net, generator=torch.Generator(device).manual_seed(1))
    policy.reset()
    fused_qkv_attention.launches = 0
    per_replan, actions = [], []
    for step in range(20):
        before = fused_qkv_attention.launches
        action = policy.step(obs, goal)
        if step % net.cfg.multistep == 0:
            per_replan.append(fused_qkv_attention.launches - before)
        actions.append(action)
    torch.cuda.synchronize()
    launches = fused_qkv_attention.launches
    acts = torch.stack(actions)
    ok = all(tuple(a.shape) == (1, net.cfg.action_dim) for a in actions) \
        and bool(torch.isfinite(acts).all())
    emit({"phase": "replan", "steps": 20, "launches_per_replan": per_replan,
          "launches": launches, "actions_finite_and_shaped": ok,
          "first_action": actions[0].tolist()})
    if not ok:
        raise AssertionError("replan produced non-finite or misshaped actions")
    # Voltron blocks + causal text blocks on the first replan (24 at the
    # production config), then Voltron blocks only (the goal is cached)
    expected = [net.cfg.vit_depth + net.cfg.clip_text_layers, net.cfg.vit_depth]
    if per_replan != expected:
        raise AssertionError(f"B1 launches per replan {per_replan}, "
                             f"expected {expected}")
    return launches


def phase_e2e(torch, net, device):
    """One replan through the kernel and through the plain attention."""
    from mdt_policy_tpu_torch.agents import denoise_actions
    from mdt_policy_tpu_torch.models import clip, voltron_vit
    from mdt_policy_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention_reference)
    obs, goal = make_inputs(torch, net.cfg, 1, seed=2, device=device)
    noise = torch.randn((1, net.cfg.act_window_size, net.cfg.action_dim),
                        generator=torch.Generator().manual_seed(3)).to(device)

    def chunk():
        with torch.no_grad():
            emb = net.perceive(obs["rgb_static"], obs["rgb_gripper"])
            lang = net.encode_language_goal(goal["lang_tokens"])
            return denoise_actions(net, emb, lang, noise=noise)

    kernel_chunk = chunk()
    with mock.patch.object(voltron_vit, "fused_qkv_attention",
                           fused_qkv_attention_reference), \
            mock.patch.object(clip, "fused_qkv_attention",
                              fused_qkv_attention_reference):
        plain_chunk = chunk()
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
    around policy.step() with the action fetched to the host."""
    from mdt_policy_tpu_torch.agents import MDTVPolicy
    obs, goal = make_inputs(torch, net.cfg, batch, seed=4, device=device)
    policy = MDTVPolicy(net, generator=torch.Generator(device).manual_seed(5))
    policy.step(obs, goal)  # encodes and caches the goal
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for i in range(3 + REPLANS_TIMED):
        policy.rollout_step_counter = 0  # the next step replans
        torch.cuda.synchronize()
        start.record()
        policy.step(obs, goal).cpu()
        end.record()
        torch.cuda.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    encode_ms = event_ms(lambda: net.encode_language_goal(goal["lang_tokens"]),
                         20, torch)
    return times, encode_ms


def phase_timing(torch, net, device, smi):
    rows = {}
    for batch in (1, 32):
        torch.cuda.reset_peak_memory_stats()
        times, encode_ms = time_replans(torch, net, batch, device)
        row = {"phase": "timing", "batch": batch, "replans": len(times),
               "replan_ms_p50": float(np.percentile(times, 50)),
               "replan_ms_p90": float(np.percentile(times, 90)),
               "replan_ms_min": min(times), "replan_ms_max": max(times),
               "goal_encode_ms": encode_ms,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "card": smi}
        emit(row)
        rows[batch] = row
    return rows


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
    kernel_rows = phase_kernel(torch, device)
    net = build_net(torch, MDTVConfig(), device)
    launches = phase_replan(torch, net, device)
    phase_e2e(torch, net, device)
    phase_timing(torch, net, device, smi)

    main_shape = next(r for r in kernel_rows
                      if r["shape"] == "voltron" and r["dtype"] == "bfloat16")
    emit({"kernels": [{
        "name": "fused_qkv_attention", "route": "cuda",
        "source": "mdt_policy_tpu_torch/csrc/fused_qkv_attention.cu",
        "replaces": "mdt_policy_tpu/ops/fused_qkv_attention.py:124",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
