"""Chained fetch-barrier timing, and the loop of the attention microbenches.

`chain_bench` is the port's copy of the JAX repository's
`tools/perf_probe.py::chain_bench`: every timed loop is chained (call i + 1
takes a scalar of call i's output) and ends in a fetch to the host, so
neither asynchronous dispatch nor an early return can shorten it. It times
with CUDA events on the card. On the CPU it runs the same calls and times
nothing: a CPU run says nothing about the card.

`bench_variants` is the body shared by `attn_kernel_experiment.run` and
`attn_kernel_round3.run`: per tower shape, each attention variant's parity
against the plain einsum attention (B1's plain version) and its 12-layer
chain time, with SDPA's chain beside it. FLOPs are the analytic 4 B T^2 C a
layer; the share is against the H100's 989 TFLOP/s of dense bf16.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

H100_BF16_PEAK_FLOPS = 989e12


class Variant(NamedTuple):
    """A microbench row: its name and a callable qkv -> out whose `kernel`
    attribute is the wrapper that counts its launches and whose `plain`
    attribute is its plain version."""
    name: str
    fn: Callable


def cases(n_v: int, n_c: int):
    """(name, (B, T, 3C), heads): the Voltron and CLIP vision towers'
    attention at the microbench's batches."""
    return [("voltron", (n_v, 196, 3 * 384), 6),
            ("clip_vision", (n_c, 197, 3 * 768), 12)]


def production(n_heads: int):
    """B1, the production kernel, as a variant callable."""
    from ..ops.fused_qkv_attention import (fused_qkv_attention,
                                           fused_qkv_attention_reference)

    def run(qkv):
        return fused_qkv_attention(qkv, n_heads)
    run.kernel = fused_qkv_attention
    run.plain = lambda qkv: fused_qkv_attention_reference(qkv, n_heads)
    return run


def sdpa_packed(qkv, n_heads: int):
    """The library yardstick: F.scaled_dot_product_attention on the (B, H,
    T, dh) views of the packed qkv, output back to (B, T, C)."""
    import torch.nn.functional as F
    B, T, C3 = qkv.shape
    q, k, v = qkv.view(B, T, 3, n_heads, C3 // (3 * n_heads)).permute(2, 0, 3, 1, 4)
    return F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, T, C3 // 3)


def first_scalar(out):
    """The feedback leaf: a scalar of the output, times 0."""
    import torch
    return out.reshape(-1)[0].to(torch.float32) * 0.0


def attention_chain(fn, C: int, n_layers: int):
    """`n_layers` calls of `fn`, each output spliced back over the q lanes
    (q <- out + 0.1 q, in place), so that the chain keeps its shape and each
    layer depends on the last."""
    def run(x, c):
        y = x + c.to(x.dtype)
        for _ in range(n_layers):
            o = fn(y)
            y[..., :C].mul_(0.1).add_(o)
        return y
    return run


def chain_bench(name, fn, feedback_leaf, *args, n: int = 8, reps: int = 2,
                flops: float | None = None):
    """Time `fn(*args, carry)` chained through `feedback_leaf` of its output.

    fn takes a trailing f32 scalar tensor and adds it (times 0 is fine) to
    one of its inputs. Returns the seconds per call (the fastest of `reps`
    loops of `n` chained calls, CUDA events, each loop ended by a fetch to
    the host), or None on the CPU, where the calls run but nothing is timed.
    """
    import torch
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    out = fn(*args, torch.zeros((), device=device))
    feedback_leaf(out).item()  # warm-up and drain
    cuda = device.type == "cuda"
    dts = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        for _ in range(n):
            out = fn(*args, feedback_leaf(out))
        if cuda:
            end.record()
        feedback_leaf(out).item()  # the fetch that ends the loop
        if cuda:
            dts.append(start.elapsed_time(end) / 1e3 / n)
    if not cuda:
        print(f"{name:34s}  not timed (CPU)")
        return None
    dt = min(dts)
    rate = (f"  {flops / dt / 1e12:7.1f} TFLOP/s "
            f"({flops / dt / H100_BF16_PEAK_FLOPS * 100:4.1f}% of bf16 peak)"
            if flops else "")
    print(f"{name:34s} {dt * 1e3:9.3f} ms{rate}   "
          f"(loops: {', '.join(f'{d * 1e3:.3f}' for d in dts)})")
    return dt


def bench_variants(tool: str, variants: Callable, n_v: int, n_c: int, *, device,
                   n_layers: int, n: int, reps: int):
    """Rows of one microbench: for each of `cases(n_v, n_c)`, each variant
    of `variants(heads)` (the first is the production baseline) with its
    max |out - einsum| on a seeded N(0, 1) bf16 qkv, its chain time per
    layer, TFLOP/s, speed against the baseline, SDPA's chain time per layer
    and the kernel launches per chain (0 on the CPU, where the wrappers run
    their plain versions). Times are None on the CPU."""
    import numpy as np
    import torch
    from ..ops.fused_qkv_attention import fused_qkv_attention_reference
    device = torch.device(device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{tool}: device {where}, {n_layers}-layer chains")
    rng = np.random.default_rng(0)
    ms = lambda dt: None if dt is None else dt * 1e3 / n_layers
    rows = []
    for case, shape, H in cases(n_v, n_c):
        qkv = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            device=device, dtype=torch.bfloat16)
        B, T, C3 = shape
        C = C3 // 3
        flop_chain = n_layers * 4.0 * B * T * T * C
        print(f"\n== {case} {shape} H={H} ==")
        ref = fused_qkv_attention_reference(qkv, H).float()
        sdpa_dt = chain_bench("  sdpa (library)", attention_chain(
            lambda x: sdpa_packed(x, H), C, n_layers), first_scalar, qkv,
            n=n, reps=reps, flops=flop_chain)
        for i, v in enumerate(variants(H)):
            err = (v.fn(qkv).float() - ref).abs().max().item()
            before = v.fn.kernel.launches
            dt = chain_bench(f"  {v.name}", attention_chain(v.fn, C, n_layers),
                             first_scalar, qkv, n=n, reps=reps, flops=flop_chain)
            chains = 1 + n * reps  # the warm-up and the timed loops
            if i == 0:
                base_dt = dt
            row = {"tool": tool, "case": case, "variant": v.name, "qkv": list(shape),
                   "heads": H, "kernel": v.fn.kernel.__name__, "err_vs_einsum": err,
                   "ms_per_layer": ms(dt),
                   "tflops": None if dt is None else flop_chain / dt / 1e12,
                   "vs_production": None if dt is None else base_dt / dt,
                   "sdpa_ms_per_layer": ms(sdpa_dt),
                   "launches_per_chain": (v.fn.kernel.launches - before) / chains}
            print(f"      parity max|diff| {err:.3e}"
                  + (f"   -> {base_dt / dt:.2f}x vs production" if dt else ""))
            rows.append(row)
    return rows
