"""Few-row float32 linear layers with a fused prologue and epilogue (kernel B6).

Replaces no TPU kernel: the JAX package leaves the denoiser's dense layers
to XLA. At the replan's few rows (10 action tokens, 4 context tokens at
B=1) each of them was a cuBLAS GEMM of a few microseconds between separate
norm, modulation, activation, gate and residual kernels; B6 computes one or
more layers of the denoiser's blocks in one launch:

    out = epilogue(prologue(x) @ W.T)      for M <= MAX_ROWS rows of x

A `Gemm` is one input through one or more `nn.Linear` layers, whose outputs
lie side by side in its output (q, k and v, say). Its prologue is none,
"silu", a `Norm` (a LayerNorm, then `shift + y * scale` with a modulation)
or an `Attend` (the rows are multi-head attention outputs, computed inside
the launch from query rows and key/value rows); its epilogue adds the
layers' biases, then with `gelu` the exact GELU, then with `residual` the
residual, times `gate` where one is given. `shift`, `scale` and `gate` have
a row for every `per` rows of x (the tokens that share a modulation).
Everything is float32, with no TF32 and no tensor cores.

`few_row_linear(*gemms)` returns each gemm's output, from one launch (one
per 8 layers). On a CUDA tensor it launches the hand-written kernel in
`csrc/few_row_linear.cu` (built with nvcc at first use, see `_build.py`) on
the current stream, without an autograd Function and without a host sync,
so a CUDA graph captures it, or raises; on a CPU tensor it runs
`few_row_linear_reference`, the plain PyTorch version of the same contract,
which computes each step with the operators the denoiser's blocks use on
their per-op path. The kernel has no backward and no `torch.func` rule: on
the card it raises where autograd would record or a transform's tensor comes
in, and the blocks take this route only where neither does
(`models/blocks.py`).
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch._C._functorch import is_functorch_wrapped_tensor

from . import _build
from .attention import sdpa

__all__ = ["MAX_HEADS", "MAX_KV_ROWS", "MAX_ROWS", "MAX_WIDTH", "Attend", "Gemm", "Norm",
           "attention_fits", "few_row_linear", "few_row_linear_reference"]

# The kernel's limits (csrc: kMaxRows, kMaxJobs, kMaxWidth, kMaxKvRows,
# kMaxHeads): rows of x, layers a launch, the width of a Norm or Attend
# prologue's rows, an Attend's key rows over all its sequences, and its heads.
# Within them every job fits the kernel's shared memory (its static_asserts).
MAX_ROWS = 32
MAX_JOBS = 8
MAX_WIDTH = 512
MAX_KV_ROWS = 16
MAX_HEADS = 16


class Norm(NamedTuple):
    """LayerNorm of each row over its K columns (biased variance, `eps`),
    times `weight`, plus `bias` where one is given; then, with `shift` and
    `scale` (rows of K), `shift + y * scale`."""
    weight: torch.Tensor
    bias: Optional[torch.Tensor]
    eps: float
    shift: Optional[torch.Tensor] = None
    scale: Optional[torch.Tensor] = None


class Attend(NamedTuple):
    """Multi-head attention as the prologue: for each of `batch` sequences,
    its `q` rows (B * tq, C) attend, over `heads` heads, to its `kv` rows
    (B * tk, 2C; keys, then values), scores scaled by (C / heads)^-1/2, with
    `causal` key j kept for query t when j <= t (the decoder's
    cross-attention: a lower-triangular (tq, tk) mask)."""
    q: torch.Tensor
    kv: torch.Tensor
    heads: int
    batch: int
    causal: bool


class Gemm(NamedTuple):
    """One input through `layers` (their outputs side by side); see the
    module's docstring. `x` is None with an `Attend` prologue."""
    x: Optional[torch.Tensor]
    layers: Sequence[nn.Linear]
    prologue: Union[None, str, Norm, Attend] = None
    gelu: bool = False
    residual: Optional[torch.Tensor] = None
    gate: Optional[torch.Tensor] = None
    per: int = 1


def attention_fits(rows: int, width: int, kv_rows: int, heads: int) -> bool:
    """Whether an `Attend` prologue of `rows` queries of `width` channels
    over `kv_rows` keys in `heads` heads is within the kernel's limits."""
    return rows <= MAX_ROWS and kv_rows <= MAX_KV_ROWS and width <= MAX_WIDTH and \
        heads <= MAX_HEADS and width % (4 * heads) == 0


def _attend_reference(a: Attend) -> torch.Tensor:
    M, C = a.q.shape
    D = C // a.heads
    heads = lambda t: t.reshape(a.batch, -1, a.heads, D).transpose(1, 2)
    y = sdpa(heads(a.q), heads(a.kv[:, :C]), heads(a.kv[:, C:]), causal=a.causal)
    return y.transpose(1, 2).reshape(M, C)


def _gemm_reference(g: Gemm) -> torch.Tensor:
    x, pro = g.x, g.prologue
    if isinstance(pro, Attend):
        x = _attend_reference(pro)
    elif isinstance(pro, Norm):
        K = x.shape[-1]
        x = F.layer_norm(x, (K,), pro.weight, pro.bias, pro.eps)
        if pro.shift is not None:
            # (rows / per, per, K) against (rows / per, 1, K): each row its
            # modulation row, as the blocks broadcast (B, 1, C) over T
            x = (pro.shift[:, None] + x.view(-1, g.per, K) * pro.scale[:, None]).view(-1, K)
    elif pro == "silu":
        x = F.silu(x)
    ys = [F.linear(x, layer.weight, layer.bias) for layer in g.layers]
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=-1)
    if g.gelu:
        y = F.gelu(y)
    if g.residual is not None:
        if g.gate is not None:
            N = y.shape[-1]
            y = (g.gate[:, None] * y.view(-1, g.per, N)).view(-1, N)
        y = g.residual + y
    return y


def few_row_linear_reference(*gemms: Gemm):
    """Plain PyTorch version of the kernel: each gemm's output."""
    return [_gemm_reference(g) for g in gemms]


def _rows(name: str, t: torch.Tensor, shape, device, vector: bool) -> None:
    """Checks an f32 (rows, cols) operand on `device` whose columns are
    contiguous; with `vector`, rows on 16-byte boundaries too."""
    if t.dtype is not torch.float32 or t.device != device:
        raise TypeError(f"few_row_linear: {name} is {t.dtype} on {t.device}; float32 on "
                        f"{device} expected")
    if t.shape != shape or t.stride(1) != 1:
        raise ValueError(f"few_row_linear: {name} must be {tuple(shape)} with contiguous "
                         f"columns, got {tuple(t.shape)} strides {t.stride()}")
    if vector and (t.data_ptr() % 16 or t.stride(0) % 4):
        raise ValueError(f"few_row_linear: {name}'s rows must start on 16-byte boundaries")


def _vector(name: str, t: torch.Tensor, n: int, device, aligned: bool) -> None:
    """Checks a contiguous f32 (n,) operand on `device`; with `aligned`, on a
    16-byte boundary."""
    if t.dtype is not torch.float32 or t.device != device:
        raise TypeError(f"few_row_linear: {name} is {t.dtype} on {t.device}; float32 on "
                        f"{device} expected")
    if t.shape != (n,) or t.stride(0) != 1 or (aligned and t.data_ptr() % 16):
        raise ValueError(f"few_row_linear: {name} must be a contiguous ({n},) vector"
                         f"{' on a 16-byte boundary' if aligned else ''}")


def _check(g: Gemm, device) -> int:
    """Validates one gemm for the kernel; returns its rows."""
    pro = g.prologue
    if isinstance(pro, Attend):
        if g.x is not None:
            raise ValueError("few_row_linear: an Attend prologue takes no x")
        M, C = pro.q.shape
        if pro.batch < 1 or M % pro.batch or pro.kv.shape[0] % pro.batch or C % pro.heads:
            raise ValueError(f"few_row_linear: Attend of q {tuple(pro.q.shape)}, kv "
                             f"{tuple(pro.kv.shape)}, {pro.heads} heads, batch {pro.batch}")
        _rows("q", pro.q, (M, C), device, True)
        _rows("kv", pro.kv, (pro.kv.shape[0], 2 * C), device, True)
        if not attention_fits(M, C, pro.kv.shape[0], pro.heads):
            raise ValueError(f"few_row_linear: Attend of {M} queries over "
                             f"{pro.kv.shape[0]} keys of width {C} does not fit")
    elif g.x is None or g.x.dim() != 2:
        raise ValueError("few_row_linear: x must be (M, K) rows")
    else:
        M, C = g.x.shape
        _rows("x", g.x, (M, C), device, True)
    if not 1 <= M <= MAX_ROWS or C % 4 or not g.layers or M % g.per:
        raise ValueError(f"few_row_linear: {M} rows of {C} (per {g.per}); the kernel takes "
                         f"1 to {MAX_ROWS} rows of a multiple of 4 columns")
    if isinstance(pro, Norm):
        if C > MAX_WIDTH:
            raise ValueError(f"few_row_linear: a Norm prologue takes rows of at most "
                             f"{MAX_WIDTH} columns, got {C}")
        _vector("weight", pro.weight, C, device, True)
        if pro.bias is not None:
            _vector("bias", pro.bias, C, device, True)
        for name, t in (("shift", pro.shift), ("scale", pro.scale)):
            if t is not None:
                _rows(name, t, (M // g.per, C), device, True)
        if (pro.shift is None) != (pro.scale is None) or (
                pro.shift is not None and pro.shift.stride(0) != pro.scale.stride(0)):
            raise ValueError("few_row_linear: shift and scale come together, with one "
                             "row stride")
    elif pro not in (None, "silu") and not isinstance(pro, Attend):
        raise ValueError(f"few_row_linear: unknown prologue {pro!r}")
    N = 0
    for layer in g.layers:
        w = layer.weight
        _rows("weight", w, (w.shape[0], C), device, True)
        if w.stride(0) != C:
            raise ValueError("few_row_linear: a weight must be contiguous")
        if layer.bias is not None:
            _vector("bias", layer.bias, w.shape[0], device, False)
        N += w.shape[0]
    if g.residual is not None:
        _rows("residual", g.residual, (M, N), device, False)
    if g.gate is not None:
        if g.residual is None:
            raise ValueError("few_row_linear: a gate needs a residual")
        _rows("gate", g.gate, (M // g.per, N), device, False)
    return M


# One job, the fields of csrc's `struct Job` in its order: 8-byte integers
# and pointers, then eps and the attention's scale as doubles. kt, block0 and
# blocks are the C side's.
_FIELDS = ("x", "x_ld", "w", "bias", "out", "out_ld", "res", "res_ld", "gate", "gate_ld",
           "ln_w", "ln_b", "shift", "scale", "mod_ld", "q", "kv", "q_ld", "kv_ld", "v_off",
           "M", "K", "N", "per", "prologue", "gelu", "heads", "tq", "tk", "causal",
           "kt", "block0", "blocks", "eps", "att_scale")
_JOB = struct.Struct("<33q2d")
_PROLOGUES = {None: 0, "silu": 1, Norm: 2, Attend: 3}


_AT = {name: i for i, name in enumerate(_FIELDS)}


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _ld(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.stride(0)


def _jobs(g: Gemm, out: torch.Tensor):
    """The packed jobs of one gemm, a layer each, writing into `out`."""
    pro = g.prologue
    job = [0] * len(_FIELDS)
    job[_AT["eps"]] = job[_AT["att_scale"]] = 0.0
    job[_AT["M"]], job[_AT["per"]], job[_AT["gelu"]] = out.shape[0], g.per, int(g.gelu)
    job[_AT["prologue"]] = _PROLOGUES[pro if pro is None or isinstance(pro, str) else type(pro)]
    job[_AT["x"]], job[_AT["x_ld"]] = _ptr(g.x), _ld(g.x)
    job[_AT["out_ld"]], job[_AT["res_ld"]], job[_AT["gate_ld"]] = \
        out.stride(0), _ld(g.residual), _ld(g.gate)
    if isinstance(pro, Norm):
        job[_AT["ln_w"]], job[_AT["ln_b"]] = _ptr(pro.weight), _ptr(pro.bias)
        job[_AT["shift"]], job[_AT["scale"]] = _ptr(pro.shift), _ptr(pro.scale)
        job[_AT["mod_ld"]], job[_AT["eps"]] = _ld(pro.shift), pro.eps
    if isinstance(pro, Attend):
        C, M = pro.q.shape[1], out.shape[0]
        job[_AT["q"]], job[_AT["kv"]] = _ptr(pro.q), _ptr(pro.kv)
        job[_AT["q_ld"]], job[_AT["kv_ld"]], job[_AT["v_off"]] = _ld(pro.q), _ld(pro.kv), C
        job[_AT["heads"]], job[_AT["tq"]] = pro.heads, M // pro.batch
        job[_AT["tk"]], job[_AT["causal"]] = pro.kv.shape[0] // pro.batch, int(pro.causal)
        job[_AT["att_scale"]] = (C // pro.heads) ** -0.5
    job[_AT["K"]] = pro.q.shape[1] if isinstance(pro, Attend) else g.x.shape[1]
    out_p, res_p, gate_p = _ptr(out), _ptr(g.residual), _ptr(g.gate)
    col = 0
    for layer in g.layers:
        job[_AT["w"]], job[_AT["bias"]] = _ptr(layer.weight), _ptr(layer.bias)
        job[_AT["out"]] = out_p + 4 * col
        job[_AT["res"]] = res_p and res_p + 4 * col
        job[_AT["gate"]] = gate_p and gate_p + 4 * col
        job[_AT["N"]] = layer.weight.shape[0]
        yield _JOB.pack(*job)
        col += job[_AT["N"]]


@functools.cache
def _kernel():
    """The ctypes function of `csrc/few_row_linear.cu`, built, loaded and
    typed once per process."""
    fn = _build.load_library("few_row_linear").mdt_few_row_linear
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _tensors(gemms):
    """Every tensor the gemms read."""
    for g in gemms:
        pro = g.prologue
        parts = [g.x, g.residual, g.gate]
        parts += [t for layer in g.layers for t in (layer.weight, layer.bias)]
        if isinstance(pro, (Norm, Attend)):
            parts += [t for t in pro if isinstance(t, torch.Tensor)]
        yield from (t for t in parts if t is not None)


def few_row_linear(*gemms: Gemm):
    """Each gemm's (M, sum of its layers' N) output. CUDA tensors run the
    kernel, one launch per MAX_JOBS layers (counted in
    `few_row_linear.launches`); CPU tensors run the plain version."""
    if any(t.is_cpu for t in _tensors(gemms)):
        return few_row_linear_reference(*gemms)
    if any(is_functorch_wrapped_tensor(t) for t in _tensors(gemms)):
        raise RuntimeError("few_row_linear has no torch.func rule: call the per-op path "
                           "under a transform")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for g in gemms for layer in g.layers for t in (layer.weight, layer.bias)):
        raise RuntimeError("few_row_linear has no backward: call it under no_grad")
    device = (gemms[0].x if gemms[0].x is not None else gemms[0].prologue.q).device
    outs, jobs = [], []
    for g in gemms:
        M = _check(g, device)
        out = torch.empty((M, sum(layer.weight.shape[0] for layer in g.layers)),
                          dtype=torch.float32, device=device)
        outs.append(out)
        jobs.extend(_jobs(g, out))
    stream = _build.current_stream(outs[0])
    for i in range(0, len(jobs), MAX_JOBS):
        chunk = jobs[i:i + MAX_JOBS]
        rc = _kernel()(b"".join(chunk), len(chunk), stream)
        if rc != 0:
            raise RuntimeError(f"few_row_linear: CUDA launch failed with error {rc} for "
                               f"{len(chunk)} layers of {[tuple(o.shape) for o in outs]}")
        _build.count_launch(few_row_linear)
    return outs


few_row_linear.launches = 0
