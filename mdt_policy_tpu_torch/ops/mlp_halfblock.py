"""The MLP half of a frozen tower block in one call (kernel B5):

    out = x + [gamma *] W2(act(W1(norm(x))))

Port of the Pallas TPU kernel `mdt_policy_tpu/ops/mlp_halfblock.py`
(`mlp_halfblock`, `_kernel`). Activations:

* "swishglu" (Voltron, blocks.SwishGLU): W1 packs [projected | gate] along
  its output axis, 2H rows; act = projected * silu(gate).
* "quickgelu" (CLIP): W1 has H rows; act = h * sigmoid(1.702 h).

Norms, weights and rounding points as in `ops/attention_halfblock.py`: the
plain version, `mlp_halfblock_reference`, follows the JAX `_reference`
(:70-83) op for op, silu written as gate * sigmoid(gate) as jax.nn.silu is.

On a CUDA tensor the wrapper launches three kernels on the current stream
(`ops/halfblock_gemm.py`, `csrc/halfblock_gemm.cu`: the norm pass, once a
row; the W1 GEMM with the bias and the activation in its epilogue; the W2
GEMM with its residual epilogue) or raises; the kernels take bf16 only. On
a CPU tensor it runs the plain version. The backward is autograd through
the plain version; a call that autograd does not record launches the
kernels directly, with no autograd Function around them.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._plain_backward import launch_with_plain_backward
from .attention_halfblock import check_halfblock
from .halfblock_gemm import (GEMM_COLS, GEMM_DEPTH, check_gemm_shapes, dot_reference,
                             halfblock_norm_reference, launch_gemm, launch_norm)

__all__ = ["mlp_halfblock", "mlp_halfblock_reference"]

ACTS = ("swishglu", "quickgelu")


def mlp_halfblock_reference(x, g, b, w1, b1, w2, b2, gamma, act: str = "swishglu",
                            norm: str = "rms", eps: float = 1e-8) -> torch.Tensor:
    """Plain version of the kernel (the JAX `_reference`)."""
    xn = halfblock_norm_reference(x, g, b, norm, eps)
    h = dot_reference(xn, w1) + b1
    if act == "swishglu":
        proj, gate = h.chunk(2, dim=-1)
        h = proj * (gate * torch.sigmoid(gate))
    else:
        h = h * torch.sigmoid(1.702 * h)
    out = dot_reference(h, w2) + b2
    if gamma is not None:
        out = out * gamma
    return x + out


def _launch(x, g, b, w1, b1, w2, b2, gamma, *, act: str, norm: str,
            eps: float) -> torch.Tensor:
    B, T, C = x.shape
    H = w2.shape[1]
    # each GEMM tile reads 128 rows of its weight (W1: 64 proj and 64 gate
    # rows for "swishglu"), 64 deep a stage
    check_gemm_shapes("mlp_halfblock", {
        "rows of w1": (w1.shape[0], GEMM_COLS), "C": (C, GEMM_COLS),
        "hidden (depth)": (H, GEMM_DEPTH)}, (x, g, b, w1, b1, w2, b2, gamma), norm_width=C)
    stream = _build.current_stream(x)
    xn = torch.empty_like(x)
    h = torch.empty((B, T, H), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    launch_norm(x, g, b, xn, norm, eps, stream)
    launch_gemm(xn, w1, b1, h, act, None, None, stream)
    launch_gemm(h, w2, b2, out, "residual", x, gamma, stream)
    _build.count_launch(mlp_halfblock)
    return out


def mlp_halfblock(x: torch.Tensor, g: torch.Tensor, b: Optional[torch.Tensor],
                  w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor, gamma: Optional[torch.Tensor],
                  act: str = "swishglu", norm: str = "rms",
                  eps: float = 1e-8) -> torch.Tensor:
    """x (B, T, C) -> x + [gamma *] W2(act(W1(norm(x)))).

    g, b: the norm's gain and bias (b None for "rms"); w1 (2H, C) for
    "swishglu" or (H, C) for "quickgelu" and w2 (C, H), torch Linear weights,
    with biases b1, b2; gamma (C,) or None. Every tensor in the dtype of x.
    CUDA tensors (bf16) run the kernels, one call counted in
    `mlp_halfblock.launches`, through `PlainBackward` only where autograd
    wants a gradient; CPU tensors run the plain version."""
    if act not in ACTS:
        raise ValueError(f"mlp_halfblock: act must be one of {ACTS}, got {act!r}")
    C = x.shape[-1]
    H = w2.shape[-1] if w2.ndim == 2 else -1
    n1 = 2 * H if act == "swishglu" else H
    check_halfblock("mlp_halfblock", x, norm, b, {
        "g": (g, (C,)), "b": (b, (C,)), "w1": (w1, (n1, C)), "b1": (b1, (n1,)),
        "w2": (w2, (C, H)), "b2": (b2, (C,)), "gamma": (gamma, (C,))})
    kwargs = dict(act=act, norm=norm, eps=eps)
    tensors = (x, g, b, w1, b1, w2, b2, gamma)
    if x.device.type == "cpu":
        return mlp_halfblock_reference(*tensors, **kwargs)
    return launch_with_plain_backward(_launch, mlp_halfblock_reference, kwargs, *tensors)


mlp_halfblock.launches = 0
