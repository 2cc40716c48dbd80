"""Scaled-dot-product attention for the denoiser and the perceiver's plain
path: tiny sequences, plain PyTorch (the JAX package leaves this to XLA
einsums, `mdt_policy_tpu/ops/attention.py::sdpa`).

Same contract as there: softmax statistics in float32 whatever the input
dtype; for bf16/fp16 inputs the scores are formed in the input dtype (as the
JAX version does) and the probabilities are cast back to it before P.V.
Dropout on the probabilities runs when a generator is passed (train mode).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["causal_mask", "dropout", "sdpa"]


def causal_mask(q_len: int, k_len: int, device=None) -> torch.Tensor:
    """Lower-triangular boolean (q_len, k_len) mask, True = attend."""
    return torch.ones(q_len, k_len, dtype=torch.bool, device=device).tril()


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawn from `generator`: each value is kept with
    probability 1 - p and scaled by 1/(1 - p). Off without a generator."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         mask: Optional[torch.Tensor] = None, causal: bool = False,
         layout: str = "bhtd", dropout_p: float = 0.0,
         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Attention over (B, H, T, D) tensors (layout "bhtd") or (B, T, H, D)
    tensors (layout "bthd"). `mask` is boolean, broadcastable to
    (B, H, Tq, Tk), True = keep; `causal` keeps key j for query i when
    j <= i (a lower-triangular (Tq, Tk) mask ANDed with `mask`, as the JAX
    version). Masked scores are set to the score dtype's smallest finite
    value before the float32 softmax. With a `generator`, `dropout` runs on
    the post-softmax probabilities, as in the reference."""
    if layout == "bthd":
        q, k, v = (t.transpose(-3, -2) for t in (q, k, v))
    q_len, k_len, head_dim = q.shape[-2], k.shape[-2], q.shape[-1]
    scale = head_dim ** -0.5
    scores = torch.matmul(q, k.transpose(-1, -2))
    if q.dtype in (torch.bfloat16, torch.float16):
        scores = scores * torch.tensor(scale, dtype=q.dtype)
    else:
        scores = scores.float() * scale
    if causal:
        keep = causal_mask(q_len, k_len, q.device)
        mask = keep if mask is None else mask & keep
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    probs = dropout(torch.softmax(scores.float(), dim=-1).to(q.dtype),
                    dropout_p, generator)
    out = torch.matmul(probs, v)
    return out.transpose(-3, -2) if layout == "bthd" else out
