"""Position embeddings (port of `mdt_policy_tpu/models/position_embeddings.py`):
rotary with optional xpos length decay, T5's bucketed relative position
bias, and the dynamic position bias MLP (reference
`mdt/models/networks/transformers/position_embeddings.py:33-260`).

Rotary pairs ADJACENT channels (2i, 2i+1), not the two halves of the head,
and its tables are float32; `models/blocks.py::Attention` applies it to q
and k with `use_rot_embed`. The frequencies are formed on the input's
device at each call, in float32, as the JAX functions form them.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["rotate_half", "apply_rotary_emb", "rotary_frequencies",
           "RotaryEmbedding", "RelativePositionBias", "DynamicPositionBias"]


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(x1, x2) pairs of adjacent channels -> (-x2, x1) (ref :56-60)."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    x1, x2 = x.unbind(-1)
    return torch.stack((-x2, x1), dim=-1).flatten(-2)


def apply_rotary_emb(freqs: torch.Tensor, t: torch.Tensor, scale=1.0) -> torch.Tensor:
    """Rotates the leading `freqs.shape[-1]` channels of t (ref :62-69)."""
    rot_dim = freqs.shape[-1]
    t_rot, t_rest = t[..., :rot_dim], t[..., rot_dim:]
    t_rot = t_rot * freqs.cos() * scale + rotate_half(t_rot) * freqs.sin() * scale
    return torch.cat([t_rot, t_rest], dim=-1)


def rotary_frequencies(dim: int, *, theta: float = 10000.0,
                       theta_rescale_factor: float = 1.0, device=None) -> torch.Tensor:
    """The base inverse frequencies ('lang' mode, ref :102-107), float32,
    with the NTK-aware rescale hook."""
    theta = theta * theta_rescale_factor ** (dim / (dim - 2))
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device)[: dim // 2] / dim
    return 1.0 / (theta ** exps)


class RotaryEmbedding(nn.Module):
    """Rotary embedding of q and k of shape (B, H, T, D), with optional
    xpos length decay (ref :83-189): q scaled by `scale ** power`, k by its
    inverse, the power centred at `T // 2`. No parameters."""

    def __init__(self, dim: int, theta: float = 10000.0, use_xpos: bool = False,
                 xpos_scale_base: float = 512.0, interpolate_factor: float = 1.0):
        super().__init__()
        self.dim, self.theta, self.use_xpos = dim, theta, use_xpos
        self.xpos_scale_base, self.interpolate_factor = xpos_scale_base, interpolate_factor

    def _freqs_for(self, seq_len: int, device) -> torch.Tensor:
        pos = torch.arange(seq_len, dtype=torch.float32, device=device) / self.interpolate_factor
        inv = rotary_frequencies(self.dim, theta=self.theta, device=device)
        return (pos[:, None] * inv[None, :]).repeat_interleave(2, dim=-1)  # (T, dim)

    def _scale_for(self, seq_len: int, device) -> torch.Tensor:
        scale = ((torch.arange(0, self.dim, 2, device=device) + 0.4 * self.dim)
                 / (1.4 * self.dim)).float()
        power = (torch.arange(seq_len, device=device) - seq_len // 2) / self.xpos_scale_base
        s = scale[None, :] ** power.float()[:, None]
        return torch.cat([s, s], dim=-1)

    def rotate_queries_or_keys(self, t: torch.Tensor) -> torch.Tensor:
        if self.use_xpos:
            raise ValueError("xpos needs rotate_queries_and_keys")
        return apply_rotary_emb(self._freqs_for(t.shape[-2], t.device), t)

    def rotate_queries_and_keys(self, q: torch.Tensor, k: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        seq_len = q.shape[-2]
        freqs = self._freqs_for(seq_len, q.device)
        scale = self._scale_for(seq_len, q.device)
        return (apply_rotary_emb(freqs, q, scale=scale),
                apply_rotary_emb(freqs, k, scale=scale ** -1))

    def forward(self, q: torch.Tensor, k: torch.Tensor):
        if self.use_xpos:
            return self.rotate_queries_and_keys(q, k)
        return self.rotate_queries_or_keys(q), self.rotate_queries_or_keys(k)


def _relative_position_bucket(relative_position: torch.Tensor, causal: bool,
                              num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's bucket function (ref :202-221). The float log is cast to int32
    by truncation toward zero, as `astype` does; `+ 1e-9` keeps it finite
    at n = 0."""
    ret = 0
    n = -relative_position
    if not causal:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


class RelativePositionBias(nn.Module):
    """T5 bucketed relative attention bias (ref :192-236): (1, heads, q, k)."""

    def __init__(self, scale: float = 1.0, causal: bool = False, num_buckets: int = 32,
                 max_distance: int = 128, heads: int = 8):
        super().__init__()
        self.scale, self.causal = scale, causal
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def forward(self, q_len: int, k_len: int) -> torch.Tensor:
        device = self.relative_attention_bias.weight.device
        rel = (torch.arange(k_len, device=device)[None, :]
               - torch.arange(q_len, device=device)[:, None])
        buckets = _relative_position_bucket(rel, self.causal, self.num_buckets,
                                            self.max_distance)
        bias = self.relative_attention_bias(buckets)  # (q, k, h)
        return bias.permute(2, 0, 1)[None] * self.scale


class DynamicPositionBias(nn.Module):
    """SiLU MLP over the (log-)distance -> per-head biases (ref :238-260):
    (1, heads, q, k). Keys `fc{i}` and `out`, as the JAX module names them."""

    def __init__(self, dim: int, heads: int = 8, depth: int = 2,
                 log_distance: bool = True):
        super().__init__()
        self.depth, self.log_distance = depth, log_distance
        for i in range(depth):
            setattr(self, f"fc{i}", nn.Linear(1 if i == 0 else dim, dim))
        self.out = nn.Linear(dim, heads)

    def forward(self, q_len: int, k_len: int) -> torch.Tensor:
        device = self.out.weight.device
        rel = (torch.arange(k_len, device=device)[None, :]
               - torch.arange(q_len, device=device)[:, None]).float()
        if self.log_distance:
            rel = rel.sign() * rel.abs().log1p()
        h = rel[..., None]
        for i in range(self.depth):
            h = F.silu(getattr(self, f"fc{i}")(h))
        return self.out(h).permute(2, 0, 1)[None]
