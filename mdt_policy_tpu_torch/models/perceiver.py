"""Perceiver resampler (port of `mdt_policy_tpu/models/perceiver.py`):
compresses the 2-camera Voltron token grid into `num_latents` observation
tokens. Reference `state_dict` layout: `layers.{i}.0` is the attention layer,
`layers.{i}.1` the feed-forward `Sequential(LN, Linear, GELU, Linear)`.

Weights are float32; activations run in `dtype` (bf16 in production) and
the final LayerNorm in float32. All LayerNorms use the flax default eps 1e-6.

The media's LayerNorm statistics are taken once (they do not change across
layers) and each layer applies only its own affine. The default factored
path folds that affine and W_k / W_v into the attention algebra so that K
and V over the media never exist (`_factored_folded_attention`); it is ported
in the same association as the JAX code, since another order rounds
differently in bf16. `factored=False` is the plain path.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import sdpa
from .blocks import LayerNorm, dense

__all__ = ["PerceiverAttentionLayer", "FeedForward", "PerceiverResampler"]


def _factored_folded_attention(q, xhat, lat_n, s, b, wk, wv, heads: int,
                               dim_head: int):
    """Cross-attention of the latent queries over (media ++ latents) with the
    media affine x = xhat*s + b and the K/V projections folded in:

      scores_media = (q_eff * s) @ xhat^T + q_eff @ b
      ctx_media    = (probs_media @ xhat) * s + rowsum(probs_media) (x) b

    wk, wv are flax-layout (C, inner) kernels."""
    B, Tq, _ = q.shape
    C = xhat.shape[-1]
    scale = dim_head ** -0.5
    low_precision = q.dtype in (torch.bfloat16, torch.float16)
    qh = q.reshape(B, Tq, heads, dim_head)
    wkh = wk.reshape(C, heads, dim_head).to(q.dtype)
    q_eff = torch.einsum("bqhd,chd->bhqc", qh, wkh).reshape(B, heads * Tq, C)
    scores_m = torch.einsum("bqc,btc->bqt", q_eff * s[None, None, :], xhat) \
        + (q_eff @ b)[..., None]
    scores_l = torch.einsum("bqc,btc->bqt", q_eff, lat_n)
    scores = torch.cat([scores_m, scores_l], dim=-1)
    scores = scores * torch.tensor(scale, dtype=q.dtype) if low_precision \
        else scores.float() * scale
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    n_media = xhat.shape[-2]
    probs_m, probs_l = probs[..., :n_media], probs[..., n_media:]
    ctx = torch.einsum("bqt,btc->bqc", probs_m, xhat) * s[None, None, :] \
        + probs_m.sum(-1, keepdim=True) * b[None, None, :] \
        + torch.einsum("bqt,btc->bqc", probs_l, lat_n)
    ctx = ctx.reshape(B, heads, Tq, C)
    wvh = wv.reshape(C, heads, dim_head).to(q.dtype)
    out = torch.einsum("bhqc,chd->bqhd", ctx, wvh)
    return out.reshape(B, Tq, heads * dim_head)


class PerceiverAttentionLayer(nn.Module):
    """Latents cross-attend to (media ++ latents); biasless projections."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, *,
                 dtype: torch.dtype = torch.float32, factored: bool = True):
        super().__init__()
        inner = dim_head * heads
        self.dim_head, self.heads, self.dtype = dim_head, heads, dtype
        self.factored = factored
        self.norm_media = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.norm_latents = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, xhat: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        """xhat: media with LayerNorm statistics already applied (B, T, C);
        latents (B, n, C)."""
        dt = self.dtype
        lat = self.norm_latents(latents)
        q = dense(lat, self.to_q, dt)
        s = self.norm_media.weight.to(dt)
        b = self.norm_media.bias.to(dt)
        if self.factored:
            out = _factored_folded_attention(
                q, xhat, lat, s, b, self.to_k.weight.t(), self.to_v.weight.t(),
                self.heads, self.dim_head)
            return dense(out, self.to_out, dt)
        x = xhat * s + b
        kv_input = torch.cat([x, lat], dim=-2)
        B, n_queries, _ = lat.shape
        k = dense(kv_input, self.to_k, dt).reshape(B, -1, self.heads, self.dim_head)
        v = dense(kv_input, self.to_v, dt).reshape(B, -1, self.heads, self.dim_head)
        out = sdpa(q.reshape(B, n_queries, self.heads, self.dim_head), k, v,
                   layout="bthd").reshape(B, n_queries, -1)
        return dense(out, self.to_out, dt)


class FeedForward(nn.Sequential):
    """LN -> Linear(4d) -> GELU -> Linear(d), biasless, computed in
    `dtype` (ref transformers/utils.py:15-27)."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__(LayerNorm(dim, eps=1e-6, dtype=dtype),
                         nn.Linear(dim, 4 * dim, bias=False), nn.GELU(),
                         nn.Linear(4 * dim, dim, bias=False))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm, fc1, _, fc2 = self
        return dense(F.gelu(dense(norm(x), fc1, self.dtype)), fc2, self.dtype)


class PerceiverResampler(nn.Module):

    def __init__(self, dim: int, depth: int, dim_head: int = 64,
                 heads: int = 8, num_latents: int = 64,
                 num_time_embeds: int = 4, *,
                 dtype: torch.dtype = torch.float32, factored: bool = True):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.latents = nn.Parameter(torch.zeros(num_latents, dim))
        self.time_pos_emb = nn.Parameter(torch.zeros(num_time_embeds, 1, dim))
        self.media_stats = LayerNorm(dim, eps=1e-6, affine=False, dtype=dtype)
        self.layers = nn.ModuleList(
            nn.ModuleList([PerceiverAttentionLayer(dim, dim_head, heads,
                                                   dtype=dtype, factored=factored),
                           FeedForward(dim, dtype)])
            for _ in range(depth))
        self.norm = LayerNorm(dim, eps=1e-6)

    def forward(self, x_f: torch.Tensor) -> torch.Tensor:
        """x_f: (B, n_frames, n_features, dim) -> (B, num_latents, dim) f32."""
        B, n_frames, _, dim = x_f.shape
        if dim != self.dim:
            raise ValueError(f"perceiver expects dim {self.dim}, got {dim}")
        tpe = self.time_pos_emb[None, :n_frames].expand(B, n_frames, 1, dim)
        x_f = (x_f + tpe.to(x_f.dtype)).to(self.dtype).reshape(B, -1, dim)
        xhat = self.media_stats(x_f)
        x = self.latents[None].to(self.dtype).expand(B, -1, -1)
        for attn, ff in self.layers:
            x = x + attn(xhat, x)
            x = x + ff(x)
        return self.norm(x.float())
