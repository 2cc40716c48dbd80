"""Transformer building blocks of the MDT denoiser (port of
`mdt_policy_tpu/models/blocks.py`), with the reference's `state_dict` key
layout (the one `mdt_policy_tpu/utils/torch_port.py` reads).

Numerics kept from the JAX package:

* LayerNorms compute statistics and affine in float32 and cast the result
  (flax semantics). `BiaslessLayerNorm` has eps 1e-5; the cross-attention
  pre-norm `ln3` is a flax default LayerNorm, eps 1e-6, with bias.
* `RMSNorm` is x / max(||x||_2 * D^-1/2, eps) * g with the norm in float32.
* `modulate(x, shift, scale) = shift + x * scale` (not the DiT convention).

The denoiser computes in float32 (the JAX default). Inference only: dropout
is not applied.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import sdpa

__all__ = [
    "dense", "mish", "LayerNorm", "BiaslessLayerNorm", "RMSNorm", "SwishGLU",
    "Attention", "MLP", "Block", "AdaLNZero", "modulate", "ConditionedBlock",
    "TransformerEncoder", "TransformerFiLMDecoder", "SinusoidalPosEmb",
    "SigmaEmbedding",
]


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """`layer(x)` computed in `dtype`: input and weights cast to it, as flax
    `Dense(dtype=...)` does."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with flax numerics: float32 statistics and affine, result in
    `dtype` (None = the promoted dtype of input and parameters)."""

    def __init__(self, dim: int, eps: float = 1e-6, *, bias: bool = True,
                 affine: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__(dim, eps=eps, elementwise_affine=affine,
                         bias=bias and affine)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = [p for p in (self.weight, self.bias) if p is not None]
        out_dtype = self.dtype if self.dtype is not None else functools.reduce(
            torch.promote_types, [p.dtype for p in params], x.dtype)
        y = F.layer_norm(x.float(), self.normalized_shape,
                         None if self.weight is None else self.weight.float(),
                         None if self.bias is None else self.bias.float(),
                         self.eps)
        return y.to(out_dtype)


def BiaslessLayerNorm(dim: int) -> LayerNorm:
    """Weight-only LayerNorm, eps 1e-5 (ref transformer_blocks.py:29-38)."""
    return LayerNorm(dim, eps=1e-5, bias=False)


class RMSNorm(nn.Module):
    """x / max(||x||_2 * D^-1/2, eps) * g, the norm taken in float32 and the
    clamp cast back to the input dtype (ref transformer_blocks.py:43-51)."""

    def __init__(self, dim: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True) \
            * x.shape[-1] ** -0.5
        return (x / norm.clamp_min(self.eps).to(x.dtype)) * self.g


class SwishGLU(nn.Module):
    """project -> [projected | gate] -> projected * silu(gate)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.project = nn.Linear(in_dim, 2 * out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        projected, gate = self.project(x).chunk(2, dim=-1)
        return projected * F.silu(gate)


class Attention(nn.Module):
    """Self (context None) or cross attention; q/k/v with bias, the output
    projection without (ref :66-158, bias=False)."""

    def __init__(self, n_embd: int, n_head: int, *, causal: bool = False):
        super().__init__()
        self.n_head, self.causal = n_head, causal
        self.query = nn.Linear(n_embd, n_embd)
        self.key = nn.Linear(n_embd, n_embd)
        self.value = nn.Linear(n_embd, n_embd)
        self.c_proj = nn.Linear(n_embd, n_embd, bias=False)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, C = x.shape
        kv_src = x if context is None else context
        q, k, v = (layer(src).reshape(B, -1, self.n_head, C // self.n_head)
                   .transpose(1, 2)
                   for src, layer in ((x, self.query), (kv_src, self.key),
                                      (kv_src, self.value)))
        y = sdpa(q, k, v, causal=self.causal)
        return self.c_proj(y.transpose(1, 2).reshape(B, T, C))


class MLP(nn.Module):
    """4x exact-GELU MLP without biases (ref :161-180)."""

    def __init__(self, n_embd: int):
        super().__init__()
        self.c_fc = nn.Linear(n_embd, 4 * n_embd, bias=False)
        self.c_proj = nn.Linear(4 * n_embd, n_embd, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x)))


class Block(nn.Module):
    """Pre-LN self-attention block of the encoder (ref :183-214)."""

    def __init__(self, n_embd: int, n_heads: int):
        super().__init__()
        self.ln_1 = BiaslessLayerNorm(n_embd)
        self.attn = Attention(n_embd, n_heads)
        self.ln_2 = BiaslessLayerNorm(n_embd)
        self.mlp = MLP(n_embd)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class AdaLNZero(nn.Module):
    """SiLU + Linear -> six modulation chunks (ref :245-260); not
    zero-initialized, as in the reference."""

    def __init__(self, cond_dim: int, hidden_size: int):
        super().__init__()
        self.modulation = nn.Sequential(nn.SiLU(),
                                        nn.Linear(cond_dim, 6 * hidden_size))

    def forward(self, c: torch.Tensor):
        return self.modulation(c).chunk(6, dim=-1)


def modulate(x, shift, scale):
    """shift + x*scale (ref :262-263)."""
    return shift + x * scale


class ConditionedBlock(nn.Module):
    """Decoder block: AdaLN-conditioned causal self-attention and MLP, plain
    cross-attention to the encoder context (ref :266-309)."""

    def __init__(self, n_embd: int, n_heads: int):
        super().__init__()
        self.ln_1 = BiaslessLayerNorm(n_embd)
        self.attn = Attention(n_embd, n_heads, causal=True)
        self.ln3 = LayerNorm(n_embd, eps=1e-6)
        # causal as in the JAX block: a (10, n_context) lower-triangular mask
        self.cross_att = Attention(n_embd, n_heads, causal=True)
        self.ln_2 = BiaslessLayerNorm(n_embd)
        self.mlp = MLP(n_embd)
        self.adaLN_zero = AdaLNZero(n_embd, n_embd)

    def forward(self, x, c, context):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            self.adaLN_zero(c)
        x = x + gate_msa * self.attn(modulate(self.ln_1(x), shift_msa, scale_msa))
        x = x + self.cross_att(self.ln3(x), context)
        return x + gate_mlp * self.mlp(modulate(self.ln_2(x), shift_mlp, scale_mlp))


class TransformerEncoder(nn.Module):
    """Non-causal block stack + final biasless LN (ref :344-380)."""

    def __init__(self, embed_dim: int, n_heads: int, n_layers: int):
        super().__init__()
        self.blocks = nn.ModuleList(Block(embed_dim, n_heads)
                                    for _ in range(n_layers))
        self.ln = BiaslessLayerNorm(embed_dim)

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return self.ln(x)


class TransformerFiLMDecoder(nn.Module):
    """Causal AdaLN-conditioned decoder with cross-attention (ref :509-569)."""

    def __init__(self, embed_dim: int, n_heads: int, n_layers: int):
        super().__init__()
        self.blocks = nn.ModuleList(ConditionedBlock(embed_dim, n_heads)
                                    for _ in range(n_layers))
        self.ln = BiaslessLayerNorm(embed_dim)

    def forward(self, x, c, context):
        for block in self.blocks:
            x = block(x, c, context)
        return self.ln(x)


class SinusoidalPosEmb(nn.Module):
    """Log-spaced sinusoidal embedding (ref mdtv_transformer.py:13-25)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half_dim = self.dim // 2
        # float32 throughout, as the JAX version computes it
        emb_scale = torch.tensor(math.log(10000.0), dtype=torch.float32) \
            / (half_dim - 1)
        freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                       device=x.device) * -emb_scale.to(x.device))
        emb = x[..., None] * freqs
        return torch.cat([emb.sin(), emb.cos()], dim=-1)


class SigmaEmbedding(nn.Sequential):
    """Sinusoidal -> Linear(2d) -> Mish -> Linear(d) (ref
    mdtv_transformer.py:169-174); keys `1.*` and `3.*` as in the reference."""

    def __init__(self, embed_dim: int):
        super().__init__(SinusoidalPosEmb(embed_dim),
                         nn.Linear(embed_dim, 2 * embed_dim), nn.Mish(),
                         nn.Linear(2 * embed_dim, embed_dim))
