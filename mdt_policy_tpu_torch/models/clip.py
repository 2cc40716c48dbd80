"""CLIP text tower (port of `mdt_policy_tpu/models/clip.py::CLIPTextTower`):
pre-LN transformer with QuickGELU and packed-qkv causal attention through
kernel B1, pooled at the EOT token (the largest token id). OpenAI's
`state_dict` layout (`transformer.resblocks.{i}.attn.in_proj_weight`, ...),
the one `port_clip_text` of the JAX package reads. LayerNorm eps is 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_qkv_attention import fused_qkv_attention
from .blocks import LayerNorm

__all__ = ["quick_gelu", "ResidualAttentionBlock", "CLIPTextTower"]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class _PackedAttention(nn.Module):
    """Parameters of OpenAI's attention (packed in-projection) and its
    application through kernel B1."""

    def __init__(self, width: int, heads: int, causal: bool):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        return self.out_proj(fused_qkv_attention(qkv, self.heads, self.causal))


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=1e-5)
        self.attn = _PackedAttention(width, heads, causal)
        self.ln_2 = LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, causal: bool):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal) for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x)
        return x


class CLIPTextTower(nn.Module):
    """tokens (B, context_length) int -> (B, embed_dim), in the weights' dtype."""

    def __init__(self, embed_dim: int = 512, context_length: int = 77,
                 vocab_size: int = 49408, width: int = 512, heads: int = 8,
                 layers: int = 12):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.transformer = _Transformer(width, layers, heads, causal=True)
        self.ln_final = LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(width, embed_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(tokens) + self.positional_embedding[None]
        x = self.ln_final(self.transformer(x))
        eot = tokens.argmax(dim=-1)  # first occurrence of the largest id
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection
