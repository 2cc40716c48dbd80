"""CLIP towers (port of `mdt_policy_tpu/models/clip.py`): pre-LN
transformers with QuickGELU and packed-qkv attention through kernel B1, every
LayerNorm (eps 1e-5) through kernel B3. With `halfblocks=True` every residual
block runs as the attention half-block B4 and the MLP half-block B5
(`ops/attention_halfblock.py`, `ops/mlp_halfblock.py`); `ln_pre`, `ln_post`
and `ln_final` stay on B3.

* `CLIPTextTower`: causal, pooled at the EOT token (the largest token id).
* `CLIPVisionTower`: ViT over NHWC images, a bias-free conv patchifier, a
  class token, `ln_post` on the class token and `@ proj`.

OpenAI's `state_dict` layout (`transformer.resblocks.{i}.attn.in_proj_weight`,
`conv1.weight`, `class_embedding`, ...), the one `port_clip_text` and
`port_clip_vision` (without the `visual.` prefix) of the JAX package read.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention_halfblock import attention_halfblock
from ..ops.fused_qkv_attention import fused_qkv_attention
from ..ops.mlp_halfblock import mlp_halfblock
from .blocks import TowerLayerNorm

__all__ = ["quick_gelu", "ResidualAttentionBlock", "CLIPTextTower",
           "CLIPVisionTower"]


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
        self.ln_1 = TowerLayerNorm(width, eps=1e-5)
        self.attn = _PackedAttention(width, heads, causal)
        self.ln_2 = TowerLayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width)

    def forward(self, x: torch.Tensor, halfblocks: bool = False) -> torch.Tensor:
        if halfblocks:  # B4 then B5, from the block's own weights
            attn, mlp = self.attn, self.mlp
            x = attention_halfblock(x, self.ln_1.weight, self.ln_1.bias,
                                    attn.in_proj_weight, attn.in_proj_bias,
                                    attn.out_proj.weight, attn.out_proj.bias, None,
                                    attn.heads, "ln", self.ln_1.eps, attn.causal)
            return mlp_halfblock(x, self.ln_2.weight, self.ln_2.bias, mlp.c_fc.weight,
                                 mlp.c_fc.bias, mlp.c_proj.weight, mlp.c_proj.bias, None,
                                 "quickgelu", "ln", self.ln_2.eps)
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, causal: bool):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal) for _ in range(layers))

    def forward(self, x: torch.Tensor, halfblocks: bool = False) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, halfblocks)
        return x


class CLIPTextTower(nn.Module):
    """tokens (B, context_length) int -> (B, embed_dim), in the weights' dtype;
    `halfblocks` runs every block as B4 + B5."""

    def __init__(self, embed_dim: int = 512, context_length: int = 77,
                 vocab_size: int = 49408, width: int = 512, heads: int = 8,
                 layers: int = 12):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.transformer = _Transformer(width, layers, heads, causal=True)
        self.ln_final = TowerLayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(width, embed_dim))

    def forward(self, tokens: torch.Tensor, halfblocks: bool = False) -> torch.Tensor:
        x = self.token_embedding(tokens) + self.positional_embedding[None]
        x = self.ln_final(self.transformer(x, halfblocks))
        eot = tokens.argmax(dim=-1)  # first occurrence of the largest id
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection


class CLIPVisionTower(nn.Module):
    """images (B, H, W, 3), CLIP-normalized -> (B, embed_dim), in the
    weights' dtype (JAX clip.py:188-223). Heads: width // 64. `halfblocks`
    runs every block as B4 + B5."""

    def __init__(self, embed_dim: int = 512, image_resolution: int = 224,
                 layers: int = 12, width: int = 768, patch_size: int = 16):
        super().__init__()
        n_pos = (image_resolution // patch_size) ** 2 + 1
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(n_pos, width))
        self.ln_pre = TowerLayerNorm(width, eps=1e-5)
        self.transformer = _Transformer(width, layers, max(width // 64, 1),
                                        causal=False)
        self.ln_post = TowerLayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.zeros(width, embed_dim))

    def forward(self, images: torch.Tensor, halfblocks: bool = False) -> torch.Tensor:
        x = self.conv1(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding[None]
        x = self.transformer(self.ln_pre(x), halfblocks)
        return self.ln_post(x[:, 0]) @ self.proj
