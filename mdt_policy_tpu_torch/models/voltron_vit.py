"""Voltron ViT token encoder (port of `mdt_policy_tpu/models/voltron_vit.py`):
RMSNorm + SwishGLU + LayerScale blocks over 16-px patches with a fixed 2-D
sin-cos position table, returning the full patch-token grid, e.g.
(B, 196, 384) for ViT-S/16 at 224 px. In the tower, attention runs kernel B1
(`ops/fused_qkv_attention.py`) straight off the packed qkv projection and
every norm runs kernel B3 (`ops/fused_norm.py`); with `halfblocks=True`
each tower block runs as the attention half-block B4 and the MLP half-block
B5 instead (`ops/attention_halfblock.py`, `ops/mlp_halfblock.py`, the JAX
block's `fused_kernel` counterpart), and only `encoder_norm` stays on B3.
The foresight decoder
builds its blocks with `fused_kernel=False` and a compute `dtype`, as the
JAX decoder does: plain `sdpa` attention, f32 master weights cast to bf16.

Key layout is Voltron's own (`patch2embed.proj`, `blocks.{i}`,
`encoder_norm`), the one `port_voltron_vit` of the JAX package reads.
Images are NHWC, as in the JAX package. The frozen tower holds bf16 weights
and computes in bf16; its final LayerNorm has eps 1e-6.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import sdpa
from ..ops.attention_halfblock import attention_halfblock
from ..ops.fused_qkv_attention import fused_qkv_attention
from ..ops.mlp_halfblock import mlp_halfblock
from .blocks import RMSNorm, SwishGLU, TowerLayerNorm, dense

__all__ = ["get_1d_sincos_pos_embed", "get_2d_sincos_pos_embed", "PatchEmbed", "LayerScale",
           "VoltronBlock", "VoltronViT"]


def _get_1d_sincos(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(dim // 2, dtype=np.float32) / (dim / 2.0)
    omega = 1.0 / (10000 ** omega)
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_1d_sincos_pos_embed(embed_dim: int, length: int) -> np.ndarray:
    """1-D sin-cos table over positions 0 .. length - 1, (length, embed_dim)."""
    return _get_1d_sincos(embed_dim, np.arange(length))


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """MAE-style 2-D sin-cos table, (grid_size**2, embed_dim) float32. The
    meshgrid is built (grid_w, grid_h), in that order, as in the JAX package."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0).reshape(2, 1, grid_size, grid_size)
    emb_h = _get_1d_sincos(embed_dim // 2, grid[0])
    emb_w = _get_1d_sincos(embed_dim // 2, grid[1])
    pos_embed = np.concatenate([emb_h, emb_w], axis=1)
    return pos_embed.astype(np.float32)


class PatchEmbed(nn.Module):
    """Conv patchifier: NHWC images -> (B, n_patches, embed_dim), patches
    in row-major (h, w) order; with `dtype`, images and weights are cast to
    it first (flax `Conv(dtype=...)`)."""

    def __init__(self, patch_size: int, embed_dim: int, in_chans: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        if self.dtype is None:
            x = self.proj(x)  # (B, d, h, w)
        else:
            dt, p = self.dtype, self.proj
            x = F.conv2d(x.to(dt), p.weight.to(dt), p.bias.to(dt), stride=p.stride)
        return x.flatten(2).transpose(1, 2)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * (self.gamma if self.dtype is None else self.gamma.to(self.dtype))


class _ViTAttention(nn.Module):
    """Fused-qkv multi-head attention: kernel B1 off the packed projection,
    or (`fused_kernel=False`) plain `sdpa` on its head-interleaved views."""

    def __init__(self, dim: int, n_heads: int, fused_kernel: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_heads, self.fused_kernel, self.dtype = n_heads, fused_kernel, dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        qkv = dense(x, self.qkv, dt)
        if self.fused_kernel:
            y = fused_qkv_attention(qkv, self.n_heads)
        else:
            B, T, C3 = qkv.shape
            q, k, v = (t.reshape(B, T, self.n_heads, -1) for t in qkv.chunk(3, dim=-1))
            y = sdpa(q, k, v, layout="bthd").reshape(B, T, C3 // 3)
        return dense(y, self.proj, dt)


class VoltronBlock(nn.Module):
    """x + ls1(attn(norm1(x))); x + ls2(mlp(norm2(x))), MLP ratio 4.

    `fused_kernel` is the JAX block's attribute of the same name (B1 or
    plain attention); `dtype` is its computation dtype (None: the weights')."""

    def __init__(self, dim: int, n_heads: int, *, fused_kernel: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        hidden = 4 * dim
        self.dtype = dtype
        self.norm1 = RMSNorm(dim, dtype=dtype)
        self.attn = _ViTAttention(dim, n_heads, fused_kernel, dtype)
        self.ls1 = LayerScale(dim, dtype=dtype)
        self.norm2 = RMSNorm(dim, dtype=dtype)
        self.mlp = nn.Sequential(SwishGLU(dim, hidden, dtype), nn.Linear(hidden, dim))
        self.ls2 = LayerScale(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, halfblocks: bool = False) -> torch.Tensor:
        glu, out = self.mlp
        if halfblocks:  # B4 then B5, from the tower's own weights
            attn = self.attn
            x = attention_halfblock(x, self.norm1.g, None, attn.qkv.weight, attn.qkv.bias,
                                    attn.proj.weight, attn.proj.bias, self.ls1.gamma,
                                    attn.n_heads, "rms", self.norm1.eps)
            return mlp_halfblock(x, self.norm2.g, None, glu.project.weight,
                                 glu.project.bias, out.weight, out.bias, self.ls2.gamma,
                                 "swishglu", "rms", self.norm2.eps)
        x = x + self.ls1(self.attn(self.norm1(x)))
        h = glu(self.norm2(x))
        return x + self.ls2(dense(h, out, self.dtype or h.dtype))


class VoltronViT(nn.Module):

    def __init__(self, patch_size: int = 16, embed_dim: int = 384,
                 depth: int = 12, n_heads: int = 6, img_size: int = 224):
        super().__init__()
        self.patch2embed = PatchEmbed(patch_size, embed_dim)
        self.blocks = nn.ModuleList(VoltronBlock(embed_dim, n_heads)
                                    for _ in range(depth))
        self.encoder_norm = TowerLayerNorm(embed_dim, eps=1e-6)
        pe = get_2d_sincos_pos_embed(embed_dim, img_size // patch_size)
        self.register_buffer("pos_embed", torch.from_numpy(pe), persistent=False)

    def forward(self, images: torch.Tensor, halfblocks: bool = False) -> torch.Tensor:
        """images (B, H, W, 3) -> tokens (B, n_patches, embed_dim), in the
        dtype of the images (which must match the weights'); `halfblocks`
        runs every block as B4 + B5."""
        x = self.patch2embed(images)
        x = x + self.pos_embed.to(x.dtype)[None]
        for block in self.blocks:
            x = block(x, halfblocks)
        return self.encoder_norm(x)
