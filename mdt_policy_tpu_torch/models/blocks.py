"""Transformer building blocks of the MDT denoiser (port of
`mdt_policy_tpu/models/blocks.py`), with the reference's `state_dict` key
layout (the one `mdt_policy_tpu/utils/torch_port.py` reads).

Numerics kept from the JAX package:

* LayerNorms compute statistics and affine in float32 and cast the result
  (flax semantics). `BiaslessLayerNorm` has eps 1e-5; the cross-attention
  pre-norm `ln3` is a flax default LayerNorm, eps 1e-6, with bias.
* `RMSNorm` is x / max(||x||_2 * D^-1/2, eps) * g with the norm in float32,
  through kernel B3 (`ops/fused_norm.py`); so is `TowerLayerNorm`, the
  affine LayerNorm of the CLIP and Voltron towers. B3 takes the statistics
  and the affine step in float32 and rounds once.
* `modulate(x, shift, scale) = shift + x * scale` (not the DiT convention).

The denoiser computes in float32 (the JAX default), or its block stacks in
a compute dtype (`dtype`, bf16 for `denoiser_compute_dtype="bfloat16"`):
the parameters stay float32, the GEMMs and the attention run in the dtype,
and the float32 residual stream re-promotes at every residual add. Dropout
(attention probabilities, residual, MLP) runs when a `torch.Generator` is
passed, which the train step does; without one, as in the replan, it is
off.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dropout, sdpa
from ..ops.fused_norm import fused_layer_norm, fused_rms_norm
from ..ops.small_seq_mha import MAX_DIM, MAX_SEQ, small_seq_mha

__all__ = [
    "dense", "mish", "LayerNorm", "TowerLayerNorm",
    "BiaslessLayerNorm", "RMSNorm", "SwishGLU", "Attention", "MLP", "Block",
    "AdaLNZero", "modulate", "ConditionedBlock", "NoiseBlock", "TransformerEncoder",
    "TransformerDecoder", "TransformerFiLMDecoder", "MAPAttention", "MAPBlock",
    "ClipStyleProjection", "SingleTokenProjection", "SinusoidalPosEmb",
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


class TowerLayerNorm(LayerNorm):
    """Affine LayerNorm of the frozen towers (CLIP `ln_*`, Voltron's
    `encoder_norm`), through kernel B3: f32 statistics and affine, output in
    the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm(x.contiguous(), self.weight, self.bias, self.eps)


def BiaslessLayerNorm(dim: int) -> LayerNorm:
    """Weight-only LayerNorm, eps 1e-5 (ref transformer_blocks.py:29-38)."""
    return LayerNorm(dim, eps=1e-5, bias=False)


class RMSNorm(nn.Module):
    """x / max(||x||_2 * D^-1/2, eps) * g (ref transformer_blocks.py:43-51)
    through kernel B3: norm and scaling in float32, output in the input's
    dtype. `dtype` casts `g` first, as the JAX module does for an f32 master
    weight that computes in bf16 (the foresight decoder)."""

    def __init__(self, dim: int, eps: float = 1e-8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.g if self.dtype is None else self.g.to(self.dtype)
        return fused_rms_norm(x.contiguous(), g, self.eps)


class SwishGLU(nn.Module):
    """project -> [projected | gate] -> projected * silu(gate)."""

    def __init__(self, in_dim: int, out_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.project = nn.Linear(in_dim, 2 * out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.project(x) if self.dtype is None \
            else dense(x, self.project, self.dtype)
        projected, gate = h.chunk(2, dim=-1)
        return projected * F.silu(gate)


def _project(x: torch.Tensor, layer: nn.Linear,
             dtype: Optional[torch.dtype]) -> torch.Tensor:
    """`layer(x)`, or computed in `dtype` when one is given."""
    return layer(x) if dtype is None else dense(x, layer, dtype)


class Attention(nn.Module):
    """Self (context None) or cross attention; q/k/v with bias, the output
    projection without (ref :66-158, bias=False). Dropout on the
    post-softmax probabilities (`attn_pdrop`) and on the output
    (`resid_pdrop`) when a generator is passed. Self-attention over at most
    `MAX_SEQ` tokens whose probabilities see no dropout runs kernel B2
    (`ops/small_seq_mha.py`); everything else runs `sdpa`. `dtype` (None:
    the parameters' float32) is the compute dtype: the projections take
    their input and weights in it and the attention runs in it, while the
    parameters stay float32, as flax `Dense(dtype=...)` in the JAX block."""

    def __init__(self, n_embd: int, n_head: int, *, causal: bool = False,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_head, self.causal, self.dtype = n_head, causal, dtype
        self.attn_pdrop, self.resid_pdrop = attn_pdrop, resid_pdrop
        self.query = nn.Linear(n_embd, n_embd)
        self.key = nn.Linear(n_embd, n_embd)
        self.value = nn.Linear(n_embd, n_embd)
        self.c_proj = nn.Linear(n_embd, n_embd, bias=False)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, C = x.shape
        kv_src = x if context is None else context
        q, k, v = (_project(src, layer, self.dtype)
                   .reshape(B, -1, self.n_head, C // self.n_head).transpose(1, 2)
                   for src, layer in ((x, self.query), (kv_src, self.key),
                                      (kv_src, self.value)))
        if context is None and T <= MAX_SEQ and C // self.n_head <= MAX_DIM \
                and (generator is None or self.attn_pdrop == 0.0):
            # self-attention over a short sequence, probabilities without
            # dropout: kernel B2 (its output is (B, T, H, D) in memory)
            y = small_seq_mha(q, k, v, causal=self.causal)
        else:
            y = sdpa(q, k, v, causal=self.causal, dropout_p=self.attn_pdrop,
                     generator=generator)
        y = _project(y.transpose(1, 2).reshape(B, T, C), self.c_proj, self.dtype)
        return dropout(y, self.resid_pdrop, generator)


class MLP(nn.Module):
    """4x exact-GELU MLP without biases (ref :161-180), output dropout
    `pdrop` when a generator is passed, GEMMs in `dtype` (see Attention)."""

    def __init__(self, n_embd: int, pdrop: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.pdrop, self.dtype = pdrop, dtype
        self.c_fc = nn.Linear(n_embd, 4 * n_embd, bias=False)
        self.c_proj = nn.Linear(4 * n_embd, n_embd, bias=False)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.gelu(_project(x, self.c_fc, self.dtype))
        return dropout(_project(h, self.c_proj, self.dtype), self.pdrop, generator)


class Block(nn.Module):
    """Pre-LN block (ref :183-214): self-attention, causal or not, then,
    with `use_cross_attention`, cross-attention to a context behind the
    affine `ln3` (flax default, eps 1e-6), then the MLP. The encoder's
    block is non-causal without cross-attention; `TransformerDecoder`'s is
    causal with it. The residual stream stays float32 whatever `dtype`."""

    def __init__(self, n_embd: int, n_heads: int, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, mlp_pdrop: float = 0.0, *,
                 causal: bool = False, use_cross_attention: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        drops = dict(attn_pdrop=attn_pdrop, resid_pdrop=resid_pdrop, dtype=dtype)
        self.ln_1 = BiaslessLayerNorm(n_embd)
        self.attn = Attention(n_embd, n_heads, causal=causal, **drops)
        if use_cross_attention:
            self.ln3 = LayerNorm(n_embd, eps=1e-6)
            self.cross_att = Attention(n_embd, n_heads, causal=causal, **drops)
        self.ln_2 = BiaslessLayerNorm(n_embd)
        self.mlp = MLP(n_embd, mlp_pdrop, dtype)

    def forward(self, x, context=None, generator=None):
        x = x + self.attn(self.ln_1(x), generator=generator)
        if context is not None and hasattr(self, "cross_att"):
            x = x + self.cross_att(self.ln3(x), context, generator)
        return x + self.mlp(self.ln_2(x), generator)


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
    cross-attention to the encoder context (ref :266-309). The modulation
    stays float32; `dtype` as in Block."""

    def __init__(self, n_embd: int, n_heads: int, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, mlp_pdrop: float = 0.0, *,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        drops = dict(attn_pdrop=attn_pdrop, resid_pdrop=resid_pdrop, dtype=dtype)
        self.ln_1 = BiaslessLayerNorm(n_embd)
        self.attn = Attention(n_embd, n_heads, causal=True, **drops)
        self.ln3 = LayerNorm(n_embd, eps=1e-6)
        # causal as in the JAX block: a (10, n_context) lower-triangular mask
        self.cross_att = Attention(n_embd, n_heads, causal=True, **drops)
        self.ln_2 = BiaslessLayerNorm(n_embd)
        self.mlp = MLP(n_embd, mlp_pdrop, dtype)
        self.adaLN_zero = AdaLNZero(n_embd, n_embd)

    def forward(self, x, c, context, generator=None):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            self.adaLN_zero(c)
        x = x + gate_msa * self.attn(modulate(self.ln_1(x), shift_msa, scale_msa),
                                     generator=generator)
        x = x + self.cross_att(self.ln3(x), context, generator)
        return x + gate_mlp * self.mlp(modulate(self.ln_2(x), shift_mlp, scale_mlp),
                                       generator)


class NoiseBlock(nn.Module):
    """Decoder block of the noise encoder (ref :311-341): the sigma token
    `c` added to the normed input of the causal self-attention and of the
    causal cross-attention; the MLP unconditioned. `dtype` as in Block."""

    def __init__(self, n_embd: int, n_heads: int, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, mlp_pdrop: float = 0.0, *,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        drops = dict(attn_pdrop=attn_pdrop, resid_pdrop=resid_pdrop, dtype=dtype)
        self.ln_1 = BiaslessLayerNorm(n_embd)
        self.attn = Attention(n_embd, n_heads, causal=True, **drops)
        self.ln3 = LayerNorm(n_embd, eps=1e-6)
        self.cross_att = Attention(n_embd, n_heads, causal=True, **drops)
        self.ln_2 = BiaslessLayerNorm(n_embd)
        self.mlp = MLP(n_embd, mlp_pdrop, dtype)

    def forward(self, x, c, context, generator=None):
        x = x + self.attn(self.ln_1(x) + c, generator=generator)
        x = x + self.cross_att(self.ln3(x) + c, context, generator)
        return x + self.mlp(self.ln_2(x), generator)


class TransformerEncoder(nn.Module):
    """Non-causal block stack + final biasless LN (ref :344-380)."""

    def __init__(self, embed_dim: int, n_heads: int, n_layers: int,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                 mlp_pdrop: float = 0.0, *, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(embed_dim, n_heads, attn_pdrop, resid_pdrop, mlp_pdrop, dtype=dtype)
            for _ in range(n_layers))
        self.ln = BiaslessLayerNorm(embed_dim)

    def forward(self, x, generator=None):
        for block in self.blocks:
            x = block(x, generator=generator)
        return self.ln(x)


class TransformerDecoder(nn.Module):
    """Causal block stack with cross-attention to the context, no sigma
    conditioning in the blocks (ref :467-505): the decoder of the
    sigma-token configs, whose encoder sees sigma."""

    def __init__(self, embed_dim: int, n_heads: int, n_layers: int,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                 mlp_pdrop: float = 0.0, *, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(embed_dim, n_heads, attn_pdrop, resid_pdrop, mlp_pdrop, causal=True,
                  use_cross_attention=True, dtype=dtype)
            for _ in range(n_layers))
        self.ln = BiaslessLayerNorm(embed_dim)

    def forward(self, x, context, generator=None):
        for block in self.blocks:
            x = block(x, context, generator)
        return self.ln(x)


class TransformerFiLMDecoder(nn.Module):
    """Causal sigma-conditioned decoder with cross-attention (ref
    :509-569): AdaLN blocks, or `NoiseBlock`s with `use_noise_encoder`."""

    def __init__(self, embed_dim: int, n_heads: int, n_layers: int,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                 mlp_pdrop: float = 0.0, *, use_noise_encoder: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        block = NoiseBlock if use_noise_encoder else ConditionedBlock
        self.blocks = nn.ModuleList(
            block(embed_dim, n_heads, attn_pdrop, resid_pdrop, mlp_pdrop, dtype=dtype)
            for _ in range(n_layers))
        self.ln = BiaslessLayerNorm(embed_dim)

    def forward(self, x, c, context, generator=None):
        for block in self.blocks:
            x = block(x, c, context, generator)
        return self.ln(x)


class MAPAttention(nn.Module):
    """Multihead attention pooling: latent queries over the input tokens,
    q and kv without bias, the output projection with (JAX blocks.py:405-422;
    ref :718-744)."""

    def __init__(self, embed_dim: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.q = nn.Linear(embed_dim, embed_dim, bias=False)
        self.kv = nn.Linear(embed_dim, 2 * embed_dim, bias=False)
        self.proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, seed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        B, K, C = seed.shape
        heads = lambda t: t.reshape(B, -1, self.n_heads, C // self.n_heads).transpose(1, 2)
        k, v = self.kv(x).chunk(2, dim=-1)
        out = sdpa(heads(self.q(seed)), heads(k), heads(v))
        return self.proj(out.transpose(1, 2).reshape(B, K, C))


class MAPBlock(nn.Module):
    """Attention pooling block with RMSNorm post-norms and a SwishGLU MLP
    (JAX blocks.py:425-452; ref :747-791). Keys as `port_mdtv_agent` reads
    them: `latents`, `projection`, `attn_norm`, `attn.{q,kv,proj}`,
    `mlp_norm`, `mlp.0.project`, `mlp.1`."""

    def __init__(self, n_latents: int, embed_dim: int, n_heads: int,
                 output_dim: int, mlp_ratio: float = 4.0):
        super().__init__()
        d, hidden = output_dim, int(mlp_ratio * output_dim)
        self.n_latents = n_latents
        self.latents = nn.Parameter(torch.zeros(n_latents, d))
        self.projection = nn.Linear(embed_dim, d)
        self.attn_norm = RMSNorm(d)
        self.attn = MAPAttention(d, n_heads)
        self.mlp_norm = RMSNorm(d)
        self.mlp = nn.Sequential(SwishGLU(d, hidden), nn.Linear(hidden, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        latents = self.latents[None].expand(x.shape[0], -1, -1)
        latents = self.attn_norm(latents + self.attn(latents, self.projection(x)))
        latents = self.mlp_norm(latents + self.mlp(latents))
        return latents.squeeze(1) if self.n_latents == 1 else latents


class ClipStyleProjection(nn.Module):
    """Latent -> contrastive-embedding head (JAX blocks.py:463-493) in the
    MDT-V style, "map": one MAPBlock latent, 8 heads, over the whole context.
    The other styles are not ported (ROADMAP queue A, "The rest, behind
    the production defaults")."""

    def __init__(self, token_dim: int = 384):
        super().__init__()
        self.latent_proj = MAPBlock(1, token_dim, 8, output_dim=token_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.latent_proj(x)


class SingleTokenProjection(nn.Module):
    """The parameter-free "single_token" contrastive head of MDT (JAX
    blocks.py:478-479): the context token at `index`."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, self.index, :]


class SinusoidalPosEmb(nn.Module):
    """Log-spaced sinusoidal embedding (ref mdtv_transformer.py:13-25)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        # float32 throughout, as the JAX version computes it: the f32 value of
        # log(1e4) / (dim // 2 - 1), held exactly by a Python float, so that
        # a call copies no host tensor to the device (a CUDA graph captures it)
        self.emb_scale = (torch.tensor(math.log(10000.0), dtype=torch.float32)
                          / (dim // 2 - 1)).item()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        freqs = torch.exp(torch.arange(self.dim // 2, dtype=torch.float32,
                                       device=x.device) * -self.emb_scale)
        emb = x[..., None] * freqs
        return torch.cat([emb.sin(), emb.cos()], dim=-1)


class SigmaEmbedding(nn.Sequential):
    """Sinusoidal -> Linear(2d) -> Mish -> Linear(d) (ref
    mdtv_transformer.py:169-174); keys `1.*` and `3.*` as in the reference."""

    def __init__(self, embed_dim: int):
        super().__init__(SinusoidalPosEmb(embed_dim),
                         nn.Linear(embed_dim, 2 * embed_dim), nn.Mish(),
                         nn.Linear(2 * embed_dim, embed_dim))
