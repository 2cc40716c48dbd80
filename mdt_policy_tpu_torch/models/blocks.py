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
* `bias` (False in every production config) gives the attention's output
  projection, the MLP and the biasless LayerNorms their biases, as the
  reference's flag does. `use_rot_embed` rotates q and k with rotary
  embeddings over max(n_head // 2, 32) channels (`rotary_xpos`: with xpos
  decay), and `custom_attn_mask` (boolean, True = keep) is ANDed with the
  causal mask; every block and stack passes both through, as in JAX.

The denoiser computes in float32 (the JAX default), or its block stacks in
a compute dtype (`dtype`, bf16 for `denoiser_compute_dtype="bfloat16"`):
the parameters stay float32, the GEMMs and the attention run in the dtype,
and the float32 residual stream re-promotes at every residual add. Dropout
(attention probabilities, residual, MLP) runs when a `torch.Generator` is
passed, which the train step does; without one, as in the replan, it is
off.

Where autograd records nothing (the replan, under `no_grad`), `Block` and
`ConditionedBlock` in float32 over at most `MAX_ROWS` rows (B x T) of at
most `MAX_WIDTH` channels, without a mask or a dropout generator, take the
few-row route (`_few_rows`): kernel B6 (`ops/few_row_linear.py`) runs each
norm, modulation, GEMM, activation, gate and residual of the block in one
launch per group of layers, the cross-attention inside its output
projection's launch, and B2 the self-attention: 6 launches a decoder block,
4 an encoder block, and one for the AdaLN modulations of a block or of a
whole `TransformerFiLMDecoder`. On the CPU B6's plain version computes with
the per-op path's operators.
Everything else keeps the per-op path.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch._C._functorch import is_functorch_wrapped_tensor

from ..ops.attention import dropout, sdpa
from ..ops.few_row_linear import (MAX_ROWS, MAX_WIDTH, Attend, Gemm, Norm, attention_fits,
                                  few_row_linear)
from ..ops.fused_norm import fused_layer_norm, fused_rms_norm
from ..ops.small_seq_mha import MAX_DIM, MAX_SEQ, small_seq_mha
from .position_embeddings import RotaryEmbedding

__all__ = [
    "dense", "mish", "LayerNorm", "TowerLayerNorm",
    "BiaslessLayerNorm", "RMSNorm", "SwishGLU", "Attention", "MLP", "Block",
    "CrossAttentionOnlyBlock", "AdaLNZero", "modulate", "ConditionedBlock",
    "NoiseBlock", "TransformerEncoder", "TransformerDecoder", "TransformerFiLMDecoder",
    "MAPAttention", "MAPBlock", "MeanPooling", "ClipStyleProjection",
    "SinusoidalPosEmb", "SigmaEmbedding", "TransformerEncoderInterleaved",
    "TransformerFiLMEncoder", "TransformerCrossAttentionEncoder",
    "TransformerCrossAttentionOnlyEncoder", "SiamneseDecoder",
    "TransformerFiLMDecoderInterleaved",
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


def BiaslessLayerNorm(dim: int, bias: bool = False) -> LayerNorm:
    """Weight-only LayerNorm, eps 1e-5 (ref transformer_blocks.py:29-38);
    with `bias`, an affine one."""
    return LayerNorm(dim, eps=1e-5, bias=bias)


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
    projection with `bias` (ref :66-158). Dropout on the post-softmax
    probabilities (`attn_pdrop`) and on the output (`resid_pdrop`) when a
    generator is passed. With `use_rot_embed`, q and k are rotated (float32
    tables, cast back to the compute dtype). Self-attention over at most
    `MAX_SEQ` tokens without a `custom_attn_mask`, whose probabilities see
    no dropout, runs kernel B2 (`ops/small_seq_mha.py`), which takes the
    rotated q and k as they come; everything else runs `sdpa`. `dtype`
    (None: the parameters' float32) is the compute dtype: the projections
    take their input and weights in it and the attention runs in it, while
    the parameters stay float32, as flax `Dense(dtype=...)` in the JAX
    block."""

    def __init__(self, n_embd: int, n_head: int, *, causal: bool = False,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0, bias: bool = False,
                 use_rot_embed: bool = False, rotary_xpos: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_head, self.causal, self.dtype = n_head, causal, dtype
        self.attn_pdrop, self.resid_pdrop = attn_pdrop, resid_pdrop
        self.query = nn.Linear(n_embd, n_embd)
        self.key = nn.Linear(n_embd, n_embd)
        self.value = nn.Linear(n_embd, n_embd)
        self.c_proj = nn.Linear(n_embd, n_embd, bias=bias)
        # the reference's rotary width counts heads, not head channels
        # (transformer_blocks.py:111): a head under 32 channels cannot take it
        self.rotary = RotaryEmbedding(max(n_head // 2, 32), use_xpos=rotary_xpos) \
            if use_rot_embed else None

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                custom_attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, C = x.shape
        kv_src = x if context is None else context
        q, k, v = (_project(src, layer, self.dtype)
                   .reshape(B, -1, self.n_head, C // self.n_head).transpose(1, 2)
                   for src, layer in ((x, self.query), (kv_src, self.key),
                                      (kv_src, self.value)))
        if self.rotary is not None:
            q, k = self.rotary(q, k)
            q, k = q.to(v.dtype), k.to(v.dtype)
        if context is None and custom_attn_mask is None and T <= MAX_SEQ \
                and C // self.n_head <= MAX_DIM \
                and (generator is None or self.attn_pdrop == 0.0):
            # self-attention over a short sequence, probabilities without
            # dropout: kernel B2 (its output is (B, T, H, D) in memory)
            y = small_seq_mha(q, k, v, causal=self.causal)
        else:
            y = sdpa(q, k, v, mask=custom_attn_mask, causal=self.causal,
                     dropout_p=self.attn_pdrop, generator=generator)
        y = _project(y.transpose(1, 2).reshape(B, T, C), self.c_proj, self.dtype)
        return dropout(y, self.resid_pdrop, generator)


class MLP(nn.Module):
    """4x exact-GELU MLP, biases with `bias` (ref :161-180), output dropout
    `pdrop` when a generator is passed, GEMMs in `dtype` (see Attention)."""

    def __init__(self, n_embd: int, pdrop: float = 0.0,
                 dtype: Optional[torch.dtype] = None, bias: bool = False):
        super().__init__()
        self.pdrop, self.dtype = pdrop, dtype
        self.c_fc = nn.Linear(n_embd, 4 * n_embd, bias=bias)
        self.c_proj = nn.Linear(4 * n_embd, n_embd, bias=bias)

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
                 bias: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        drops = dict(attn_pdrop=attn_pdrop, resid_pdrop=resid_pdrop, bias=bias,
                     dtype=dtype)
        self.ln_1 = BiaslessLayerNorm(n_embd, bias)
        self.attn = Attention(n_embd, n_heads, causal=causal, **drops)
        if use_cross_attention:
            self.ln3 = LayerNorm(n_embd, eps=1e-6)
            self.cross_att = Attention(n_embd, n_heads, causal=causal, **drops)
        self.ln_2 = BiaslessLayerNorm(n_embd, bias)
        self.mlp = MLP(n_embd, mlp_pdrop, dtype, bias)

    def forward(self, x, context=None, generator=None, custom_attn_mask=None):
        if _few_rows(self, x, context, generator, custom_attn_mask):
            B, T, C = x.shape
            rows = _attention_rows(self, x.reshape(B * T, C), B, context, _norm(self.ln_1))
            return _mlp_rows(self.mlp, rows, _norm(self.ln_2)).reshape(B, T, C)
        x = x + self.attn(self.ln_1(x), generator=generator,
                          custom_attn_mask=custom_attn_mask)
        if context is not None and hasattr(self, "cross_att"):
            x = x + self.cross_att(self.ln3(x), context, generator, custom_attn_mask)
        return x + self.mlp(self.ln_2(x), generator)


class CrossAttentionOnlyBlock(nn.Module):
    """Cross-attention to the context (self-attention without one), then
    the MLP (ref :218-242)."""

    def __init__(self, n_embd: int, n_heads: int, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, mlp_pdrop: float = 0.0, *,
                 causal: bool = False, bias: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ln_1 = BiaslessLayerNorm(n_embd, bias)
        self.cross_att = Attention(n_embd, n_heads, causal=causal, attn_pdrop=attn_pdrop,
                                   resid_pdrop=resid_pdrop, bias=bias, dtype=dtype)
        self.ln_2 = BiaslessLayerNorm(n_embd, bias)
        self.mlp = MLP(n_embd, mlp_pdrop, dtype, bias)

    def forward(self, x, context=None, generator=None, custom_attn_mask=None):
        x = x + self.cross_att(self.ln_1(x), context, generator, custom_attn_mask)
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
    """AdaLN-conditioned self-attention and MLP, plain cross-attention to
    the context (ref :266-309). The defaults are the decoder's block:
    causal, with cross-attention (the FiLM encoder's is neither). The
    modulation, from a `film_cond_dim`-wide `c` (default `n_embd`), stays
    float32; `dtype` as in Block."""

    def __init__(self, n_embd: int, n_heads: int, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, mlp_pdrop: float = 0.0, *,
                 causal: bool = True, use_cross_attention: bool = True,
                 bias: bool = False, film_cond_dim: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        drops = dict(attn_pdrop=attn_pdrop, resid_pdrop=resid_pdrop, bias=bias,
                     dtype=dtype)
        self.ln_1 = BiaslessLayerNorm(n_embd, bias)
        self.attn = Attention(n_embd, n_heads, causal=causal, **drops)
        if use_cross_attention:
            # causal as in the JAX block: a (10, n_context) lower-triangular mask
            self.ln3 = LayerNorm(n_embd, eps=1e-6)
            self.cross_att = Attention(n_embd, n_heads, causal=causal, **drops)
        self.ln_2 = BiaslessLayerNorm(n_embd, bias)
        self.mlp = MLP(n_embd, mlp_pdrop, dtype, bias)
        cond_dim = film_cond_dim or n_embd
        self.adaLN_zero = AdaLNZero(cond_dim, cond_dim)

    def forward(self, x, c, context=None, generator=None, custom_attn_mask=None):
        if _few_rows(self, x, context, generator, custom_attn_mask, c):
            mod, = few_row_linear(self.modulation_gemm(c))
            return self.few_rows(x, mod, context)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            self.adaLN_zero(c)
        x = x + gate_msa * self.attn(modulate(self.ln_1(x), shift_msa, scale_msa),
                                     generator=generator,
                                     custom_attn_mask=custom_attn_mask)
        if context is not None and hasattr(self, "cross_att"):
            x = x + self.cross_att(self.ln3(x), context, generator, custom_attn_mask)
        return x + gate_mlp * self.mlp(modulate(self.ln_2(x), shift_mlp, scale_mlp),
                                       generator)

    def modulation_gemm(self, c: torch.Tensor) -> Gemm:
        """The AdaLN modulation of `c` (B, Tc, cond) as a B6 gemm: (B Tc, 6C)."""
        return Gemm(c.reshape(-1, c.shape[-1]), (self.adaLN_zero.modulation[1],), "silu")

    def few_rows(self, x: torch.Tensor, mod: torch.Tensor,
                 context: Optional[torch.Tensor]) -> torch.Tensor:
        """The block on the few-row route, given its modulation rows `mod`
        (`modulation_gemm`'s output)."""
        B, T, C = x.shape
        per = B * T // mod.shape[0]
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        rows = _attention_rows(self, x.reshape(B * T, C), B, context,
                               _norm(self.ln_1, shift_msa, scale_msa), gate_msa, per)
        return _mlp_rows(self.mlp, rows, _norm(self.ln_2, shift_mlp, scale_mlp), gate_mlp,
                         per).reshape(B, T, C)


def _few_rows(block, x, context, generator, custom_attn_mask, c=None) -> bool:
    """Whether `block` (a `Block` or a `ConditionedBlock`) takes the few-row
    route: autograd off, float32, at most `MAX_ROWS` rows of at most
    `MAX_WIDTH` channels (B6's limits), no mask, no
    dropout generator, no `torch.func` transform, self-attention within
    B2's reach, no rotary embedding; with cross-attention, the context within
    B6's attention prologue; with a conditioning `c`, one row a sequence or
    a token."""
    B, T, C = x.shape
    attn = block.attn
    if torch.is_grad_enabled() or generator is not None or custom_attn_mask is not None \
            or B * T > MAX_ROWS or attn.dtype not in (None, torch.float32) or C % 4 \
            or C > MAX_WIDTH or C // attn.n_head > MAX_DIM or attn.rotary is not None:
        return False
    inputs = [t for t in (x, context, c) if t is not None]
    if any(t.dtype != torch.float32 or is_functorch_wrapped_tensor(t) for t in inputs):
        return False
    if c is not None and (c.dim() != 3 or c.shape[0] != B or c.shape[1] not in (1, T)
                          or c.shape[-1] % 4):
        return False
    if context is not None and hasattr(block, "cross_att"):
        ca = block.cross_att
        if ca.rotary is not None or context.dim() != 3 or context.shape[0] != B or \
                not attention_fits(B * T, C, B * context.shape[1], ca.n_head):
            return False
    return True


def _norm(ln: LayerNorm, shift=None, scale=None) -> Norm:
    return Norm(ln.weight, ln.bias, ln.eps, shift, scale)


def _attention_rows(block, rows, B, context, norm, gate=None, per=1):
    """rows + [gate *] attn(norm(rows)), then, with a context and
    cross-attention, + cross_att(ln3(.), context), on B6 and B2: (B T, C)
    rows in and out. The context's keys and values share the first launch."""
    attn, C = block.attn, rows.shape[1]
    T = rows.shape[0] // B
    cross = block.cross_att if context is not None and hasattr(block, "cross_att") else None
    gemms = [Gemm(rows, (attn.query, attn.key, attn.value), norm, per=per)]
    if cross is not None:
        gemms.append(Gemm(context.reshape(-1, C), (cross.key, cross.value)))
    qkv, *kv = few_row_linear(*gemms)
    q, k, v = (t.reshape(B, T, attn.n_head, -1).transpose(1, 2) for t in qkv.split(C, dim=1))
    y = small_seq_mha(q, k, v, causal=attn.causal).transpose(1, 2).reshape(B * T, C)
    rows, = few_row_linear(Gemm(y, (attn.c_proj,), residual=rows, gate=gate, per=per))
    if cross is None:
        return rows
    q, = few_row_linear(Gemm(rows, (cross.query,), _norm(block.ln3)))
    rows, = few_row_linear(Gemm(None, (cross.c_proj,), Attend(q, kv[0], cross.n_head, B,
                                                               cross.causal), residual=rows))
    return rows


def _mlp_rows(mlp, rows, norm, gate=None, per=1):
    """rows + [gate *] mlp(norm(rows)) on B6: two launches."""
    h, = few_row_linear(Gemm(rows, (mlp.c_fc,), norm, gelu=True, per=per))
    rows, = few_row_linear(Gemm(h, (mlp.c_proj,), residual=rows, gate=gate, per=per))
    return rows


class NoiseBlock(nn.Module):
    """Block of the noise encoder (ref :311-341): the sigma token `c` added
    to the normed input of the self-attention and of the cross-attention;
    the MLP unconditioned. Defaults as ConditionedBlock's; `dtype` as in
    Block."""

    def __init__(self, n_embd: int, n_heads: int, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, mlp_pdrop: float = 0.0, *,
                 causal: bool = True, use_cross_attention: bool = True,
                 bias: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        drops = dict(attn_pdrop=attn_pdrop, resid_pdrop=resid_pdrop, bias=bias,
                     dtype=dtype)
        self.ln_1 = BiaslessLayerNorm(n_embd, bias)
        self.attn = Attention(n_embd, n_heads, causal=causal, **drops)
        if use_cross_attention:
            self.ln3 = LayerNorm(n_embd, eps=1e-6)
            self.cross_att = Attention(n_embd, n_heads, causal=causal, **drops)
        self.ln_2 = BiaslessLayerNorm(n_embd, bias)
        self.mlp = MLP(n_embd, mlp_pdrop, dtype, bias)

    def forward(self, x, c, context=None, generator=None, custom_attn_mask=None):
        x = x + self.attn(self.ln_1(x) + c, generator=generator,
                          custom_attn_mask=custom_attn_mask)
        if context is not None and hasattr(self, "cross_att"):
            x = x + self.cross_att(self.ln3(x) + c, context, generator, custom_attn_mask)
        return x + self.mlp(self.ln_2(x), generator)


class _Stack(nn.Module):
    """`blocks` and the final biasless LayerNorm `ln` of a block stack."""

    def __init__(self, blocks, embed_dim: int, bias: bool):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.ln = BiaslessLayerNorm(embed_dim, bias)


class TransformerEncoder(_Stack):
    """Non-causal block stack + final biasless LN (ref :344-380)."""

    def __init__(self, embed_dim: int, n_heads: int, n_layers: int,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                 mlp_pdrop: float = 0.0, *, bias: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__((Block(embed_dim, n_heads, attn_pdrop, resid_pdrop, mlp_pdrop,
                                bias=bias, dtype=dtype) for _ in range(n_layers)),
                         embed_dim, bias)

    def forward(self, x, generator=None, custom_attn_mask=None):
        for block in self.blocks:
            x = block(x, generator=generator, custom_attn_mask=custom_attn_mask)
        return self.ln(x)


class TransformerDecoder(_Stack):
    """Causal block stack with cross-attention to the context, no sigma
    conditioning in the blocks (ref :467-505): the decoder of the
    sigma-token configs, whose encoder sees sigma."""

    def __init__(self, embed_dim: int, n_heads: int, n_layers: int,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                 mlp_pdrop: float = 0.0, *, bias: bool = False,
                 use_cross_attention: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__((Block(embed_dim, n_heads, attn_pdrop, resid_pdrop, mlp_pdrop,
                                causal=True, use_cross_attention=use_cross_attention,
                                bias=bias, dtype=dtype) for _ in range(n_layers)),
                         embed_dim, bias)

    def forward(self, x, context=None, generator=None, custom_attn_mask=None):
        for block in self.blocks:
            x = block(x, context, generator, custom_attn_mask)
        return self.ln(x)


class TransformerFiLMDecoder(_Stack):
    """Causal sigma-conditioned decoder with cross-attention (ref
    :509-569): AdaLN blocks, or `NoiseBlock`s with `use_noise_encoder`."""

    def __init__(self, embed_dim: int, n_heads: int, n_layers: int,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                 mlp_pdrop: float = 0.0, *, use_noise_encoder: bool = False,
                 bias: bool = False, use_cross_attention: bool = True,
                 film_cond_dim: int = 0, dtype: Optional[torch.dtype] = None):
        kw = dict(causal=True, use_cross_attention=use_cross_attention, bias=bias,
                  dtype=dtype)
        if not use_noise_encoder:
            kw["film_cond_dim"] = film_cond_dim
        block = NoiseBlock if use_noise_encoder else ConditionedBlock
        super().__init__((block(embed_dim, n_heads, attn_pdrop, resid_pdrop, mlp_pdrop, **kw)
                          for _ in range(n_layers)), embed_dim, bias)

    def forward(self, x, c, context=None, generator=None, custom_attn_mask=None):
        blocks = self.blocks
        if isinstance(blocks[0], ConditionedBlock) and \
                _few_rows(blocks[0], x, context, generator, custom_attn_mask, c):
            # the blocks' AdaLN linears all read c: their modulations in one launch
            mods = few_row_linear(*(block.modulation_gemm(c) for block in blocks))
            for block, mod in zip(blocks, mods):
                x = block.few_rows(x, mod, context)
            return self.ln(x)
        for block in blocks:
            x = block(x, c, context, generator, custom_attn_mask)
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


class MeanPooling(nn.Module):
    """Token mean -> (B, token_dim) (ref :873-879)."""

    def __init__(self, token_dim: int):
        super().__init__()
        self.token_dim = token_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=1).reshape(-1, self.token_dim)


CLIP_STYLES = ("map", "map_state_only", "mean_pooling", "mean_pool_state_only", "mlp",
               "single_token", "multihead")


class ClipStyleProjection(nn.Module):
    """Latent -> contrastive-embedding head (JAX blocks.py:463-493; ref
    :835-870), by `clip_style`: "map" (MDT-V: one MAPBlock latent, 8 heads,
    over the whole context) or "map_state_only" (without the first token);
    "mean_pooling" or "mean_pool_state_only"; "mlp" (the flattened
    `num_token` tokens through a Linear, a flax default LayerNorm, eps 1e-6,
    and tanh; flax infers the Linear's input width, here
    `num_token * token_dim`); "single_token" (MDT: the token at
    `clip_token_index`, no parameters); "multihead" (the tokens as they
    are)."""

    def __init__(self, clip_style: str = "map", token_dim: int = 384,
                 clip_token_index: int = 0, num_token: int = 4):
        super().__init__()
        if clip_style not in CLIP_STYLES:
            raise ValueError(f"Invalid clip_style: {clip_style!r}")
        self.clip_style, self.clip_token_index = clip_style, clip_token_index
        if clip_style.startswith("map"):
            self.latent_proj = MAPBlock(1, token_dim, 8, output_dim=token_dim)
        elif clip_style.startswith("mean"):
            self.latent_proj = MeanPooling(token_dim)
        elif clip_style == "mlp":
            self.latent_proj = nn.Linear(num_token * token_dim, token_dim)
            self.latent_norm = LayerNorm(token_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        style = self.clip_style
        if style == "single_token":
            return x[:, self.clip_token_index, :]
        if style == "multihead":
            return x
        if style.endswith("state_only"):
            x = x[:, 1:]
        if style == "mlp":
            return torch.tanh(self.latent_norm(self.latent_proj(x.reshape(x.shape[0], -1))))
        return self.latent_proj(x)


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


class TransformerEncoderInterleaved(_Stack):
    """Non-causal encoder returning every layer's output, the last after
    the final LN, for the interleaved decoder (ref :383-423)."""

    def __init__(self, embed_dim: int, n_heads: int, n_layers: int,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                 mlp_pdrop: float = 0.0, *, bias: bool = False):
        super().__init__((Block(embed_dim, n_heads, attn_pdrop, resid_pdrop, mlp_pdrop,
                                bias=bias) for _ in range(n_layers)), embed_dim, bias)

    def forward(self, x, generator=None):
        outputs = []
        for block in self.blocks:
            x = block(x, generator=generator)
            outputs.append(x)
        outputs[-1] = self.ln(x)
        return outputs


class TransformerFiLMEncoder(_Stack):
    """Non-causal AdaLN-conditioned encoder without cross-attention (ref
    :426-464)."""

    def __init__(self, embed_dim: int, n_heads: int, n_layers: int, film_cond_dim: int,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                 mlp_pdrop: float = 0.0, *, bias: bool = False):
        super().__init__((ConditionedBlock(embed_dim, n_heads, attn_pdrop, resid_pdrop,
                                           mlp_pdrop, causal=False,
                                           use_cross_attention=False, bias=bias,
                                           film_cond_dim=film_cond_dim)
                          for _ in range(n_layers)), embed_dim, bias)

    def forward(self, x, c, generator=None):
        for block in self.blocks:
            x = block(x, c, generator=generator)
        return self.ln(x)


class TransformerCrossAttentionEncoder(_Stack):
    """Non-causal blocks with self- and cross-attention (ref :636-674)."""

    def __init__(self, embed_dim: int, n_heads: int, n_layers: int,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                 mlp_pdrop: float = 0.0, *, bias: bool = False):
        super().__init__((Block(embed_dim, n_heads, attn_pdrop, resid_pdrop, mlp_pdrop,
                                use_cross_attention=True, bias=bias)
                          for _ in range(n_layers)), embed_dim, bias)

    def forward(self, x, cond=None, generator=None):
        for block in self.blocks:
            x = block(x, cond, generator)
        return self.ln(x)


class SiamneseDecoder(TransformerCrossAttentionEncoder):
    """Non-causal cross-attention decoder (ref :794-832; the reference's
    spelling): the same stack as TransformerCrossAttentionEncoder."""


class TransformerCrossAttentionOnlyEncoder(_Stack):
    """Stack of cross-attention-only blocks (ref :677-714)."""

    def __init__(self, embed_dim: int, n_heads: int, n_layers: int,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                 mlp_pdrop: float = 0.0, *, bias: bool = False):
        super().__init__((CrossAttentionOnlyBlock(embed_dim, n_heads, attn_pdrop,
                                                  resid_pdrop, mlp_pdrop, bias=bias)
                          for _ in range(n_layers)), embed_dim, bias)

    def forward(self, x, cond=None, generator=None):
        for block in self.blocks:
            x = block(x, cond, generator)
        return self.ln(x)


class TransformerFiLMDecoderInterleaved(_Stack):
    """Causal AdaLN (or, with `use_noise_encoder`, noise-block) decoder
    whose layer i cross-attends to `conds[i]`, an interleaved encoder's
    outputs (ref :572-633)."""

    def __init__(self, embed_dim: int, n_heads: int, n_layers: int, film_cond_dim: int,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                 mlp_pdrop: float = 0.0, *, bias: bool = False,
                 use_noise_encoder: bool = False):
        kw = {} if use_noise_encoder else {"film_cond_dim": film_cond_dim}
        block = NoiseBlock if use_noise_encoder else ConditionedBlock
        super().__init__((block(embed_dim, n_heads, attn_pdrop, resid_pdrop, mlp_pdrop,
                                bias=bias, **kw) for _ in range(n_layers)), embed_dim, bias)

    def forward(self, x, c, conds, generator=None):
        for i, block in enumerate(self.blocks):
            x = block(x, c, conds[i], generator)
        return self.ln(x)
