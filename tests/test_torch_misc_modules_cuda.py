"""The kernel routes of the modules added with the language annotator and
the rest of the block library, on the card, against their plain routes
(every kernel call site patched to its plain version): MiniLM (B3 over f32
rows of width 384, eps 1e-12), rotary self-attention (B2 on the rotated,
contiguous q and k), a masked encoder (no B2), and the bf16 towers of
`CLIPVisionTokens` and `VoltronMAPEncoder` (B1, B3). They need neither JAX
nor `transformers`; on a GPU machine without JAX:

    python -m pytest tests/test_torch_misc_modules_cuda.py -m cuda --noconftest

Tolerance, relative to max(1, max |plain|): 1e-4 in f32 (summation order),
6e-2 for the bf16 towers (bf16 rounding of 2 to 12 layers)."""

import contextlib
from unittest import mock

import pytest
import torch

from mdt_policy_tpu_torch.agents import init_random_
from mdt_policy_tpu_torch.models import blocks, clip, encoders_misc, voltron_vit
from mdt_policy_tpu_torch.models.minilm import MINILM_L3_CONFIG, MiniLMEncoder
from mdt_policy_tpu_torch.ops.fused_norm import (fused_layer_norm, fused_layer_norm_reference,
                                                 fused_rms_norm_reference)
from mdt_policy_tpu_torch.ops.fused_qkv_attention import (fused_qkv_attention,
                                                          fused_qkv_attention_reference)
from mdt_policy_tpu_torch.ops.small_seq_mha import small_seq_mha, small_seq_mha_reference


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@contextlib.contextmanager
def plain_route():
    with mock.patch.object(blocks, "small_seq_mha", small_seq_mha_reference), \
            mock.patch.object(blocks, "fused_layer_norm", fused_layer_norm_reference), \
            mock.patch.object(blocks, "fused_rms_norm", fused_rms_norm_reference), \
            mock.patch.object(clip, "fused_qkv_attention", fused_qkv_attention_reference), \
            mock.patch.object(voltron_vit, "fused_qkv_attention",
                              fused_qkv_attention_reference):
        yield


def _compare(module, args, kwargs, tol, kernel, launches):
    before = kernel.launches
    with torch.no_grad():
        out = module(*args, **kwargs)
        torch.cuda.synchronize()
        assert kernel.launches - before == launches
        with plain_route():
            ref = module(*args, **kwargs)
    scale = max(1.0, ref.float().abs().max().item())
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol * scale


def _build(module, cuda, seed=0):
    return init_random_(module, torch.Generator().manual_seed(seed)).to(cuda).eval()


@pytest.mark.cuda
def test_cuda_minilm_layer_norms_run_b3(cuda):
    enc = _build(MiniLMEncoder(**MINILM_L3_CONFIG), cuda)
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 30522, (4, 128), generator=gen).to(cuda)
    mask = torch.zeros(4, 128, dtype=torch.long, device=cuda)
    for row, n in enumerate((128, 40, 7, 1)):
        mask[row, :n] = 1
    # embeddings LN + 2 a layer
    _compare(enc, (ids, mask), {}, 1e-4, fused_layer_norm, 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rotary_attention_and_masked_encoder(cuda, dtype):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(32, 10, 384, generator=gen).to(cuda)
    attn = _build(blocks.Attention(384, 8, causal=True, use_rot_embed=True, rotary_xpos=True,
                                   dtype=dtype), cuda)
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    _compare(attn, (x,), {}, tol, small_seq_mha, 1)
    enc = _build(blocks.TransformerEncoder(384, 8, 4, dtype=dtype), cuda)
    mask = (torch.rand(10, 10, generator=gen) > 0.3).fill_diagonal_(True).to(cuda)
    _compare(enc, (x,), {"custom_attn_mask": mask}, tol, small_seq_mha, 0)
    _compare(enc, (x,), {}, tol, small_seq_mha, 4)


@pytest.mark.cuda
def test_cuda_bf16_towers_of_the_perceptual_encoders(cuda):
    gen = torch.Generator().manual_seed(3)
    images = torch.randn(8, 224, 224, 3, generator=gen).to(cuda, torch.bfloat16)
    tokens = _build(encoders_misc.CLIPVisionTokens(layers=2), cuda).to(torch.bfloat16)
    _compare(tokens, (images,), {}, 6e-2, fused_qkv_attention, 2)
    vmap = _build(encoders_misc.VoltronMAPEncoder(vit_kwargs={"depth": 2}), cuda)
    vmap.vcond.to(torch.bfloat16)
    _compare(vmap, (images,), {}, 6e-2, fused_qkv_attention, 2)
