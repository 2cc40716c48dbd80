"""The few-row route of the denoiser's blocks (`models/blocks.py::_few_rows`),
which sends `Block` and `ConditionedBlock` to kernel B6
(`mdt_policy_tpu_torch/ops/few_row_linear.py`) and B2.

On the CPU the route runs B6's plain version, which computes with the
operators of the blocks' per-op path: the route is held to that path at the
MDT-V width (384, 8 heads) and MDT's (512, 8 heads), at 10 and 4 rows, and
each condition that must keep the per-op path is checked. The kernel itself
is checked in tests/test_torch_few_row_linear.py.
"""

from unittest import mock

import pytest
import torch

from mdt_policy_tpu_torch.models import blocks
from mdt_policy_tpu_torch.ops.few_row_linear import few_row_linear

WIDTHS = [(384, 8), (512, 8)]  # MDT-V's denoiser, MDT's
# B6 launches of one block on the route: its AdaLN modulation, then q/k/v
# (with the context's k/v), the attention projection, the cross q, the
# cross-attention with its projection, the MLP's two layers
LAUNCHES = {"conditioned": 7, "encoder": 4, "decoder": 6}


def _block(kind, C, H, seed=0, **kw):
    torch.manual_seed(seed)
    if kind == "conditioned":
        return blocks.ConditionedBlock(C, H, **kw)
    if kind == "encoder":
        return blocks.Block(C, H, **kw)
    return blocks.Block(C, H, causal=True, use_cross_attention=True, bias=True, **kw)


def _args(kind, B, T, C, seed=1, ctx=4):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, C, generator=g)
    context = torch.randn(B, ctx, C, generator=g)
    if kind == "conditioned":
        return (x, torch.randn(B, 1, C, generator=g), context)
    return (x,) if kind == "encoder" else (x, context)


def _per_op(module, *args, **kwargs):
    with mock.patch.object(blocks, "_few_rows", lambda *a, **k: False):
        return module(*args, **kwargs)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("kind", list(LAUNCHES))
@pytest.mark.parametrize("C,H", WIDTHS)
@pytest.mark.parametrize("B,T", [(1, 10), (1, 4)])
def test_route_matches_per_op_block(kind, C, H, B, T):
    """The route (B6's plain version and B2's) against today's per-op block,
    within 1e-5 relative; B6 called once a launch the card would make."""
    block, args = _block(kind, C, H), _args(kind, B, T, C)
    with torch.no_grad():
        with mock.patch.object(blocks, "few_row_linear", wraps=few_row_linear) as b6:
            out = block(*args)
        ref = _per_op(block, *args)
    assert b6.call_count == LAUNCHES[kind]
    assert out.shape == ref.shape and _rel(out, ref) <= 1e-5


def test_decoder_stack_takes_one_launch_for_its_modulations():
    """`TransformerFiLMDecoder` at B=3 (30 rows): the four blocks' AdaLN
    linears read one sigma token, one launch; then 6 a block."""
    dec = blocks.TransformerFiLMDecoder(384, 8, 4)
    x, c, context = _args("conditioned", 3, 10, 384)
    with torch.no_grad():
        with mock.patch.object(blocks, "few_row_linear", wraps=few_row_linear) as b6:
            out = dec(x, c, context)
        ref = _per_op(dec, x, c, context)
    assert b6.call_count == 1 + 4 * 6
    assert len(b6.call_args_list[0].args) == 4
    assert _rel(out, ref) <= 1e-5


def _keeps_per_op(module, args, kwargs=None, grad=False):
    with torch.set_grad_enabled(grad), \
            mock.patch.object(blocks, "few_row_linear", side_effect=AssertionError):
        out = module(*args, **(kwargs or {}))
    with torch.set_grad_enabled(grad):
        ref = _per_op(module, *args, **(kwargs or {}))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["conditioned", "encoder"])
@pytest.mark.parametrize("case", ["grad", "rows", "bf16", "mask", "dropout"])
def test_route_keeps_per_op_path(kind, case):
    """Grad on, over 32 rows, a bf16 compute dtype, a mask and a dropout
    generator each keep the per-op path."""
    C, H = 64, 4
    block = _block(kind, C, H, dtype=torch.bfloat16 if case == "bf16" else None)
    args = _args(kind, 4 if case == "rows" else 1, 10, C)
    kwargs = {}
    if case == "mask":  # a self-attention mask: no cross-attention beside it
        args, kwargs["custom_attn_mask"] = args[:2], torch.ones(10, 10, dtype=torch.bool).tril()
    if case == "dropout":
        kwargs["generator"] = torch.Generator().manual_seed(0)
    _keeps_per_op(block, args, kwargs, grad=case == "grad")


def test_route_keeps_per_op_path_under_a_forward_mode_transform():
    """`torch.func.jvp` through the block (the samplers' log-likelihood)
    takes the per-op path: its tensors are the transform's wrappers."""
    block = _block("conditioned", 64, 4)
    x, c, context = _args("conditioned", 1, 10, 64)
    with torch.no_grad(), mock.patch.object(blocks, "few_row_linear",
                                            side_effect=AssertionError):
        out, tangent = torch.func.jvp(lambda t: block(t, c, context), (x,), (x,))
    assert torch.isfinite(tangent).all() and out.shape == x.shape


@pytest.mark.parametrize("kind, C, ctx, taken", [
    ("encoder", 512, 4, True), ("encoder", 576, 4, False),
    ("decoder", 512, 16, True), ("decoder", 512, 17, False), ("decoder", 576, 4, False)])
def test_route_stays_within_the_kernel_limits(kind, C, ctx, taken):
    """The route's gate holds rows to B6's static limits: width at most
    MAX_WIDTH, the cross-attention's keys at most MAX_KV_ROWS."""
    block = _block(kind, C, 8)
    x, *rest = _args(kind, 1, 4, C, ctx=ctx)
    with torch.no_grad():
        assert blocks._few_rows(block, x, rest[0] if rest else None, None, None) is taken
