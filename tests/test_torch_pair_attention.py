"""Kernels V1 and V3 of the PyTorch port (`mdt_policy_tpu_torch/ops/pair_attention.py`)
and the attention-variant microbench (`mdt_policy_tpu_torch/tools/`) against
the JAX repository's Pallas kernels in `tools/attn_kernel_experiment.py` and
`tools/attn_kernel_round3.py`, which run here in interpret mode.

On the CPU the port's wrappers run their plain PyTorch version; the CUDA
kernels themselves are checked on the card (the `cuda` tests below, and
`chip_smoke.py`). The JAX tools are imported inside the parity tests, so
that on a GPU machine without JAX the `cuda` tests of this file run alone:

    python -m pytest tests/test_torch_pair_attention.py -m cuda --noconftest
"""

import importlib
import itertools
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mdt_policy_tpu_torch.ops.fused_qkv_attention import fused_qkv_attention
from mdt_policy_tpu_torch.ops.pair_attention import (_check_smem, _flags, pair_attention,
                                                     pair_attention_reference,
                                                     pair_grid_attention)
from mdt_policy_tpu_torch.tools import attn_kernel_experiment, attn_kernel_round3

REPO = Path(__file__).resolve().parent.parent
# Both sides round the probabilities (or e) and the output to bf16 (8
# significant bits, 3.9e-3 relative) at the same points; a rounding can land
# on the neighbouring value when the f32 results differ in the last bit:
# one bf16 ulp of an O(1) output plus one flipped probability.
TOL = 2e-2
# (B, T, 3C, heads): Voltron's width at B=3 (ragged in blocks of 2 and
# padded in blocks of 16 or more), and CLIP vision's 12 heads at an odd T
SHAPES = [(3, 20, 1152, 6), (2, 17, 2304, 12)]
# the option sets of the JAX attn_kernel_round3.main(), bB and vmem_mb in
# the tool's order
V3_OPTIONS = [
    dict(block_b=16),
    dict(block_b=16, bf16_softmax=True),
    dict(block_b=32, vmem_mb=64),
    dict(block_b=64, vmem_mb=110),
    dict(block_b=16, vmem_mb=None, mxu_sum=True, exp2=True),
    dict(block_b=32, vmem_mb=64, mxu_sum=True, exp2=True),
    dict(block_b=64, vmem_mb=110, mxu_sum=True, exp2=True),
    dict(block_b=32, vmem_mb=64, mxu_sum=True, exp2=True, no_max=True),
]


CSRC = REPO / "mdt_policy_tpu_torch" / "csrc"
# The body's shared memory a block (attention_sm90.cuh::smem_bytes): 1024
# bytes of alignment, two stages of K, V (16 NS rows of 128 bytes each) and
# Q (NS = 13: 256 rows), four mbarriers; 74,784 for T <= 80 (NS = 5)
BODY_SMEM = 1024 + 2 * (2 * 13 * 16 * 128 + 256 * 128) + 32


def _jax_tool(name):
    """The JAX repository's tools/<name>.py (it puts the root on sys.path)."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    return importlib.import_module(f"tools.{name}")


def _qkv(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _bound(ref):
    return TOL * max(1.0, float(np.abs(ref).max()))


def _jax_run(fn, x):
    import jax.numpy as jnp
    return np.asarray(fn(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))


@pytest.mark.parametrize("B,T,C3,H", SHAPES)
@pytest.mark.parametrize("bb", [16, 20, 24, 2])
def test_plain_v1_matches_pallas_kernel(B, T, C3, H, bb):
    x = _qkv((B, T, C3))
    ref = _jax_run(_jax_tool("attn_kernel_experiment").make_pair_grid(H, bb, interpret=True), x)
    out = pair_grid_attention(torch.from_numpy(x).to(torch.bfloat16), H, bb)
    assert out.shape == (B, T, C3 // 3) and out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() <= _bound(ref)


@pytest.mark.parametrize("B,T,C3,H", SHAPES)
@pytest.mark.parametrize("options", V3_OPTIONS, ids=lambda o: "-".join(
    f"{k}={v}" for k, v in o.items()))
def test_plain_v3_matches_pallas_kernel(B, T, C3, H, options):
    x = _qkv((B, T, C3), seed=1)
    options = dict(options)
    bb = options.pop("block_b")
    ref = _jax_run(_jax_tool("attn_kernel_round3").make_pair_v3(
        H, bb, interpret=True, **options), x)
    out = pair_attention(torch.from_numpy(x).to(torch.bfloat16), H, bb, **options)
    assert out.shape == (B, T, C3 // 3) and out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() <= _bound(ref)


@pytest.mark.parametrize("options", [
    dict(exp2=True), dict(mxu_sum=True), dict(mxu_sum=True, no_max=True),
    dict(mxu_sum=True, bf16_softmax=True), dict(exp2=True, bf16_softmax=True),
    dict(no_max=True)], ids=lambda o: "-".join(o))
def test_plain_v3_option_combinations_match_pallas_kernel(options):
    """The combinations the tool's main() leaves out, with the TPU kernel's
    precedence (mxu_sum over bf16_softmax, no_max only under mxu_sum), in
    ragged blocks of 2."""
    B, T, C3, H = SHAPES[0]
    bb = 2
    x = _qkv((B, T, C3), seed=2)
    ref = _jax_run(_jax_tool("attn_kernel_round3").make_pair_v3(
        H, bb, interpret=True, **options), x)
    out = pair_attention(torch.from_numpy(x).to(torch.bfloat16), H, bb, **options)
    assert np.abs(out.float().numpy() - ref).max() <= _bound(ref)


def test_plain_v3_rounds_where_the_tpu_kernel_rounds():
    """A rounding point moved changes the plain version's output: the
    options are not all the same function."""
    x = torch.from_numpy(_qkv((2, 17, 2304), seed=3)).to(torch.bfloat16)
    base = pair_attention_reference(x, 12)
    for opts in (dict(exp2=True), dict(mxu_sum=True), dict(bf16_softmax=True)):
        assert not torch.equal(pair_attention_reference(x, 12, **opts), base), opts


@pytest.mark.parametrize("factory,jax_name,args,kwargs", [
    ("make_pair_grid", "attn_kernel_experiment", (6, 2), {}),
    ("make_pair_v3", "attn_kernel_round3", (6, 2), dict(vmem_mb=64, mxu_sum=True, exp2=True)),
    ("make_pair_v3", "attn_kernel_round3", (6, 2), dict(bf16_softmax=True, parallel=False)),
])
def test_two_layer_chain_matches_jax_tools(factory, jax_name, args, kwargs):
    """The whole slice on the CPU: a 2-layer chain of the microbench (output
    spliced back over the q lanes) through the port's factories against the
    same chain through the JAX factories."""
    import jax.numpy as jnp
    x = _qkv((3, 20, 1152), seed=4)
    C = 384
    jax_fn = getattr(_jax_tool(jax_name), factory)(*args, interpret=True, **kwargs)
    y = jnp.asarray(x, jnp.bfloat16)
    for _ in range(2):
        o = jax_fn(y)
        y = y.at[:, :, :C].set(o + 0.1 * y[:, :, :C])
    ref = np.asarray(y.astype(jnp.float32))
    tool = attn_kernel_experiment if jax_name == "attn_kernel_experiment" else attn_kernel_round3
    from mdt_policy_tpu_torch.tools.perf_probe import attention_chain
    chain = attention_chain(getattr(tool, factory)(*args, **kwargs), C, 2)
    out = chain(torch.from_numpy(x).to(torch.bfloat16), torch.zeros(()))
    assert out.shape == x.shape
    assert np.abs(out.float().numpy() - ref).max() <= _bound(ref)


@pytest.mark.parametrize("tool,n_variants", [(attn_kernel_experiment, 4),
                                             (attn_kernel_round3, 9)])
def test_run_on_cpu_returns_every_variant(tool, n_variants, capsys):
    rows = tool.run(2, 1, device="cpu", n_layers=2, n=1, reps=1)
    assert [(r["case"], r["variant"]) for r in rows] == [
        (case, v.name) for case, _, H in (("voltron", 0, 6), ("clip_vision", 0, 12))
        for v in tool.variants(H)]
    assert len(rows) == 2 * n_variants
    for r in rows:
        assert r["ms_per_layer"] is None and r["tflops"] is None  # nothing timed on the CPU
        assert r["launches_per_chain"] == 0  # the plain versions ran
        assert r["err_vs_einsum"] <= 2e-2
    assert "not timed (CPU)" in capsys.readouterr().out


def test_wrappers_count_no_launch_on_cpu():
    x = torch.zeros(1, 4, 384, dtype=torch.bfloat16)
    before = pair_grid_attention.launches, pair_attention.launches
    pair_grid_attention(x, 2)
    pair_attention(x, 2, mxu_sum=True)
    assert (pair_grid_attention.launches, pair_attention.launches) == before


@pytest.mark.parametrize("fn", [pair_grid_attention, pair_attention])
@pytest.mark.parametrize("shape,heads,error", [
    ((2, 5, 3 * 192), 3, ValueError),    # C % 128 != 0 (dh = 64)
    ((2, 5, 3 * 256), 2, ValueError),    # dh = 128
    ((2, 5, 3 * 256), 8, ValueError),    # dh = 32
    ((2, 5, 385), 2, ValueError),        # last dim not 3C
    ((10, 384), 2, ValueError),          # not (B, T, 3C)
])
def test_wrappers_reject_bad_shapes(fn, shape, heads, error):
    with pytest.raises(error):
        fn(torch.zeros(shape, dtype=torch.bfloat16), heads)


@pytest.mark.parametrize("fn", [pair_grid_attention, pair_attention])
def test_wrappers_reject_non_contiguous_and_bad_dtype(fn):
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.zeros(2, 384, 5, dtype=torch.bfloat16).transpose(1, 2), 2)
    with pytest.raises(TypeError):
        fn(torch.zeros(2, 5, 384, dtype=torch.float16), 2)
    with pytest.raises(ValueError, match="block_b"):
        fn(torch.zeros(2, 5, 384, dtype=torch.bfloat16), 2, 0)


def _entry_flags():
    """The option bits `mdt_attn_pair_v3` accepts: the `case` labels of
    `pick` in csrc/attn_pair_v3.cu, over the values of attention_sm90.cuh's
    Flags."""
    names = dict(re.findall(r"(k\w+) = (\d+)", re.search(
        r"enum Flags : int \{([^}]*)\}", (CSRC / "attention_sm90.cuh").read_text()).group(1)))
    labels = re.findall(r"case ([\w |]+):", (CSRC / "attn_pair_v3.cu").read_text())
    return {sum(int(names[n.strip()]) for n in label.split("|")) if label != "0" else 0
            for label in labels}


@pytest.mark.parametrize("exp2,mxu_sum,no_max,bf16_softmax",
                         list(itertools.product((False, True), repeat=4)))
def test_flags_follow_the_tpu_kernels_precedence(exp2, mxu_sum, no_max, bf16_softmax):
    """Each of the 16 option combinations maps onto an instantiation the C
    entry accepts: no_max only under mxu_sum, bf16_softmax only without it,
    exp2 and mxu_sum as given."""
    flags = _flags(exp2, mxu_sum, no_max, bf16_softmax)
    assert flags in _entry_flags()
    assert (bool(flags & 1), bool(flags & 2), bool(flags & 4), bool(flags & 8)) == (
        exp2, mxu_sum, no_max and mxu_sum, bf16_softmax and not mxu_sum)


def test_flags_reach_every_instantiation():
    """The 16 combinations reach all 8 instantiations of the C entry."""
    reached = {_flags(*c) for c in itertools.product((False, True), repeat=4)}
    assert reached == _entry_flags() and len(reached) == 8


@pytest.mark.parametrize("vmem_mb,raises", [(0.1, True), (0.16, True), (0.17, False),
                                            (1, False), (64, False), (None, False)])
def test_vmem_budget_below_the_bodys_need_raises(vmem_mb, raises):
    """The budget check the launch makes with the entry's shared-memory
    size: 173,088 bytes (0.165 MiB) at T > 80."""
    if raises:
        with pytest.raises(ValueError, match="budget"):
            _check_smem("pair_attention", BODY_SMEM, vmem_mb)
    else:
        _check_smem("pair_attention", BODY_SMEM, vmem_mb)
    _check_smem("pair_attention", 74_784, 0.08)  # T <= 80 fits a smaller budget


@pytest.mark.parametrize("vmem_mb", [0, -1])
def test_vmem_budget_must_be_positive(vmem_mb):
    with pytest.raises(ValueError, match="positive"):
        pair_attention(torch.zeros(1, 4, 384, dtype=torch.bfloat16), 2, vmem_mb=vmem_mb)


def test_no_backward():
    x = torch.zeros(1, 4, 384, requires_grad=True)
    with pytest.raises(RuntimeError, match="backward"):
        pair_attention(x, 2)
    with torch.no_grad():
        assert pair_attention(x, 2).shape == (1, 4, 128)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("fn", [pair_grid_attention, pair_attention])
def test_cuda_rejects_float32(fn):
    """An unsupported dtype on the card raises; it never takes the plain path."""
    _cuda()
    before = fn.launches
    with pytest.raises(TypeError, match="bfloat16"):
        fn(torch.zeros(2, 5, 384, device="cuda"), 2)
    assert fn.launches == before


# B = 37 leaves a ragged last block at every block_b the tools use (16, 20,
# 24, 32, 64); T at both key-step counts and their edges (80 | 81)
CUDA_SEQS = [(37, T, *((1152, 6) if i % 2 == 0 else (2304, 12)), None)
             for i, T in enumerate((1, 77, 80, 81, 196, 197, 208))]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C3,H,block_b", [
    (3, 197, 1152, 6, 2), (2, 196, 2304, 12, 16), (5, 17, 1152, 6, 3),
    (1, 208, 1152, 6, 1)] + CUDA_SEQS)
@pytest.mark.parametrize("options", [None] + V3_OPTIONS, ids=lambda o: "v1" if o is None else
                         "-".join(f"{k}={v}" for k, v in o.items()))
def test_cuda_kernel_matches_plain(B, T, C3, H, block_b, options):
    """V1 (options None) and V3 against their plain versions on the card.
    block_b None: V1 at 16, 20 and 24, V3 at its option set's own. Tolerance:
    one bf16 ulp of the output (3.9e-3 relative) plus a flipped probability,
    as TOL."""
    _cuda()
    gen = torch.Generator("cuda").manual_seed(0)
    qkv = torch.randn((B, T, C3), generator=gen, device="cuda").to(torch.bfloat16)
    if options is None:
        fns = [attn_kernel_experiment.make_pair_grid(H, bb)
               for bb in ((block_b,) if block_b else (16, 20, 24))]
    else:
        opts = {k: v for k, v in options.items() if k != "block_b"}
        fns = [attn_kernel_round3.make_pair_v3(H, block_b or options["block_b"], **opts)]
    for fn in fns:
        before = fn.kernel.launches
        out = fn(qkv)
        ref = fn.plain(qkv)
        torch.cuda.synchronize()
        assert fn.kernel.launches == before + 1
        assert out.shape == ref.shape and bool(torch.isfinite(out).all())
        bound = TOL * max(1.0, ref.float().abs().max().item())
        assert (out.float() - ref.float()).abs().max().item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C3,H", [(37, 196, 1152, 6), (37, 197, 2304, 12),
                                      (37, 77, 1152, 6), (5, 1, 2304, 12)])
def test_cuda_v1_is_b1_bit_for_bit(B, T, C3, H):
    """V1 is B1's tensor-core body at FLAGS = 0 in another item order: its
    output equals B1's non-causal output bit for bit at every block_b, and
    V3 without options equals both."""
    _cuda()
    gen = torch.Generator("cuda").manual_seed(B + T)
    qkv = torch.randn((B, T, C3), generator=gen, device="cuda").to(torch.bfloat16)
    b1 = fused_qkv_attention(qkv, H)
    for bb in (1, 16, 20, 24, 64):
        assert torch.equal(pair_grid_attention(qkv, H, bb), b1), bb
    assert torch.equal(pair_attention(qkv, H, 16), b1)


@pytest.mark.cuda
@pytest.mark.parametrize("options", [dict(exp2=True), dict(exp2=True, mxu_sum=True),
                                     dict(exp2=True, bf16_softmax=True),
                                     dict(exp2=True, mxu_sum=True, no_max=True)],
                         ids=lambda o: "-".join(o))
def test_cuda_exp2_scales_q_before_the_product(options):
    """exp2 scales each tile of q in shared memory before its S product; on
    q rows spread over 2^-8 .. 2^2 (scores up to ~30 in log2 units) a tile
    that a wgmma read unscaled (a missing proxy fence or barrier) would give
    scores 5.5x too large. Tolerance TOL, as above."""
    _cuda()
    gen = torch.Generator("cuda").manual_seed(11)
    B, T, C, H = 9, 197, 768, 12
    qkv = torch.randn((B, T, 3 * C), generator=gen, device="cuda")
    qkv[..., :C] *= 2.0 ** torch.randint(-8, 3, (B, T, 1), generator=gen, device="cuda")
    qkv = qkv.to(torch.bfloat16)
    out = pair_attention(qkv, H, 4, **options)
    ref = pair_attention_reference(qkv, H, **options)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    bound = TOL * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= bound


@pytest.mark.cuda
def test_cuda_vmem_budget_below_the_bodys_need_raises():
    """The entry's shared memory against vmem_mb: 173,088 bytes at T > 80,
    74,784 at T <= 80; a budget below it raises before any launch."""
    _cuda()
    qkv = torch.zeros((2, 196, 1152), device="cuda", dtype=torch.bfloat16)
    before = pair_attention.launches
    with pytest.raises(ValueError, match="budget"):
        pair_attention(qkv, 6, vmem_mb=0.16)
    assert pair_attention.launches == before
    pair_attention(qkv, 6, vmem_mb=0.17)
    pair_attention(qkv[:, :80].contiguous(), 6, vmem_mb=0.08)
    assert pair_attention.launches == before + 2


@pytest.mark.cuda
def test_cuda_kernel_is_deterministic_and_ragged_exact():
    """No atomics: the same input gives the same bits; an image's output
    does not depend on the block it shares (block_b 1 vs 3, B = 5)."""
    _cuda()
    qkv = torch.randn((5, 197, 2304), device="cuda").to(torch.bfloat16)
    a = pair_attention(qkv, 12, 3, mxu_sum=True, exp2=True)
    b = pair_attention(qkv, 12, 1, mxu_sum=True, exp2=True)
    assert torch.equal(a, b)
    assert torch.equal(pair_grid_attention(qkv, 12, 3), pair_grid_attention(qkv, 12, 3))


@pytest.mark.cuda
def test_cuda_rejects_long_sequences():
    _cuda()
    with pytest.raises(ValueError, match="keys"):
        pair_grid_attention(torch.zeros(1, 209, 1152, device="cuda",
                                        dtype=torch.bfloat16), 6)
