"""Kernel B6 of the PyTorch port (`mdt_policy_tpu_torch/ops/few_row_linear.py`):
the wrapper's limits and packed jobs against the C source, its input checks,
and, on the card, the kernel against its plain version and a graph replan on
the blocks' few-row route against the per-op route. The route on the CPU is
checked in tests/test_torch_few_row_route.py. The `cuda` tests need no JAX:

    python -m pytest tests/test_torch_few_row_linear.py -m cuda --noconftest
"""

import re
from pathlib import Path
from typing import NamedTuple, Optional
from unittest import mock

import pytest
import torch

from mdt_policy_tpu_torch.models import blocks
from mdt_policy_tpu_torch.ops import few_row_linear as frl
from mdt_policy_tpu_torch.ops.few_row_linear import (Attend, Gemm, Norm, few_row_linear,
                                                     few_row_linear_reference)


@pytest.mark.parametrize("python, csrc", [
    ("MAX_ROWS", "kMaxRows"), ("MAX_JOBS", "kMaxJobs"), ("MAX_WIDTH", "kMaxWidth"),
    ("MAX_KV_ROWS", "kMaxKvRows"), ("MAX_HEADS", "kMaxHeads")])
def test_limits_follow_the_kernel_source(python, csrc):
    """The wrapper's limits are the C source's; its static_asserts hold
    every job within them to its shared memory."""
    src = (Path(frl.__file__).parent.parent / "csrc" / "few_row_linear.cu").read_text()
    assert int(re.search(rf"constexpr int {csrc} = (\d+);", src).group(1)) == getattr(frl, python)


def test_job_fields_follow_the_kernel_struct():
    """The wrapper packs `struct Job`'s fields in the C source's order, all
    8 bytes wide, the last two doubles."""
    src = (Path(frl.__file__).parent.parent / "csrc" / "few_row_linear.cu").read_text()
    body = re.search(r"struct Job \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"\*?\s*(\w+)\s*[;,]", re.sub(r"//[^\n]*", "", body))
    assert tuple(names) == frl._FIELDS
    assert frl._JOB.size == 8 * len(frl._FIELDS) and frl._JOB.format.endswith("2d")
    assert "double eps, att_scale;" in body


class Lin(NamedTuple):
    weight: torch.Tensor
    bias: Optional[torch.Tensor] = None


def _lin(N, K, gen, bias=True, device="cpu", dtype=torch.float32):
    w = torch.randn(N, K, generator=gen).mul_(K ** -0.5)
    b = torch.randn(N, generator=gen) if bias else None
    return Lin(w.to(device, dtype), None if b is None else b.to(device, dtype))


@pytest.mark.parametrize("bad, error", [
    ("rows", ValueError), ("k4", ValueError), ("gate", ValueError),
    ("misaligned", ValueError), ("dtype", TypeError), ("attend", ValueError),
    ("wide", ValueError), ("keys", ValueError)])
def test_checks_refuse_what_the_kernel_does_not_take(bad, error):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(10, 64, generator=gen)
    lin = _lin(32, 64, gen)
    g = Gemm(x, (lin,))
    if bad == "rows":
        g = Gemm(torch.randn(33, 64), (lin,))
    if bad == "k4":
        g = Gemm(torch.randn(10, 66), (_lin(32, 66, gen),))
    if bad == "gate":
        g = Gemm(x, (lin,), gate=torch.ones(10, 32))
    if bad == "misaligned":
        g = Gemm(torch.randn(10 * 64 + 1)[1:].view(10, 64), (lin,))
    if bad == "dtype":
        g = Gemm(x.double(), (lin,))
    if bad == "attend":
        g = Gemm(None, (lin,), prologue=Attend(x, torch.randn(40, 128), 4, 3, True))
    if bad == "wide":
        g = Gemm(torch.randn(10, 516), (_lin(32, 516, gen),),
                 Norm(torch.ones(516), None, 1e-5))
    if bad == "keys":
        g = Gemm(None, (lin,), prologue=Attend(x, torch.randn(20, 128), 4, 1, True))
    with pytest.raises(error):
        frl._check(g, torch.device("cpu"))
    assert frl._check(Gemm(x, (lin,)), torch.device("cpu")) == 10


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _replan_gemms(C, B, T, tk, gen, device, dtype=torch.float32):
    """One of each of the denoiser's launches at width C, B x T rows over
    B x tk context rows: the AdaLN modulations of four blocks, q/k/v with the
    context's k/v, the gated projection, the affine-norm cross q, the
    cross-attention with its projection, the MLP's two layers, and the
    encoder's unmodulated q/k/v."""
    rnd = lambda *s: torch.randn(*s, generator=gen).to(device, dtype)
    lin = lambda N, K, bias=True: _lin(N, K, gen, bias, device, dtype)
    M = B * T
    x, c, ctx = rnd(M, C), rnd(B, C), rnd(B * tk, C)
    mod = rnd(B, 6 * C)
    shift, scale, gate = mod[:, :C], mod[:, C:2 * C], mod[:, 2 * C:3 * C]
    ln = Norm(1 + 0.1 * rnd(C), None, 1e-5, shift, scale)
    ln3 = Norm(1 + 0.1 * rnd(C), 0.1 * rnd(C), 1e-6)
    kv = rnd(B * tk, 2 * C)
    return [
        [Gemm(c, (lin(6 * C, C),), "silu") for _ in range(4)],
        [Gemm(x, (lin(C, C), lin(C, C), lin(C, C)), ln, per=T),
         Gemm(ctx, (lin(C, C), lin(C, C)))],
        [Gemm(x, (lin(C, C, False),), residual=rnd(M, C), gate=gate, per=T)],
        [Gemm(x, (lin(C, C),), ln3)],
        [Gemm(None, (lin(C, C, False),), Attend(x, kv, 8, B, True), residual=rnd(M, C))],
        [Gemm(x, (lin(4 * C, C, False),), ln, gelu=True, per=T)],
        [Gemm(rnd(M, 4 * C), (lin(C, 4 * C, False),), residual=rnd(M, C), gate=gate,
              per=T)],
        [Gemm(x[:B * 4], (lin(C, C), lin(C, C), lin(C, C)), Norm(ln.weight, None, 1e-5))],
    ]


def _double(g: Gemm) -> Gemm:
    d = lambda t: None if t is None else t.double()
    pro = g.prologue
    if isinstance(pro, Norm):
        pro = Norm(d(pro.weight), d(pro.bias), pro.eps, d(pro.shift), d(pro.scale))
    elif isinstance(pro, Attend):
        pro = pro._replace(q=d(pro.q), kv=d(pro.kv))
    return g._replace(x=d(g.x), layers=[Lin(d(l.weight), d(l.bias)) for l in g.layers],
                      prologue=pro, residual=d(g.residual), gate=d(g.gate))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [384, 512])
@pytest.mark.parametrize("B", [1, 3])
def test_cuda_kernel_matches_plain(cuda, C, B):
    """Each launch of the denoiser at the replan's shapes (B=1: 10 rows over
    4 context tokens; B=3: 30 rows, MDT's 2,048-wide MLP input then staged in
    tiles) against the plain version in f32 and float64, within 1e-5 of
    max(1, max|ref|): f32 sums of up to 2,048 products in another order.
    One launch a call; a second run gives the same bits."""
    gen = torch.Generator().manual_seed(C + B)
    for gemms in _replan_gemms(C, B, 10, 4, gen, cuda):
        before = few_row_linear.launches
        with torch.no_grad():
            outs = few_row_linear(*gemms)
            again = few_row_linear(*gemms)
            refs = few_row_linear_reference(*gemms)
            f64 = few_row_linear_reference(*map(_double, gemms))
        torch.cuda.synchronize()
        assert few_row_linear.launches == before + 2
        for out, ref, r64 in zip(outs, refs, f64):
            scale = max(1.0, ref.abs().max().item())
            assert (out - ref).abs().max().item() <= 1e-5 * scale
            assert (out.double() - r64).abs().max().item() <= 1e-5 * scale
        assert all(torch.equal(a, b) for a, b in zip(outs, again))


@pytest.mark.cuda
def test_cuda_kernel_refuses_transforms_and_grad(cuda):
    """On the card the wrapper launches or raises: a `torch.func` transform's
    tensor and recording autograd raise rather than run the plain version."""
    gen = torch.Generator().manual_seed(0)
    x, layer = torch.randn(10, 64, generator=gen).to(cuda), torch.nn.Linear(64, 32).to(cuda)
    with torch.no_grad(), pytest.raises(RuntimeError, match="torch.func"):
        torch.func.jvp(lambda t: few_row_linear(Gemm(t, (layer,)))[0], (x,), (x,))
    with pytest.raises(RuntimeError, match="no backward"):
        few_row_linear(Gemm(x, (layer,)))


@pytest.mark.cuda
def test_cuda_graph_replan_matches_per_op_route(cuda):
    """A graph `MDTVPolicy` replan of each family on the route against the
    eager per-op route (B6 off), at B=1 and B=3, within the chunk tolerance
    of tests/test_torch_policy_graph.py; B6 counted at each replay."""
    from test_torch_policy_graph import CHUNK_TOL, _inputs, _obs_goal, _port_net
    from mdt_policy_tpu_torch.agents import MDTVPolicy, init_random_
    for family in ("mdtv", "mdt"):
        net = _port_net(family, cuda)
        init_random_(net, torch.Generator().manual_seed(0))
        for batch in (1, 3):
            obs, goal = _obs_goal(_inputs(batch, 1), "lang")
            graph = MDTVPolicy(net, generator=torch.Generator(cuda).manual_seed(3))
            graph.plan(obs, goal)  # captures
            before = few_row_linear.launches
            chunk = graph.plan(obs, goal)
            torch.cuda.synchronize()
            per_replay = few_row_linear.launches - before
            eager = MDTVPolicy(net, generator=torch.Generator(cuda).manual_seed(3),
                               cuda_graph=False)
            with mock.patch.object(blocks, "_few_rows", lambda *a, **k: False):
                eager.plan(obs, goal)
                ref = eager.plan(obs, goal)
            cfg = net.cfg
            assert per_replay == cfg.n_enc_layers * 4 + 10 * (1 + 6 * cfg.n_dec_layers)
            torch.testing.assert_close(chunk, ref, **CHUNK_TOL)
