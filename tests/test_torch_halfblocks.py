"""Kernels B4 and B5 of the PyTorch port (`ops/attention_halfblock.py`,
`ops/mlp_halfblock.py`) against the JAX package's Pallas half-block kernels,
which run here in interpret mode, and against their XLA `_reference`s; and
the towers' half-block route against their B1 + B3 route and the JAX towers.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels themselves are checked on the card (the `cuda` tests at the end,
and `chip_smoke.py`). The JAX package is imported inside the CPU tests, so
that on a GPU machine without JAX the `cuda` tests of this file run alone:

    python -m pytest tests/test_torch_halfblocks.py -m cuda --noconftest

The weights go to the JAX functions in their layout, (in, out), and to the
port as torch Linear weights, (out, in).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import TOWER_BLOCKS  # {tower: (norm, eps, LayerScale, causal, act)}
from mdt_policy_tpu_torch.ops import attention_halfblock as ahb
from mdt_policy_tpu_torch.ops import halfblock_gemm as hbg
from mdt_policy_tpu_torch.ops import mlp_halfblock as mhb
from mdt_policy_tpu_torch.ops._plain_backward import PlainBackward, launch_with_plain_backward
from mdt_policy_tpu_torch.ops.attention_halfblock import (
    attention_halfblock, attention_halfblock_reference)
from mdt_policy_tpu_torch.ops.fused_qkv_attention import fused_qkv_attention_reference
from mdt_policy_tpu_torch.ops.halfblock_gemm import (
    halfblock_gemm, halfblock_gemm_reference, halfblock_norm, halfblock_norm_reference)
from mdt_policy_tpu_torch.ops.mlp_halfblock import mlp_halfblock, mlp_halfblock_reference

# f32: both sides accumulate in f32 and differ in summation order
F32_TOL = dict(rtol=1e-4, atol=5e-5)
# bf16: every step rounds to 8 significant bits (3.9e-3 relative), the
# Pallas kernel keeps the scores in f32 where the XLA reference rounds them,
# and XLA may skip intermediate roundings; values are O(1)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

B, C, N_HEADS, HIDDEN = 3, 32, 4, 64


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _attention_arrays(tower, T, seed=0):
    """numpy inputs of B4, the weights in the JAX layout (in, out)."""
    norm, eps, has_gamma, causal, _ = TOWER_BLOCKS[tower]
    rng = np.random.default_rng(seed)
    return dict(
        x=_normal(rng, (B, T, C)), g=1 + _normal(rng, (C,), 0.1),
        b=_normal(rng, (C,), 0.1) if norm == "ln" else None,
        w_qkv=_normal(rng, (C, 3 * C), C ** -0.5), b_qkv=_normal(rng, (3 * C,), 0.05),
        w_proj=_normal(rng, (C, C), C ** -0.5), b_proj=_normal(rng, (C,), 0.05),
        gamma=_normal(rng, (C,), 0.5) if has_gamma else None)


def _mlp_arrays(tower, T, seed=1):
    norm, eps, has_gamma, _, act = TOWER_BLOCKS[tower]
    rng = np.random.default_rng(seed)
    n1 = 2 * HIDDEN if act == "swishglu" else HIDDEN
    return dict(
        x=_normal(rng, (B, T, C)), g=1 + _normal(rng, (C,), 0.1),
        b=_normal(rng, (C,), 0.1) if norm == "ln" else None,
        w1=_normal(rng, (C, n1), C ** -0.5), b1=_normal(rng, (n1,), 0.05),
        w2=_normal(rng, (HIDDEN, C), HIDDEN ** -0.5), b2=_normal(rng, (C,), 0.05),
        gamma=_normal(rng, (C,), 0.5) if has_gamma else None)


def _port(arrays, dtype):
    """The port's tensors: weight matrices transposed to (out, in)."""
    out = {}
    for k, a in arrays.items():
        if a is not None and k.startswith("w"):
            a = np.ascontiguousarray(a.T)
        out[k] = None if a is None else torch.from_numpy(a).to(dtype)
    return out


def _jax(arrays, dtype):
    import jax.numpy as jnp
    return {k: None if a is None else jnp.asarray(a).astype(dtype)
            for k, a in arrays.items()}


def _attention_args(t, tower):
    norm, eps, _, causal, _ = TOWER_BLOCKS[tower]
    return (t["x"], t["g"], t["b"], t["w_qkv"], t["b_qkv"], t["w_proj"], t["b_proj"],
            t["gamma"], N_HEADS, norm, eps, causal)


def _mlp_args(t, tower):
    norm, eps, _, _, act = TOWER_BLOCKS[tower]
    return (t["x"], t["g"], t["b"], t["w1"], t["b1"], t["w2"], t["b2"], t["gamma"],
            act, norm, eps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [13, 29])
@pytest.mark.parametrize("tower", list(TOWER_BLOCKS))
def test_attention_halfblock_plain_matches_pallas_and_reference(tower, T, dtype):
    import jax.numpy as jnp
    from mdt_policy_tpu.ops.attention_halfblock import _reference, attention_halfblock as jax_hb
    arrays = _attention_arrays(tower, T)
    j = _attention_args(_jax(arrays, getattr(jnp, dtype)), tower)
    kernel = np.asarray(jax_hb(*j, 2, True), np.float32)  # interpret mode
    ref = np.asarray(_reference(*j), np.float32)
    out = attention_halfblock(*_attention_args(_port(arrays, getattr(torch, dtype)), tower))
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, T, C)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(), kernel, **tol)
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [13, 29])
@pytest.mark.parametrize("tower", list(TOWER_BLOCKS))
def test_mlp_halfblock_plain_matches_pallas_and_reference(tower, T, dtype):
    import jax.numpy as jnp
    from mdt_policy_tpu.ops.mlp_halfblock import _reference, mlp_halfblock as jax_hb
    arrays = _mlp_arrays(tower, T)
    j = _mlp_args(_jax(arrays, getattr(jnp, dtype)), tower)
    kernel = np.asarray(jax_hb(*j, 32, 2, True), np.float32)  # hidden tile 32, interpret
    ref = np.asarray(_reference(*j), np.float32)
    out = mlp_halfblock(*_mlp_args(_port(arrays, getattr(torch, dtype)), tower))
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, T, C)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(), kernel, **tol)
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)


def _grads_match_jax(arrays, tower, port_fn, jax_ref, args_of):
    """Autograd through the port's plain version against jax.grad of the
    JAX reference, for every input, from sum(out * up): rtol 1e-4 on O(1)
    gradients, atol 1e-5 for those that vanish in exact arithmetic (the key
    bias: softmax does not see a shift of all scores) and are rounding."""
    import jax
    import jax.numpy as jnp
    names = [k for k, a in arrays.items() if a is not None]
    up = _normal(np.random.default_rng(9), arrays["x"].shape)

    def jloss(*leaves):
        t = {**{k: None for k in arrays}, **dict(zip(names, leaves))}
        return jnp.sum(jax_ref(*args_of(t, tower)) * up)

    jgrads = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(arrays[k]) for k in names))
    t = _port(arrays, torch.float32)
    for k in names:
        t[k].requires_grad_()
    (port_fn(*args_of(t, tower)) * torch.from_numpy(up)).sum().backward()
    for k, jg in zip(names, jgrads):
        jg = np.asarray(jg)
        if k.startswith("w"):
            jg = jg.T
        np.testing.assert_allclose(t[k].grad.numpy(), jg, rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("tower", list(TOWER_BLOCKS))
def test_attention_halfblock_gradients_match_jax(tower):
    from mdt_policy_tpu.ops.attention_halfblock import _reference
    _grads_match_jax(_attention_arrays(tower, 13), tower, attention_halfblock,
                     _reference, _attention_args)


@pytest.mark.parametrize("tower", list(TOWER_BLOCKS))
def test_mlp_halfblock_gradients_match_jax(tower):
    from mdt_policy_tpu.ops.mlp_halfblock import _reference
    _grads_match_jax(_mlp_arrays(tower, 13), tower, mlp_halfblock, _reference, _mlp_args)


@pytest.mark.parametrize("tower", ["voltron", "clip_vision"])
def test_kernel_function_backward_is_plain_backward(tower):
    """The kernels' autograd Function (its forward stood in for by the plain
    version, as the kernels have no CPU mode) gives the gradients of autograd
    through the plain version, with a frozen (no-grad) gain among them."""
    for arrays, ref, args_of in ((_attention_arrays(tower, 13), attention_halfblock_reference,
                                  _attention_args),
                                 (_mlp_arrays(tower, 13), mlp_halfblock_reference, _mlp_args)):
        leaves, refs = _port(arrays, torch.float32), _port(arrays, torch.float32)
        for t in (leaves, refs):
            for k, v in t.items():
                if v is not None:
                    v.requires_grad_(k != "g")
        args = args_of(leaves, tower)
        names = ("n_heads", "norm", "eps", "causal") if ref is attention_halfblock_reference \
            else ("act", "norm", "eps")
        out = PlainBackward.apply(ref, ref, dict(zip(names, args[8:])), *args[:8])
        up = torch.from_numpy(_normal(np.random.default_rng(3), tuple(out.shape)))
        (out * up).sum().backward()
        (ref(*args_of(refs, tower)) * up).sum().backward()
        for k, v in leaves.items():
            if v is not None:
                assert (v.grad is None) == (refs[k].grad is None), k
                if v.grad is not None:
                    torch.testing.assert_close(v.grad, refs[k].grad, rtol=1e-5, atol=1e-7)


def test_build_digest_covers_the_shared_headers(tmp_path):
    """A kernel's library is keyed by its source and every shared header: an
    edited header (which the source may include) rebuilds it; an edited
    source rebuilds only its own library."""
    import shutil
    from mdt_policy_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    names = [p.stem for p in csrc.glob("*.cu")]
    assert {"attention_halfblock", "halfblock_gemm", "fused_qkv_attention"} <= set(names)
    before = {n: _build.digest(n, csrc) for n in names}
    assert before == {n: _build.digest(n) for n in names}
    for header in ("sm90.cuh", "attention_sm90.cuh"):  # the Hopper helpers; B1's and B4's body
        path = csrc / header
        path.write_text(path.read_text() + "\n// edited\n")
        after = {n: _build.digest(n, csrc) for n in names}
        assert all(after[n] != before[n] for n in names), header
        before = after
    (csrc / "halfblock_gemm.cu").write_text((csrc / "halfblock_gemm.cu").read_text() + "\n")
    assert _build.digest("halfblock_gemm", csrc) != after["halfblock_gemm"]
    assert _build.digest("attention_halfblock", csrc) == after["attention_halfblock"]


def test_wrappers_count_no_launch_on_cpu():
    wrappers = (attention_halfblock, mlp_halfblock, halfblock_norm, halfblock_gemm)
    before = [fn.launches for fn in wrappers]
    attention_halfblock(*_attention_args(_port(_attention_arrays("voltron", 5),
                                               torch.float32), "voltron"))
    t = _port(_mlp_arrays("clip_text", 5), torch.float32)
    mlp_halfblock(*_mlp_args(t, "clip_text"))
    xn = halfblock_norm(t["x"], t["g"], t["b"], "ln", 1e-5)
    torch.testing.assert_close(xn, halfblock_norm_reference(t["x"], t["g"], t["b"], "ln", 1e-5),
                               rtol=0, atol=0)
    h = halfblock_gemm(xn, t["w1"], t["b1"], "quickgelu")
    torch.testing.assert_close(h, halfblock_gemm_reference(xn, t["w1"], t["b1"], "quickgelu"),
                               rtol=0, atol=0)
    assert [fn.launches for fn in wrappers] == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tower", list(TOWER_BLOCKS))
@pytest.mark.parametrize("kernel", ["b4", "b5"])
def test_split_path_composes_to_the_references(kernel, tower, dtype):
    """The norm pass and the GEMMs' plain versions, chained as the CUDA
    wrappers chain the kernels (norm once, then each GEMM with its
    epilogue), give B4's and B5's plain versions bit for bit: the rounding
    contract that the kernels' epilogues follow."""
    norm, eps, _, causal, act = TOWER_BLOCKS[tower]
    dt = getattr(torch, dtype)
    if kernel == "b4":
        t = _port(_attention_arrays(tower, 13), dt)
        xn = halfblock_norm_reference(t["x"], t["g"], t["b"], norm, eps)
        qkv = halfblock_gemm_reference(xn, t["w_qkv"], t["b_qkv"], "bias")
        att = fused_qkv_attention_reference(qkv, N_HEADS, causal)
        split = halfblock_gemm_reference(att, t["w_proj"], t["b_proj"], "residual", t["x"],
                                         t["gamma"])
        whole = attention_halfblock_reference(*_attention_args(t, tower))
    else:
        t = _port(_mlp_arrays(tower, 13), dt)
        xn = halfblock_norm_reference(t["x"], t["g"], t["b"], norm, eps)
        h = halfblock_gemm_reference(xn, t["w1"], t["b1"], act)
        split = halfblock_gemm_reference(h, t["w2"], t["b2"], "residual", t["x"], t["gamma"])
        whole = mlp_halfblock_reference(*_mlp_args(t, tower))
    assert split.dtype == dt and torch.equal(split, whole)


@pytest.mark.parametrize("kernel", ["b4", "b5"])
@pytest.mark.parametrize("mode", ["no_grad", "frozen_inputs", "grad"])
def test_dispatch_enters_autograd_function_only_for_gradients(kernel, mode):
    """The CUDA branch's dispatch, its launch stood in for by the plain
    version (the kernels have no CPU mode): under no_grad, or on inputs
    that need no gradient (the frozen towers), the launch runs directly,
    with no autograd Function and no graph; where autograd wants a gradient
    (here the input's) it runs through PlainBackward, whose gradient is the
    plain version's."""
    module, ref, arrays, args_of = (
        (ahb, attention_halfblock_reference, _attention_arrays("clip_text", 9),
         _attention_args) if kernel == "b4"
        else (mhb, mlp_halfblock_reference, _mlp_arrays("voltron", 9), _mlp_args))
    t = _port(arrays, torch.float32)
    t["x"].requires_grad_(mode != "frozen_inputs")
    args = args_of(t, "clip_text" if kernel == "b4" else "voltron")
    names = ("n_heads", "norm", "eps", "causal") if kernel == "b4" else ("act", "norm", "eps")
    kwargs = dict(zip(names, args[8:]))
    launched = []

    def launch(*tensors, **kw):
        launched.append(kw)
        return ref(*tensors, **kw)
    with mock.patch.object(module, "_launch", launch), \
            mock.patch.object(PlainBackward, "apply", wraps=PlainBackward.apply) as applied, \
            torch.set_grad_enabled(mode != "no_grad"):
        out = launch_with_plain_backward(module._launch, ref, kwargs, *args[:8])
    assert launched == [kwargs]
    assert applied.call_count == (mode == "grad")
    assert (out.grad_fn is not None) == (mode == "grad")
    if mode == "grad":
        up = torch.from_numpy(_normal(np.random.default_rng(4), tuple(out.shape)))
        (grad,) = torch.autograd.grad((out * up).sum(), t["x"])
        ref_x = t["x"].detach().clone().requires_grad_()
        (want,) = torch.autograd.grad((ref(ref_x, *args[1:8], **kwargs) * up).sum(), ref_x)
        torch.testing.assert_close(grad, want, rtol=0, atol=0)


def _cpu_tensor(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("case", ["b4_width", "b4_norm_width", "b5_hidden_quickgelu",
                                  "b5_hidden_swishglu", "gemm_depth", "gemm_rows",
                                  "misaligned"])
def test_cuda_launch_rejects_shapes_the_tile_does_not_take(case):
    """The CUDA branch checks, before it builds or launches anything, the
    shapes the tile takes: output widths a multiple of 128 rows of W (64
    proj and 64 gate rows for SwishGLU), depths of 64, a normalized width of
    at most 1024, and 16-byte aligned tensors; every tower width passes."""
    if case.startswith("b4"):
        C = 96 if case == "b4_width" else 1152
        x, v = _cpu_tensor((2, 5, C)), _cpu_tensor((C,))
        call = lambda: ahb._launch(x, v, None, _cpu_tensor((3 * C, C)), _cpu_tensor((3 * C,)),  # noqa: E731
                                   _cpu_tensor((C, C)), v, None, n_heads=C // 32,
                                   norm="rms", eps=1e-8, causal=False)
    elif case.startswith("b5"):
        C, H = 128, 96 if case == "b5_hidden_quickgelu" else 32
        act = case.split("_")[-1]
        n1 = 2 * H if act == "swishglu" else H
        x, v = _cpu_tensor((2, 5, C)), _cpu_tensor((C,))
        call = lambda: mhb._launch(x, v, v, _cpu_tensor((n1, C)), _cpu_tensor((n1,)),  # noqa: E731
                                   _cpu_tensor((C, H)), v, None, act=act, norm="ln", eps=1e-5)
    else:
        K, n_w = {"gemm_depth": (96, 128), "gemm_rows": (128, 192)}.get(case, (128, 128))
        a = _cpu_tensor((4, K)) if case != "misaligned" \
            else _cpu_tensor((4 * K + 1,))[1:].view(4, K)  # 2 bytes off 16
        call = lambda: hbg._gemm_launch(a, _cpu_tensor((n_w, K)), _cpu_tensor((n_w,)),  # noqa: E731
                                        None, None, epilogue="swishglu")
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("change,error", [
    (dict(x=torch.zeros(2, 8)), ValueError),                          # not (B, T, C)
    (dict(g=torch.ones(C + 8)), ValueError),                          # shape
    (dict(w_qkv=torch.zeros(3 * C, C).bfloat16()), TypeError),        # mixed dtype
    (dict(x=torch.zeros(B, 5, C, dtype=torch.float16)), TypeError),   # dtype
    (dict(w_proj=torch.zeros(C, C).T), ValueError),                   # strides
    (dict(b=torch.zeros(C)), ValueError),                             # RMS with a bias
    (dict(n_heads=5), ValueError),                                    # C % heads
    (dict(norm="batch"), ValueError),
])
def test_attention_halfblock_rejects_bad_input(change, error):
    t = _port(_attention_arrays("voltron", 5), torch.float32)
    kw = dict(n_heads=N_HEADS, norm="rms", eps=1e-8)
    for k in ("n_heads", "norm"):
        if k in change:
            kw[k] = change.pop(k)
    t.update(change)
    with pytest.raises(error):
        attention_halfblock(t["x"], t["g"], t["b"], t["w_qkv"], t["b_qkv"], t["w_proj"],
                            t["b_proj"], t["gamma"], **kw)


@pytest.mark.parametrize("change,error", [
    (dict(w1=torch.zeros(HIDDEN, C)), ValueError),   # swishglu wants 2H rows
    (dict(act="gelu"), ValueError),
    (dict(b2=torch.zeros(C, dtype=torch.float64)), TypeError),
])
def test_mlp_halfblock_rejects_bad_input(change, error):
    t = _port(_mlp_arrays("voltron", 5), torch.float32)
    act = change.pop("act", "swishglu")
    t.update(change)
    with pytest.raises(error):
        mlp_halfblock(t["x"], t["g"], t["b"], t["w1"], t["b1"], t["w2"], t["b2"],
                      t["gamma"], act, "rms", 1e-8)


# ---------------------------------------------------------------------------
# the towers through the half-block route
# ---------------------------------------------------------------------------

def _jinit(module, *args):
    """flax init, then every parameter perturbed by N(0, 0.1)."""
    import jax
    params = jax.device_get(jax.jit(module.init)(jax.random.PRNGKey(0), *args)["params"])
    rng = np.random.default_rng(100)
    return jax.tree.map(
        lambda p: (np.asarray(p) + rng.normal(size=np.shape(p)) * 0.1).astype(np.float32),
        params)


def _tower(name):
    """(JAX tower, its params, port tower with the same weights, input)."""
    from mdt_policy_tpu.models.clip import CLIPTextTower as JText
    from mdt_policy_tpu.models.clip import CLIPVisionTower as JVision
    from mdt_policy_tpu.models.voltron_vit import VoltronViT as JVoltron
    from mdt_policy_tpu_torch.models import CLIPTextTower, CLIPVisionTower, VoltronViT
    from mdt_policy_tpu_torch.utils import from_jax
    rng = np.random.default_rng(5)
    if name == "voltron":
        jm, pm = JVoltron(patch_size=16, embed_dim=32, depth=1, n_heads=2, img_size=32), \
            VoltronViT(16, 32, 1, 2, img_size=32)
        x, convert = _normal(rng, (3, 32, 32, 3)), from_jax.voltron_vit_from_jax
    elif name == "clip_vision":
        jm, pm = JVision(embed_dim=16, image_resolution=32, layers=1, width=128,
                         patch_size=16), CLIPVisionTower(16, 32, 1, 128, 16)
        x, convert = _normal(rng, (3, 32, 32, 3)), from_jax.clip_vision_from_jax
    else:
        jm, pm = JText(embed_dim=16, context_length=8, vocab_size=50, width=16, heads=2,
                       layers=1), CLIPTextTower(16, 8, 50, 16, 2, 1)
        x = rng.integers(1, 49, size=(3, 8)).astype(np.int32)
        x[:, 5], x[:, 6:] = 49, 0  # EOT: the largest id
        convert = from_jax.clip_text_from_jax
    params = _jinit(jm, x)
    pm.load_state_dict(convert(params), strict=True)
    return jm, params, pm.eval(), x


@pytest.mark.parametrize("name", ["voltron", "clip_vision", "clip_text"])
def test_tower_block_halfblock_route_matches_b1_b3_route_and_jax(name):
    """One block of each tower through B4 + B5 against the same block
    through B1 + B3 and against the JAX tower (f32: the routes differ only
    in summation order); the route really goes through the half-blocks."""
    jm, params, pm, x = _tower(name)
    ref = np.asarray(jm.apply({"params": params}, x))
    xt = torch.from_numpy(x).long() if x.dtype == np.int32 else torch.from_numpy(x)
    with torch.no_grad(), \
            mock.patch.object(ahb, "attention_halfblock_reference",
                              wraps=attention_halfblock_reference) as a_calls, \
            mock.patch.object(mhb, "mlp_halfblock_reference",
                              wraps=mlp_halfblock_reference) as m_calls:
        routed = pm(xt, halfblocks=True).numpy()
        assert a_calls.call_count == 1 and m_calls.call_count == 1
        plain = pm(xt).numpy()
        assert a_calls.call_count == 1 and m_calls.call_count == 1
    np.testing.assert_allclose(routed, plain, **F32_TOL)
    np.testing.assert_allclose(routed, ref, **F32_TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# (kernel, tower, B, T, C, heads or hidden): the extraction path's shapes at a
# batch of 4 images or sentences (the ragged row tails of T = 196, 197, 77),
# and B4 at extraction's batches;
# inputs and bounds are chip_smoke.py's (`halfblock_inputs`, `HALFBLOCK_TOL`)
CUDA_SHAPES = [("b4", "voltron", 4, 196, 384, 6), ("b5", "voltron", 4, 196, 384, 1536),
               ("b4", "clip_vision", 4, 197, 768, 12),
               ("b5", "clip_vision", 4, 197, 768, 3072),
               ("b4", "clip_text", 4, 77, 512, 8), ("b5", "clip_text", 4, 77, 512, 2048),
               # B4 at extraction's shapes (chip_smoke.py's HALFBLOCK_SHAPES), where
               # its attention core runs B1's tensor-core body on full waves
               ("b4", "voltron", 128, 196, 384, 6), ("b4", "clip_vision", 64, 197, 768, 12),
               ("b4", "clip_text", 512, 77, 512, 8)]


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,tower,Bn,T,Cn,n", CUDA_SHAPES)
def test_cuda_kernel_matches_plain_and_float64(kernel, tower, Bn, T, Cn, n):
    _needs_cuda()
    from chip_smoke import HALFBLOCK_TOL, halfblock_inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    tensors, kw = halfblock_inputs(torch, kernel, tower, Bn, T, Cn, n, "cuda")
    fn, ref = (attention_halfblock, attention_halfblock_reference) if kernel == "b4" \
        else (mlp_halfblock, mlp_halfblock_reference)
    before = fn.launches
    out = fn(*tensors, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and out.dtype == torch.bfloat16
    plain = ref(*tensors, **kw).float()
    f64 = ref(*(None if t is None else t.double() for t in tensors), **kw)
    for label, r in (("plain", plain), ("float64", f64)):
        err = (out.double() - r.double()).abs().max().item()
        assert err <= HALFBLOCK_TOL[label] * max(1.0, r.abs().max().item()), (label, err)
    again = fn(*tensors, **kw)
    assert torch.equal(out, again)  # no run-to-run variation


@pytest.mark.cuda
def test_cuda_kernels_refuse_float32():
    _needs_cuda()
    from chip_smoke import halfblock_inputs
    tensors, kw = halfblock_inputs(torch, "b4", "voltron", 1, 196, 384, 6, "cuda")
    with pytest.raises(TypeError):
        attention_halfblock(*(None if t is None else t.float() for t in tensors), **kw)


# the GEMM alone at ragged M (a tile's edge) and the extraction's M (B * T of
# chip_smoke.py's HALFBLOCK_SHAPES: 25,088, 12,608, 39,424): (epilogue, K,
# rows of W, LayerScale): Voltron's qkv and SwishGLU W1, CLIP vision's
# QuickGELU W1, Voltron's W2 with gamma, CLIP text's projection without
GEMM_MS = [1, 127, 129, 12608, 25088, 39424]
GEMM_CASES = [("bias", 384, 1152, False), ("swishglu", 384, 3072, False),
              ("quickgelu", 768, 3072, False), ("residual", 1536, 384, True),
              ("residual", 512, 512, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", GEMM_MS)
@pytest.mark.parametrize("epilogue,K,n_w,has_gamma", GEMM_CASES)
def test_cuda_gemm_matches_plain(epilogue, K, n_w, has_gamma, M):
    """The GEMM against its plain version on the same bf16 inputs (bound:
    chip_smoke.py's HALFBLOCK_TOL["plain"], two bf16 ulps of the output),
    one launch counted, and a rerun bit-identical (no split K, no atomics)."""
    _needs_cuda()
    from chip_smoke import HALFBLOCK_TOL
    gen = torch.Generator("cuda").manual_seed(M + K)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).bfloat16()
    n_out = n_w // 2 if epilogue == "swishglu" else n_w
    a, w, bias = r(M, K), r(n_w, K, scale=K ** -0.5), r(n_w, scale=0.02)
    res = r(M, n_out) if epilogue == "residual" else None
    gamma = r(n_out, scale=0.5) if has_gamma else None
    before = halfblock_gemm.launches
    out = halfblock_gemm(a, w, bias, epilogue, res, gamma)
    plain = halfblock_gemm_reference(a, w, bias, epilogue, res, gamma)
    torch.cuda.synchronize()
    assert halfblock_gemm.launches == before + 1 and out.shape == (M, n_out)
    err = (out.float() - plain.float()).abs().max().item()
    assert err <= HALFBLOCK_TOL["plain"] * max(1.0, plain.float().abs().max().item()), err
    assert torch.equal(out, halfblock_gemm(a, w, bias, epilogue, res, gamma))


@pytest.mark.cuda
@pytest.mark.parametrize("M", GEMM_MS)
@pytest.mark.parametrize("norm,C", [("rms", 384), ("ln", 768), ("ln", 512)])
def test_cuda_norm_matches_plain(norm, C, M):
    """The norm pass against its plain version: the same rounding points,
    f32 statistics summed in another order and rsqrtf, so a rounding may
    flip (bound: HALFBLOCK_TOL["plain"], two bf16 ulps of the output)."""
    _needs_cuda()
    from chip_smoke import HALFBLOCK_TOL
    gen = torch.Generator("cuda").manual_seed(M + C)
    x = torch.randn((M, C), generator=gen, device="cuda").bfloat16()
    g = (1 + 0.1 * torch.randn((C,), generator=gen, device="cuda")).bfloat16()
    b = (0.1 * torch.randn((C,), generator=gen, device="cuda")).bfloat16() \
        if norm == "ln" else None
    eps = 1e-5 if norm == "ln" else 1e-8
    before = halfblock_norm.launches
    out = halfblock_norm(x, g, b, norm, eps)
    plain = halfblock_norm_reference(x, g, b, norm, eps)
    torch.cuda.synchronize()
    assert halfblock_norm.launches == before + 1
    err = (out.float() - plain.float()).abs().max().item()
    assert err <= HALFBLOCK_TOL["plain"] * max(1.0, plain.float().abs().max().item()), err
    assert torch.equal(out, halfblock_norm(x, g, b, norm, eps))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["b4", "b5"])
def test_cuda_light_launch_records_no_autograd_graph(kernel):
    """Under no_grad, and on inputs that need no gradient (the frozen
    towers), the half-block's output carries no grad_fn; with an input that
    needs one, PlainBackward's."""
    _needs_cuda()
    from chip_smoke import halfblock_inputs
    tensors, kw = halfblock_inputs(torch, kernel, "voltron", 2, 196, 384,
                                   6 if kernel == "b4" else 1536, "cuda")
    fn = attention_halfblock if kernel == "b4" else mlp_halfblock
    assert fn(*tensors, **kw).grad_fn is None
    x = tensors[0].requires_grad_()
    with torch.no_grad():
        assert fn(*tensors, **kw).grad_fn is None
    assert fn(*tensors, **kw).grad_fn is not None and x.requires_grad
