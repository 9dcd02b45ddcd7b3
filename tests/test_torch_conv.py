"""PyTorch port, implicit-GEMM convolution: the conv kernels' plain
versions bitwise against the JAX package's conv kernels (interpret
mode), the conv registry's routing against the reference's, the
bit-safety gate, the Hopper shared-memory gate, and the `cim_conv2d`
frontend bitwise against its materialized im2col oracle (mirroring
tests/test_conv.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx_gemm as jag
from repro.core import autotune as jautotune
from repro.core.luts import nibble_sub_luts, signed_product_lut
from repro.core.multipliers import MultiplierSpec as JSpec
from repro.kernels.conv_gemm import conv_log_fused as j_conv_log
from repro.kernels.conv_gemm import conv_lut_fused as j_conv_lut
from repro_torch.core import approx_gemm as ag
from repro_torch.core.approx_gemm import (FAMILIES, ConvParams, GemmParams,
                                          cim_conv2d,
                                          cim_matmul, conv_out_hw,
                                          im2col_nhwc, plan_conv,
                                          plan_misses, select_conv_kernel)
from repro_torch.core.autotune import bucket_conv
from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.kernels import conv_gemm, ops

# (family, n_approx_cols, core): every conv kernel family, both LUT
# layouts through the nibble predicate
HW_CASES = [
    ("exact", None, "nibble"),
    ("appro42", None, "lut"),
    ("appro42", 4, "nibble"),
    ("mitchell", None, "log"),
    ("log_our", None, "log"),
]

# tests/test_conv.py's sweep: ragged B/H/W/C/N, 3x3, 5x5, 1x1 and stride 2
SHAPES = [
    # (b, h, w, c, n, kh, kw, stride)
    (2, 9, 10, 5, 7, 3, 3, 1),
    (1, 7, 7, 3, 4, 5, 5, 1),
    (3, 8, 6, 4, 5, 1, 1, 1),
    (2, 10, 9, 3, 6, 3, 3, 2),
]

# the Table IV CNN's five conv geometries (models/cnn.py, width 16)
CNN_CONVS = [(16, 16, 3, 16), (16, 16, 16, 16), (8, 8, 16, 32),
             (8, 8, 32, 32), (4, 4, 32, 64)]


def _ops(b, h, w, c, n, kh, kw, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wt = rng.standard_normal((kh * kw * c, n)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(wt)


def _oracle(x, wt, gp, cp: ConvParams):
    cols = im2col_nhwc(x, cp)
    out = cim_matmul(cols.reshape(-1, cols.shape[-1]), wt, gp)
    return out.reshape(cols.shape[:3] + (wt.shape[-1],))


def _jspec(family, nac):
    return JSpec(family, 8, True, n_approx_cols=nac)


# ------------------------------------------------------------- routing ----


@pytest.mark.parametrize("family,nac,core", HW_CASES)
@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_conv_routing_per_family(family, nac, core, backend):
    """The reference's conv route for each family, on the device's entry:
    the CUDA kernel for CUDA tensors, its plain version for CPU ones."""
    spec = MultiplierSpec(family, 8, True, n_approx_cols=nac)
    want = jag.select_conv_kernel(family, "hardware", 8, backend="cpu",
                                  spec=_jspec(family, nac)).name
    assert want == f"pallas_conv_{core}"
    pre = "cuda" if backend == "cuda" else "torch"
    got = select_conv_kernel(family, "hardware", 8, backend, spec=spec)
    assert got.name == f"{pre}_conv_{core}"
    assert got.cuda == (backend == "cuda")


def test_conv_routing_other_modes():
    # spec-less routing stays conservative (predicate entries skipped)
    assert select_conv_kernel("exact", "hardware", 8,
                              "cuda").name == "cuda_conv_lut"
    # no implicit kernel covers the surrogates or bit_exact
    assert select_conv_kernel("log_our", "surrogate", 8,
                              "cuda").name == "conv_im2col"
    assert select_conv_kernel("appro42", "bit_exact", 8,
                              "cuda").name == "conv_im2col"
    # exact mode routes to the exact-product kernel (the reference's
    # pallas_conv_mxu), for every family, on either device
    assert jag.select_conv_kernel("exact", "exact", 8,
                                  backend="cpu").name == "pallas_conv_mxu"
    for backend in ("cpu", "cuda"):
        pre = "cuda" if backend == "cuda" else "torch"
        for family in FAMILIES:
            got = select_conv_kernel(family, "exact", 8, backend)
            assert got.name == f"{pre}_conv_mxu"
            assert got.cuda == (backend == "cuda")
        assert plan_conv("exact", "exact", 8, 2, 8, 8, 4, 4, ConvParams(),
                         backend).entry.name == f"{pre}_conv_mxu"


@pytest.mark.parametrize("family,nac,core", HW_CASES)
@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_cnn_geometries_route_to_the_conv_kernels(family, nac, core,
                                                  backend):
    """Every conv of the Table IV CNN, at the evaluation batch, plans the
    family's implicit kernel on its device, never a plain version on a
    CUDA tensor and never the im2col fallback; its fc GEMM plans the
    family's GEMM kernel."""
    spec = MultiplierSpec(family, 8, True, n_approx_cols=nac)
    pre = "cuda" if backend == "cuda" else "torch"
    for h, w, c, n in CNN_CONVS:
        plan = plan_conv(family, "hardware", 8, 256, h, w, c, n,
                         ConvParams(), backend, spec=spec)
        assert plan.entry.name == f"{pre}_conv_{core}"
        assert plan.conv == ConvParams() and plan.backend == backend
    fc = ag.plan_gemm(family, "hardware", 8, 256, 64, 10, backend,
                      spec=spec).entry
    gemm = {"nibble": "lut_nibble", "lut": "lut_gather", "log": "log"}[core]
    assert fc.name == f"{pre}_{gemm}" and fc.cuda == (backend == "cuda")


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_conv_plan_enforces_bit_bound_stride_limit(backend):
    """Geometries where some input pixel reaches no patch (stride >
    min(kh, kw), or a sampling residue beyond the padding) can make
    quant_scale(x) differ from the oracle's quant_scale(im2col(x)):
    routing materializes there, as the reference's."""
    spec = MultiplierSpec("exact", 8, True)
    pre = "cuda" if backend == "cuda" else "torch"
    for h, s, want in ((13, 3, f"{pre}_conv_nibble"), (13, 4, "conv_im2col"),
                       (12, 3, "conv_im2col")):
        cp = ConvParams(3, 3, s)
        assert plan_conv("exact", "hardware", 8, 2, h, h, 4, 4, cp, backend,
                         spec=spec).entry.name == want
        ref = jag.plan_conv("exact", "hardware", 8, 2, h, h, 4, 4,
                            jag.ConvParams(3, 3, s), backend="cpu",
                            spec=_jspec("exact", None)).entry.name
        assert ref.replace("pallas", pre) == want


def test_conv_frontend_stays_bit_identical_off_the_bit_safe_geometries():
    gp = GemmParams(family="exact", bits=8, mode="hardware")
    for hh, ss in ((13, 4), (12, 3), (13, 3)):
        x, wt = _ops(2, hh, hh, 4, 4, 3, 3, seed=70 + hh)
        got = cim_conv2d(x, wt, gp, stride=ss)
        want = _oracle(x, wt, gp, ConvParams(3, 3, ss))
        assert torch.equal(got, want), (hh, ss)


def test_conv_plan_key_holds_the_bit_safety_flag():
    """12 and 13 share a shape bucket but not bit safety at stride 3: the
    frontend's plan cache keeps them apart, so the second geometry still
    runs the im2col oracle after the first ran the kernel.  At 12, input
    row 11 reaches no patch; the largest |x| is put there, so the
    kernel's scale (max|x|) would differ from the oracle's."""
    gp = GemmParams(family="appro42", bits=8, mode="hardware",
                    n_approx_cols=4)
    for hh in (13, 12):
        x, wt = _ops(2, hh, hh, 3, 5, 3, 3, seed=hh)
        x[0, 11, 0, 0] = 50.0
        assert torch.equal(cim_conv2d(x, wt, gp, stride=3),
                           _oracle(x, wt, gp, ConvParams(3, 3, 3)))


def test_conv_plan_routes_a_large_plane_to_the_kernel():
    """The reference's VMEM model (a whole padded plane in 8 MiB) sends a
    224x224 plane to the im2col fallback; the CUDA kernels hold no
    plane, only their table and a fixed halo and weight region (the
    fused tile kernel) or one A and B tile (the template: the partials
    and wide log), so the port's shared-memory gate admits it (ROADMAP
    queue C)."""
    spec = MultiplierSpec("exact", 8, True)
    big = plan_conv("exact", "hardware", 8, 4, 224, 224, 64, 64,
                    ConvParams(), "cuda", spec=spec)
    assert big.entry.name == "cuda_conv_nibble"
    ref = jag.plan_conv("exact", "hardware", 8, 4, 224, 224, 64, 64,
                        jag.ConvParams(), backend="cpu",
                        spec=_jspec("exact", None))
    assert ref.entry.name == "conv_im2col"
    assert conv_gemm.gemm_smem_bytes("lut", 8) == 217_104
    assert conv_gemm.gemm_smem_bytes("nibble", 8) == 111_632
    assert conv_gemm.gemm_smem_bytes("log", 8) == 106_512
    assert conv_gemm.template_smem_bytes("lut", 8) == 137_216
    assert conv_gemm.template_smem_bytes("nibble", 8) == 45_056
    assert conv_gemm.gemm_smem_bytes("log", 16) == 40_960
    assert conv_gemm.gemm_smem_bytes("mxu", 8) == 54_848
    for name in ag._CONV_CORES:
        assert ag._conv_kernel_fits(name, 8)


# kernel taps around the exact-mode tensor-core kernel's limit: one
# output pixel's halo, a 4-channel word a tap, fills its 16 KiB int8 halo
# at 4,096 taps
MXU_TAPS = [(3, 3), (63, 65), (1, 4095), (65, 65), (1, 4097), (4097, 1)]


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
@pytest.mark.parametrize("taps", MXU_TAPS, ids=str)
def test_exact_conv_beyond_the_kernel_halo_routes_to_im2col(taps, backend):
    """The exact-mode conv kernel takes up to conv_gemm.MXU_MAX_TAPS taps
    whatever the channels and the plane; a larger kernel goes to
    conv_im2col, on both devices alike, so every geometry still runs."""
    kh, kw = taps
    plan = plan_conv("exact", "exact", 8, 1, 8, 8, 4, 4,
                     ConvParams(kh, kw), backend)
    kernel = "cuda_conv_mxu" if backend == "cuda" else "torch_conv_mxu"
    fits = kh * kw <= conv_gemm.MXU_MAX_TAPS
    assert conv_gemm.MXU_MAX_TAPS == 4096
    assert plan.entry.name == (kernel if fits else "conv_im2col")


def test_exact_conv_with_more_taps_than_the_kernel_runs_im2col():
    """A 1 x 4097 exact-mode conv runs conv_im2col: finite, of its
    shape, and equal to im2col + cim_matmul."""
    gp = GemmParams(family="exact", bits=8, mode="exact")
    cp = ConvParams(1, 4097)
    x, wt = _ops(2, 3, 5, 2, 3, 1, 4097, seed=23)
    got = cim_conv2d(x, wt, gp, kh=1, kw=4097)
    assert got.shape == (2, 3, 5, 3) and bool(torch.isfinite(got).all())
    assert torch.equal(got, _oracle(x, wt, gp, cp))


def test_conv_params_reject_even_kernels_and_bad_stride():
    from repro_torch.models.cnn import _im2col

    with pytest.raises(ValueError, match="even conv kernels"):
        ConvParams(2, 2, 1)
    with pytest.raises(ValueError, match="stride"):
        ConvParams(3, 3, 0)
    with pytest.raises(ValueError, match="even conv kernels"):
        _im2col(torch.zeros((1, 8, 8, 3)), 4, 4)
    # the kernel wrappers reject even kernels too, not silently mis-pad
    x, w2 = torch.zeros((1, 8, 8, 3)), torch.zeros((2 * 2 * 3, 4))
    with pytest.raises(ValueError, match="even conv kernels"):
        ops.conv2d_log_fused(x, w2, kh=2, kw=2)
    with pytest.raises(ValueError, match="even conv kernels"):
        ops.conv2d_lut_fused(x, w2, MultiplierSpec("appro42", 8, True),
                             kh=2, kw=2)
    with pytest.raises(ValueError, match="weight rows"):
        cim_conv2d(x, torch.zeros((26, 4)),
                   GemmParams(family="mitchell", mode="hardware"))


# ------------------------------------ plain versions vs the JAX kernels ----


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("family,nac,core", HW_CASES)
def test_conv_plain_matches_jax_kernel(shape, family, nac, core):
    """The plain conv (the CUDA kernel's twin) bitwise against the
    reference's conv_lut_fused / conv_log_fused in interpret mode, given
    the same scales."""
    b, h, w, c, n, kh, kw, s = shape
    x, wt = _ops(b, h, w, c, n, kh, kw, seed=sum(shape))
    xn, w3 = x.numpy(), wt.numpy().reshape(kh * kw, c, n)
    sx = np.float32(np.abs(xn).max() / np.float32(127))
    sw = (np.abs(w3.reshape(-1, n)).max(axis=0)
          / np.float32(127)).astype(np.float32)
    geo = dict(kh=kh, kw=kw, stride=s)
    jargs = (jnp.asarray(xn), jnp.asarray(w3))
    targs = (x, torch.from_numpy(w3))
    tsc = (torch.tensor(sx), torch.from_numpy(sw))
    jsc = (jnp.asarray(sx), jnp.asarray(sw))
    if core == "log":
        comp = family == "log_our"
        got = conv_gemm.conv_log_fused(*targs, *tsc, compensated=comp, **geo)
        want = j_conv_log(*jargs, *jsc, compensated=comp, interpret=True,
                          **geo)
    else:
        nib = core == "nibble"
        spec = MultiplierSpec(family, 8, True, n_approx_cols=nac)
        js = _jspec(family, nac)
        ttab = ops.nibble_table(spec, "cpu") if nib else ops.lut_table(
            spec, "cpu")
        jtab = (nibble_sub_luts(js) if nib else signed_product_lut(js)).ravel()
        got = conv_gemm.conv_lut_fused(*targs, ttab, *tsc, nibble=nib, **geo)
        want = j_conv_lut(*jargs, jnp.asarray(jtab), *jsc, nibble=nib,
                          interpret=True, **geo)
    assert got.shape == (b,) + conv_out_hw(h, w, kh, kw, s) + (n,)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------- frontend vs oracle ----


@pytest.mark.parametrize("family,nac,core", HW_CASES)
def test_hardware_conv_bit_matches_im2col_oracle(family, nac, core):
    """cim_conv2d (the implicit kernel's plain version on the CPU) equals
    the materialized im2col + cim_matmul path bit for bit, across ragged
    shapes, every tap count and stride 2."""
    gp = GemmParams(family=family, bits=8, mode="hardware",
                    n_approx_cols=nac)
    for i, (b, h, w, c, n, kh, kw, s) in enumerate(SHAPES):
        cp = ConvParams(kh, kw, s)
        plan = plan_conv(family, "hardware", 8, b, h, w, c, n, cp, "cpu",
                         spec=gp.spec)
        assert plan.entry.name == f"torch_conv_{core}"
        x, wt = _ops(b, h, w, c, n, kh, kw, seed=i)
        got = cim_conv2d(x, wt, gp, kh=kh, kw=kw, stride=s)
        assert torch.equal(got, _oracle(x, wt, gp, cp)), (family, nac, i)


def test_surrogate_conv_runs_the_im2col_fallback():
    """Surrogate conv runs the materialized fallback: its deterministic
    term equals im2col + cim_matmul exactly (the noisy term: the next
    test)."""
    gp = GemmParams(family="appro42", bits=8, mode="surrogate", mu=-0.01)
    assert plan_conv("appro42", "surrogate", 8, 2, 8, 8, 4, 6, ConvParams(),
                     "cpu").entry.name == "conv_im2col"
    x, wt = _ops(2, 8, 8, 4, 6, 3, 3, seed=20)
    assert torch.equal(cim_conv2d(x, wt, gp),
                       _oracle(x, wt, gp, ConvParams()))


@pytest.mark.parametrize("family", ["exact", "appro42", "mitchell"])
def test_surrogate_conv_matches_oracle_with_same_key(family):
    """With a key, surrogate conv draws its (B*OH*OW, N) noise as
    im2col + cim_matmul does with the same key, so the two are equal
    (tests/test_conv.py's contract); another key moves the output."""
    from repro_torch.core.approx_gemm import NoiseKey

    gp = GemmParams(family=family, bits=8, mode="surrogate", mu=-0.01,
                    c0=40.0, c1=3e-4)
    for i, (b, h, w, c, n, kh, kw, s) in enumerate(SHAPES):
        cp = ConvParams(kh, kw, s)
        x, wt = _ops(b, h, w, c, n, kh, kw, seed=40 + i)
        got = cim_conv2d(x, wt, gp, NoiseKey(i), kh=kh, kw=kw, stride=s)
        cols = im2col_nhwc(x, cp)
        want = cim_matmul(cols.reshape(-1, cols.shape[-1]), wt, gp,
                          NoiseKey(i)).reshape(got.shape)
        assert torch.equal(got, want)
        assert not torch.equal(got, cim_conv2d(x, wt, gp, kh=kh, kw=kw,
                                               stride=s))


def test_exact_mode_conv_matches_oracle_fp32():
    """Exact mode runs the exact conv kernel's plain version on the CPU:
    within 1e-5 of im2col + cim_matmul (the dequantized dot), the
    reference test's tolerance for this route."""
    gp = GemmParams(family="exact", bits=8, mode="exact")
    for i, (b, h, w, c, n, kh, kw, s) in enumerate(SHAPES):
        cp = ConvParams(kh, kw, s)
        assert plan_conv("exact", "exact", 8, b, h, w, c, n, cp,
                         "cpu").entry.name == "torch_conv_mxu"
        x, wt = _ops(b, h, w, c, n, kh, kw, seed=10 + i)
        got = cim_conv2d(x, wt, gp, kh=kh, kw=kw, stride=s)
        np.testing.assert_allclose(got.numpy(),
                                   _oracle(x, wt, gp, cp).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_im2col_and_float_conv_match_the_reference():
    """im2col moves data only (bitwise); the float conv agrees with XLA's
    to f32 rounding (PyTorch and XLA sum in other orders)."""
    for b, h, w, c, n, kh, kw, s in SHAPES:
        x, wt = _ops(b, h, w, c, n, kh, kw, seed=30)
        cp = ConvParams(kh, kw, s)
        jcp = jag.ConvParams(kh, kw, s)
        cols = im2col_nhwc(x, cp)
        assert np.array_equal(cols.numpy(), np.asarray(
            jag.im2col_nhwc(jnp.asarray(x.numpy()), jcp)))
        want = np.asarray(jag._float_conv(jnp.asarray(x.numpy()),
                                          jnp.asarray(wt.numpy()), jcp))
        got = ag._float_conv(x, wt, cp)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        mat = (cols.reshape(-1, kh * kw * c) @ wt).reshape(got.shape)
        np.testing.assert_allclose(mat.numpy(), got.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_conv_grads_match_jax_float_conv_vjp():
    """The STE backward is the exact float conv's VJP: against jax.vjp of
    the reference's _float_conv, to f32 rounding (1e-5; the two sum in
    other orders)."""
    gp = GemmParams(family="exact", bits=8, mode="hardware")
    x, wt = _ops(2, 6, 6, 3, 4, 3, 3, seed=40)
    g = np.random.default_rng(9).standard_normal((2, 6, 6, 4)).astype(
        np.float32)
    cp = jag.ConvParams(3, 3, 1)
    _, vjp = jax.vjp(lambda a, b: jag._float_conv(a, b, cp),
                     jnp.asarray(x.numpy()), jnp.asarray(wt.numpy()))
    want_gx, want_gw = vjp(jnp.asarray(g))
    xr, wr = x.clone().requires_grad_(True), wt.clone().requires_grad_(True)
    out = cim_conv2d(xr, wr, gp)
    gx, gw = torch.autograd.grad(out, (xr, wr), torch.from_numpy(g))
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(want_gw), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------ models/cnn.py integration ----


def test_models_conv2d_fused_matches_materialized_baseline():
    """conv2d(fused=True) and the fused=False im2col + cim_linear baseline
    are the same computation, bit-identical in hardware mode, while exact
    mode (the QAT configuration) stays on the materialized fake-quant
    path in both forms, gradients included."""
    from repro_torch.models.cnn import conv2d
    from repro_torch.models.common import CiMContext, CiMParams

    x, wt = _ops(2, 8, 8, 4, 8, 3, 3, seed=1)
    for fam in ("appro42", "exact", "mitchell"):
        ctx = CiMContext(CiMParams(mode="hardware", family=fam, bits=8))
        assert torch.equal(conv2d(wt, x, ctx, "c", fused=True),
                           conv2d(wt, x, ctx, "c", fused=False))
    ctx_ex = CiMContext(CiMParams(mode="exact", bits=8))

    def grads(form):
        xr = x.clone().requires_grad_(True)
        wr = wt.clone().requires_grad_(True)
        loss = (conv2d(wr, xr, ctx_ex, "c", fused=form) ** 2).sum()
        return torch.autograd.grad(loss, (xr, wr))

    for g_fused, g_base in zip(grads(True), grads(False)):
        assert torch.equal(g_fused, g_base)


def test_models_conv2d_mixed_allocation_runs_exact_macro():
    """apply_to prefixes that exclude a conv drop it to the exact int8
    macro with cim_linear's fake-quant semantics."""
    from repro_torch.models.cnn import conv2d
    from repro_torch.models.common import CiMContext, CiMParams

    x, wt = _ops(2, 6, 6, 3, 4, 3, 3, seed=2)
    ctx = CiMContext(CiMParams(mode="hardware", family="mitchell", bits=8,
                               apply_to=("mlp",)))
    got = conv2d(wt, x, ctx, "c1", fused=True)
    assert torch.equal(got, conv2d(wt, x, ctx, "c1", fused=False))
    applied = conv2d(wt, x, CiMContext(CiMParams(
        mode="hardware", family="mitchell", bits=8)), "c1", fused=True)
    assert not torch.equal(got, applied)


# -------------------------------------------------------- plan cache ----


def test_conv_plan_misses_flat_on_repeated_calls():
    gp = GemmParams(family="appro42", bits=8, mode="hardware")
    x, wt = _ops(3, 8, 8, 4, 6, 3, 3, seed=50)
    a = cim_conv2d(x, wt, gp)
    n0 = plan_misses()
    for _ in range(3):
        assert torch.equal(cim_conv2d(x, wt, gp), a)
    cim_conv2d(x[:2], wt, gp)          # same bucket, smaller batch
    assert plan_misses() == n0
    cim_conv2d(torch.zeros((9, 8, 8, 4)), wt, gp)   # a new batch bucket
    assert plan_misses() == n0 + 1


def test_conv_bucket_keeps_taps_and_stride_exact():
    for args in ((3, 9, 10, 5, 3, 3, 2), (4, 12, 12, 6, 5, 5, 1),
                 (256, 16, 16, 3, 3, 3, 1)):
        assert bucket_conv(*args) == jautotune.bucket_conv(*args)
    assert bucket_conv(3, 9, 10, 5, 3, 3, 2) == (8, 16, 16, 8, 3, 3, 2)
