"""PyTorch port, surrogate mode (the compiler's default) and the exact-mode
conv, held to the JAX package on the CPU: the plain versions of the fused
surrogate kernels against the Pallas kernels in interpret mode, the
exact-mode conv against the JAX conv, routing, both frontends' surrogate
terms (deterministic, and given the same eps), the noise keys and their
moments, the STE with noise, the macro's warmup, and the smoke LM on the
surrogate ladder.

Tolerances:
  * D bitwise; SQ within rtol = atol = 3e-5 of the reference's f32 dot
    (the port rounds the exact value once, XLA sums in f32), as
    tests/test_kernels.py holds the Pallas kernel to its oracle;
  * the fused form without noise within 2^-21 relative (a few ulps) of
    the JAX kernel, D equal: the port rounds (f32(1+mu) * D) * s in that
    order (pinned below), while XLA reassociates the kernel's epilogue
    into an order that varies with the shape (D * (f32(1+mu) * s) at some;
    up to 4 ulps, 2.6 x 2^-23 relative, measured); with noise, given the
    same eps, rtol = atol = 3e-5 (tests/test_kernels.py:151-170);
  * the exact-mode conv within rtol = atol = 1e-5 of the JAX cim_conv2d
    (the port sums the integer products exactly and scales once, the
    reference sums dequantized products in f32 per tap), the tolerance
    of tests/test_conv.py:157-164;
  * the frontends' float paths within rtol 1e-5 (f32) or a few bf16 ulps
    (bf16), matrix products summed in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx_gemm as jag
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import approx_gemm as ag
from repro_torch.core.approx_gemm import (GemmParams, NoiseKey, cim_conv2d,
                                          cim_matmul, model_matmul,
                                          plan_misses, select_conv_kernel,
                                          select_kernel, surrogate_noise)
from repro_torch.core.compiler import CiMConfig, compile_macro
from repro_torch.kernels import cim_gemm, conv_gemm, ops, ref
from repro_torch.models.common import CiMContext, CiMParams, cim_linear

from test_torch_lm import _compare_with_reference, models  # noqa: F401

# tests/test_kernels.py's shapes and its cim_gemm_core shape
SHAPES = [(8, 16, 8), (33, 70, 17), (64, 64, 64), (128, 96, 40),
          (50, 129, 31)]
# (mu, c0, c1): the reference tests' coefficients, and a law with c1 = 0
COEFFS = [(-0.013, 1480.0, 2.1e-4), (0.02, 3.3, 0.0)]
# tests/test_conv.py's shapes (b, h, w, c, n, kh, kw, stride)
CONV_SHAPES = [(2, 9, 10, 5, 7, 3, 3, 1), (1, 7, 7, 3, 4, 5, 5, 1),
               (3, 8, 6, 4, 5, 1, 1, 1), (2, 10, 9, 3, 6, 3, 3, 2)]


def _ints(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (m, k), dtype=np.int8),
            rng.integers(-127, 128, (k, n), dtype=np.int8))


def _floats(*shapes, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _t(a):
    return torch.from_numpy(np.array(a))     # a writable copy


def _j(a):
    return jnp.asarray(np.asarray(a))


def _gp(mode="surrogate", family="log_our", coeffs=COEFFS[0], **kw):
    mu, c0, c1 = coeffs
    return (GemmParams(family=family, bits=8, mode=mode, mu=mu, c0=c0,
                       c1=c1, **kw),
            jag.GemmParams(family=family, bits=8, mode=mode, mu=mu, c0=c0,
                           c1=c1, **kw))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cim_gemm_core_matches_jax(shape):
    """D bitwise; SQ within 3e-5 of the reference's f32 dot (and within
    (K-1) 2^-24 of the exact value, which the port rounds once)."""
    m, k, n = shape
    xq, wq = _ints(m, k, n, seed=11)
    jd, jsq = jops.cim_gemm_core(_j(xq), _j(wq), need_sq=True,
                                 interpret=True)
    d, sq = cim_gemm.cim_gemm_core(_t(xq), _t(wq), need_sq=True)
    assert np.array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(sq.numpy(), np.asarray(jsq), rtol=3e-5,
                               atol=3e-5)
    exact = (xq.astype(np.float64) ** 2) @ (wq.astype(np.float64) ** 2)
    assert np.array_equal(sq.numpy(), exact.astype(np.float32))
    d0, sq0 = cim_gemm.cim_gemm_core(_t(xq), _t(wq), need_sq=False)
    assert torch.equal(d0, d) and not sq0.any()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("coeffs", COEFFS, ids=str)
def test_cim_gemm_fused_matches_jax(shape, coeffs):
    m, k, n = shape
    mu, c0, c1 = coeffs
    x, w, eps = _floats((m, k), (k, n), (m, n), seed=sum(shape))
    want = np.asarray(jops.surrogate_gemm_fused(_j(x), _j(w), None, mu, c0,
                                                c1, interpret=True))
    got = ops.surrogate_gemm_fused(_t(x), _t(w), None, mu, c0, c1).numpy()
    assert (np.abs(got - want) <= 2.0 ** -21 * np.abs(want)).all()
    # the port's op order, exactly
    sx, sw = ops._scales(_t(x), _t(w), 8)
    a = ref.quantize_tile(_t(x), sx, 127).numpy().astype(np.int64)
    b = ref.quantize_tile(_t(w), sw.reshape(1, -1), 127).numpy().astype(
        np.int64)
    d = (a @ b).astype(np.float32)
    f, s = np.float32(1.0 + mu), sx.numpy() * sw.numpy()
    assert np.array_equal(got, (f * d) * s)
    # with noise, given the same eps
    jn = np.asarray(jops.surrogate_gemm_fused(_j(x), _j(w), _j(eps), mu, c0,
                                              c1, interpret=True))
    tn = ops.surrogate_gemm_fused(_t(x), _t(w), _t(eps), mu, c0, c1).numpy()
    np.testing.assert_allclose(tn, jn, rtol=3e-5, atol=3e-5)
    assert not np.array_equal(tn, got)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_surrogate_gemm_int_surface_matches_jax(shape):
    """The int-in oracle surface (cim_gemm_core + the epilogue) against
    the reference's ops.surrogate_gemm and both ref.cim_gemm_ref."""
    m, k, n = shape
    xq, wq = _ints(m, k, n, seed=12)
    rng = np.random.default_rng(13)
    sx = np.float32(0.017)
    sw = rng.uniform(0.005, 0.02, n).astype(np.float32)
    (eps,) = _floats((m, n), seed=14)
    args = (-0.013, 1480.0, 2.1e-4)
    want = np.asarray(jops.surrogate_gemm(_j(xq), _j(wq), jnp.float32(sx),
                                          _j(sw), _j(eps), *args,
                                          interpret=True))
    jwant = np.asarray(jref.cim_gemm_ref(_j(xq), _j(wq), jnp.float32(sx),
                                         _j(sw), _j(eps), *args))
    tsx = torch.tensor(sx)
    got = ops.surrogate_gemm(_t(xq), _t(wq), tsx, _t(sw), _t(eps), *args)
    tref = ref.cim_gemm_ref(_t(xq), _t(wq), tsx, _t(sw), _t(eps), *args)
    for a, b in ((got, want), (got, jwant), (tref, jwant)):
        np.testing.assert_allclose(a.numpy(), b, rtol=3e-5, atol=3e-5)


def test_fused_plain_version_takes_bf16_operands():
    """bf16 operands are widened on load (exact), as the other fused
    runners: the result equals the f32 run on the widened values."""
    x, w, eps = _floats((16, 48), (48, 24), (16, 24), seed=5)
    xb, wb = _t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16)
    for e in (None, _t(eps)):
        a = ops.surrogate_gemm_fused(xb, wb, e, -0.013, 1480.0, 2.1e-4)
        b = ops.surrogate_gemm_fused(xb.float(), wb.float(), e, -0.013,
                                     1480.0, 2.1e-4)
        assert a.dtype == torch.float32 and torch.equal(a, b)
    with pytest.raises(ValueError, match="eps must be"):
        ops.surrogate_gemm_fused(xb, wb, _t(eps)[:3], -0.013, 1480.0, 2e-4)


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_conv_mxu_matches_jax_exact_mode_conv(shape):
    """The exact-mode conv's plain version against the JAX cim_conv2d in
    exact mode (routed to pallas_conv_mxu) and against the Pallas kernel
    in interpret mode, within 1e-5; the port's own route is the plain
    version, bit for bit."""
    b, h, w, c, n, kh, kw, s = shape
    x, wt = _floats((b, h, w, c), (kh * kw * c, n), seed=sum(shape))
    gp, jgp = _gp(mode="exact", family="exact", coeffs=(0.0, 0.0, 0.0))
    want = np.asarray(jag.cim_conv2d(_j(x), _j(wt), jgp, kh=kh, kw=kw,
                                     stride=s))
    jk = np.asarray(jops.conv2d_mxu_fused(_j(x), _j(wt), kh=kh, kw=kw,
                                          stride=s, interpret=True))
    plain = ops.conv2d_mxu_fused(_t(x), _t(wt), kh=kh, kw=kw, stride=s)
    got = cim_conv2d(_t(x), _t(wt), gp, kh=kh, kw=kw, stride=s)
    assert torch.equal(got, plain)
    for ref_out in (want, jk):
        np.testing.assert_allclose(got.numpy(), ref_out, rtol=1e-5,
                                   atol=1e-5)


def test_conv_mxu_routes_every_geometry_and_fits_shared_memory():
    """The exact-mode kernel is bounded by f32 rounding, not bitwise
    against im2col: like the reference's pallas_conv_mxu it also takes
    the geometries the bit-safety gate sends to conv_im2col in hardware
    mode, and its block (the tensor-core kernel's int8 halo and weight
    tiles, one fixed total for every geometry, no table) fits easily."""
    cp = ag.ConvParams(1, 1, 2)                     # stride > kernel
    assert not ag._conv_bit_exact_safe(8, 8, cp)
    assert ag.plan_conv("exact", "exact", 8, 2, 8, 8, 4, 4, cp,
                        "cpu").entry.name == "torch_conv_mxu"
    assert ag.plan_conv("exact", "hardware", 8, 2, 8, 8, 4, 4, cp,
                        "cpu").entry.name == "conv_im2col"
    assert jag.plan_conv("exact", "exact", 8, 2, 8, 8, 4, 4,
                         jag.ConvParams(1, 1, 2),
                         backend="cpu").entry.name == "pallas_conv_mxu"
    assert conv_gemm.gemm_smem_bytes("mxu", 8) == 54_848
    assert ag._conv_kernel_fits("cuda_conv_mxu", 8)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ag.FAMILIES)
def test_surrogate_routing_mirrors_reference(family):
    """surrogate -> the fused kernel on the card (the reference's TPU
    route pallas_fused_surrogate) and the plain route on the CPU (its
    xla_surrogate); surrogate_fast -> the plain route everywhere; an
    exact-mode conv -> the exact conv kernel."""
    assert jag.select_kernel(family, "surrogate", 8,
                             backend="tpu").name == "pallas_fused_surrogate"
    assert jag.select_kernel(family, "surrogate", 8,
                             backend="cpu").name == "xla_surrogate"
    assert select_kernel(family, "surrogate", 8,
                         "cuda").name == "cuda_fused_surrogate"
    assert select_kernel(family, "surrogate", 8,
                         "cpu").name == "torch_surrogate"
    for backend in ("cpu", "cuda"):
        assert jag.select_kernel(family, "surrogate_fast", 8,
                                 backend="tpu").name == "xla_surrogate"
        assert select_kernel(family, "surrogate_fast", 8,
                             backend).name == "torch_surrogate"
        pre = "cuda" if backend == "cuda" else "torch"
        assert select_conv_kernel(family, "exact", 8,
                                  backend).name == f"{pre}_conv_mxu"
        assert select_conv_kernel(family, "surrogate", 8,
                                  backend).name == "conv_im2col"


def test_fused_surrogate_runs_through_the_model_frontend_kernel_path():
    """The model frontend's card route (the fused runner under the STE)
    equals the kernel's plain version, cast to the activation dtype."""
    gp, _ = _gp()
    x, w = _floats((6, 64), (64, 40), seed=2, scale=0.5)
    xb, wb = _t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16)
    plan = ag.GemmPlan(entry=ag._REGISTRY["cuda_fused_surrogate"],
                       backend="cpu")
    got = ag._model_forward(gp, plan, True)(xb.reshape(2, 3, 64), wb)
    want = ops.surrogate_gemm_fused(xb, wb, None, gp.mu, gp.c0, gp.c1)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.reshape(6, 40), want.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the frontends against the JAX package (CPU routes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["surrogate", "surrogate_fast"])
def test_deterministic_surrogate_term_matches_jax(mode):
    """Without a key both frontends give (1+mu) times the quantized dot:
    the macro's in f32, the model's in the activation dtype."""
    gp, jgp = _gp(mode=mode)
    x, w = _floats((2, 5, 48), (48, 24), seed=3)
    want = np.asarray(jag.cim_matmul(_j(x), _j(w), jgp))
    got = cim_matmul(_t(x), _t(w), gp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 2.0 ** -6)):
        jm = np.asarray(jag.model_matmul(_j(x).astype(jdt),
                                         _j(w).astype(jdt), jgp),
                        np.float32)
        tm = model_matmul(_t(x).to(dt), _t(w).to(dt), gp)
        assert tm.dtype == dt
        np.testing.assert_allclose(tm.float().numpy(), jm, rtol=tol,
                                   atol=tol * np.abs(jm).max())


@pytest.mark.parametrize("mode", ["surrogate", "surrogate_fast"])
@pytest.mark.parametrize("coeffs", COEFFS, ids=str)
def test_noise_term_matches_jax_given_the_same_eps(mode, coeffs):
    """The variance law through both frontends' CPU routes, fed the same
    eps as the reference's forward: the full c1 * (A^2 @ B^2) law and
    surrogate_fast's rank-1 estimate."""
    gp, jgp = _gp(mode=mode, coeffs=coeffs)
    x, w, eps = _floats((12, 40), (40, 16), (12, 16), seed=4)
    plan = ag.plan_gemm(gp.family, mode, 8, 12, 40, 16, "cpu")
    jplan = jag.plan_gemm(jgp.family, mode, 8, 12, 40, 16, backend="cpu")
    jfwd, takes = jag._cim_forward(jgp, jplan, "normal", True, True)
    assert takes
    want = np.asarray(jfwd(_j(x), _j(w), _j(eps)))
    got = ag._cim_core(gp, plan)(_t(x), _t(w), _t(eps))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    det = ag._cim_core(gp, plan)(_t(x), _t(w))
    assert not torch.equal(got, det)
    # the model frontend's fake-quant form: the reference draws eps from
    # its key inside; the port takes the same values as its eps
    key = jax.random.PRNGKey(9)
    jeps = jag.surrogate_noise(key, (12, 16), jnp.float32, "rademacher")
    _, jfn, noisy = jag._model_forward(jgp, jplan, "rademacher", True, True,
                                       True)
    assert noisy
    want_m = np.asarray(jfn(_j(x), _j(w), key))
    got_m = ag._model_forward(gp, plan, True)(_t(x), _t(w),
                                              _t(np.asarray(jeps)))
    np.testing.assert_allclose(got_m.numpy(), want_m, rtol=1e-5, atol=1e-5)


def test_surrogate_conv_matches_jax_given_the_same_eps():
    """Surrogate conv runs im2col + the GEMM route with the (B*OH*OW, N)
    noise; fed the reference's eps it matches its forward."""
    b, h, w, c, n, kh, kw, s = CONV_SHAPES[0]
    x, wt, eps = _floats((b, h, w, c), (kh * kw * c, n), (b * h * w, n),
                         seed=6)
    gp, jgp = _gp(family="appro42")
    jplan = jag.plan_conv("appro42", "surrogate", 8, b, h, w, c, n,
                          jag.ConvParams(kh, kw, s), backend="cpu")
    jfwd, takes = jag._conv_forward(jgp, jplan, "normal", True,
                                    (b, h, w, c, n))
    assert takes and jplan.entry.name == "conv_im2col"
    want = np.asarray(jfwd(_j(x), _j(wt), _j(eps)))
    plan = ag.plan_conv("appro42", "surrogate", 8, b, h, w, c, n,
                        ag.ConvParams(kh, kw, s), "cpu")
    got = ag._conv_forward(gp, plan, (b, h, w, c, n))(_t(x), _t(wt),
                                                      _t(eps))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# noise keys, moments, streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["normal", "rademacher"])
def test_noise_is_reproducible_per_key_with_unit_moments(kind):
    """The same key gives the same noise, another key other noise; at
    M*N = 2^17 the standardized output deviation (out - det) / sqrt(var)
    has mean ~0 and variance ~1 within five standard errors."""
    gp, _ = _gp(mode="surrogate", family="appro42",
                coeffs=(-0.01, 40.0, 3e-4))
    x, w = _floats((256, 64), (64, 512), seed=8)
    tx, tw = _t(x), _t(w)
    det = cim_matmul(tx, tw, gp)
    a = cim_matmul(tx, tw, gp, NoiseKey(1), noise_kind=kind)
    assert torch.equal(a, cim_matmul(tx, tw, gp, NoiseKey(1),
                                     noise_kind=kind))
    assert not torch.equal(a, cim_matmul(tx, tw, gp, NoiseKey(2),
                                         noise_kind=kind))
    xq, sx, wq, sw = ag._quantize_operands(tx, tw, 8)
    xd, wd = (xq.double() * sx.double()), (wq.double() * sw.double())
    s2 = (sx.double() * sw.double()) ** 2
    var = gp.c0 * 64 * s2 + gp.c1 * ((xd * xd) @ (wd * wd))
    z = (a.double() - det.double()) / var.sqrt()
    n = z.numel()
    assert n >= 1 << 17
    assert abs(float(z.mean())) <= 5 / n ** 0.5
    assert abs(float(z.var()) - 1) <= 5 * (2 / n) ** 0.5
    eps = surrogate_noise(NoiseKey(1), (256, 512), "cpu", kind)
    assert torch.allclose(z.float(), eps, atol=1e-3)


def test_noise_keys_and_context_children_give_distinct_streams():
    k = NoiseKey(7)
    assert k.child("wq") == k.child("wq")
    assert len({k.child(nm).seed for nm in ("wq", "wk", "wv", "mlp_wi")}
               | {k.seed}) == 5
    assert NoiseKey(8).child("wq") != k.child("wq")
    with pytest.raises(ValueError):
        NoiseKey(-1)
    with pytest.raises(TypeError):
        surrogate_noise(7, (2, 2), "cpu")
    with pytest.raises(ValueError, match="noise kind"):
        surrogate_noise(k, (2, 2), "cpu", "uniform")
    p = CiMParams(mode="surrogate", family="appro42", mu=-0.01, c0=40.0,
                  c1=3e-4)
    ctx = CiMContext(p, k)
    assert ctx.child("wq").key == k.child("wq")
    assert CiMContext(p).child("wq").key is None
    x, w = _floats((4, 32), (32, 16), seed=10)
    tx, tw = _t(x), _t(w)
    a = cim_linear(tx, tw, ctx, "wq")
    assert torch.equal(a, cim_linear(tx, tw, ctx, "wq"))
    assert not torch.equal(a, cim_linear(tx, tw, ctx, "wk"))
    assert torch.equal(a, model_matmul(tx, tw, p.gemm_params(),
                                       k.child("wq")))
    assert not torch.equal(a, cim_linear(tx, tw, CiMContext(p), "wq"))


def test_noise_needs_a_surrogate_mode_and_a_variance_law():
    """No key, a non-surrogate mode, apply=False or c0 = c1 = 0: the
    deterministic output, and the plan built for it."""
    x, w = _floats((4, 32), (32, 16), seed=12)
    tx, tw = _t(x), _t(w)
    for mode in ("exact", "hardware"):
        gp = GemmParams(family="appro42", bits=8, mode=mode, c0=40.0,
                        c1=3e-4)
        assert torch.equal(cim_matmul(tx, tw, gp, NoiseKey(3)),
                           cim_matmul(tx, tw, gp))
    quiet = GemmParams(family="exact", bits=8, mode="surrogate")
    assert torch.equal(cim_matmul(tx, tw, quiet, NoiseKey(3)),
                       cim_matmul(tx, tw, quiet))
    gp, _ = _gp()
    assert torch.equal(model_matmul(tx, tw, gp, NoiseKey(3), apply=False),
                       model_matmul(tx, tw, gp, apply=False))


# ---------------------------------------------------------------------------
# the STE with noise; plan caching; the macro
# ---------------------------------------------------------------------------


def test_ste_backward_ignores_the_noise():
    """With noise drawn the backward is still g @ w.T / x.T @ g, and the
    pre-drawn eps gets a zero cotangent."""
    gp, _ = _gp()
    x, w, g = _floats((2, 6, 32), (32, 20), (2, 6, 20), seed=15)
    tx = _t(x).requires_grad_(True)
    tw = _t(w).requires_grad_(True)
    out = cim_matmul(tx, tw, gp, NoiseKey(4))
    out.backward(_t(g))
    g2 = _t(g).reshape(-1, 20)
    assert torch.allclose(tx.grad, (g2 @ _t(w).T).reshape(2, 6, 32))
    assert torch.allclose(tw.grad, _t(x).reshape(-1, 32).T @ g2)
    eps = surrogate_noise(NoiseKey(4), (12, 20), "cpu").requires_grad_(True)
    plan = ag.plan_gemm(gp.family, gp.mode, 8, 12, 32, 20, "cpu")
    y = ag._STEMatmul.apply(_t(x).reshape(-1, 32), _t(w), eps,
                            ag._cim_core(gp, plan))
    y.sum().backward()
    assert eps.grad is not None and not eps.grad.any()


def test_surrogate_conv_ste_gradient_is_the_float_conv():
    gp, _ = _gp(family="appro42")
    b, h, w, c, n, kh, kw, s = CONV_SHAPES[0]
    x, wt = _floats((b, h, w, c), (kh * kw * c, n), seed=16)
    tx = _t(x).requires_grad_(True)
    tw = _t(wt).requires_grad_(True)
    cim_conv2d(tx, tw, gp, NoiseKey(5), kh=kh, kw=kw, stride=s).sum() \
        .backward()
    xs = [_t(a).requires_grad_(True) for a in (x, wt)]
    ag._float_conv(*xs, ag.ConvParams(kh, kw, s)).sum().backward()
    assert torch.allclose(tx.grad, xs[0].grad, atol=1e-5)
    assert torch.allclose(tw.grad, xs[1].grad, atol=1e-5)


def test_plan_cache_keys_on_noise_drawn_or_not():
    gp, _ = _gp(coeffs=(-0.02, 7.0, 1e-4))
    x, w = _floats((5, 24), (24, 12), seed=17)
    tx, tw = _t(x), _t(w)
    m0 = plan_misses()
    cim_matmul(tx, tw, gp)
    m1 = plan_misses()
    cim_matmul(tx, tw, gp, NoiseKey(1))
    m2 = plan_misses()
    cim_matmul(tx, tw, gp, NoiseKey(2))
    cim_matmul(tx, tw, gp)
    assert (m1 - m0, m2 - m1, plan_misses() - m2) == (1, 1, 0)


def test_macro_warmup_leaves_nothing_to_build():
    """The quickstart's macro: warmup builds the deterministic and the
    noisy plan per shape, so matmul with and without a key (and a new
    key) builds nothing; matmul's modes route as the macro's."""
    macro = compile_macro(CiMConfig(family="log_our", bits=8,
                                    mode="surrogate"))
    shapes = [(4, 40, 24), (16, 40, 8)]
    assert macro.warmup(shapes, device="cpu") == 2
    mark = plan_misses()
    for m, k, n in shapes:
        x, w = _floats((m, k), (k, n), seed=m)
        det = macro.matmul(_t(x), _t(w))
        a = macro.matmul(_t(x), _t(w), key=NoiseKey(3))
        assert a.shape == det.shape == (m, n)
        assert torch.isfinite(a).all()
    assert plan_misses() == mark
    assert macro.kernel_plan(4, 40, 24).entry.name == "cuda_fused_surrogate"
    exact = macro.matmul(_t(x), _t(w), mode="exact")
    assert not torch.equal(exact, det)


# ---------------------------------------------------------------------------
# the smoke LM on the surrogate ladder against the JAX LM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["exact", "balanced", "economy"])
def test_lm_on_the_surrogate_ladder_matches_reference(models, tier,
                                                      record_property):
    """build_tiers(mode="surrogate") on the CPU (torch_surrogate, the
    reference's xla_surrogate route: fake-quant dot times (1+mu), no
    key) against the JAX LM, with test_torch_lm.py's tolerances and
    top-2 gap rule; four prompts, as this random model's logits are
    nearly flat and two rows leave no top-2 gap above the tolerance."""
    record_property("positions_under_gap_rule",
                    _compare_with_reference(models, tier, attn=False, b=4,
                                            mode="surrogate"))


def test_surrogate_ladder_lanes_are_deterministic_and_distinct():
    """Serving threads no key: a surrogate lane serves the same tokens
    twice, and its mean shift moves the logits off the exact lane's."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serving.tiers import build_tiers

    cfg = get_config("qwen3-1.7b", smoke=True)
    params = LM(cfg, device="cpu").init(0)
    toks = torch.randint(0, cfg.vocab, (2, 6),
                         generator=torch.Generator().manual_seed(1))
    ladder = {t.name: t for t in build_tiers(mode="surrogate")}
    outs = {}
    for tier in ("exact", "economy"):
        lm = LM(dataclasses.replace(cfg, cim=ladder[tier].cim), device="cpu")
        with torch.inference_mode():
            a = lm.forward_logits(params, toks)
            b = lm.forward_logits(params, toks)
        assert torch.equal(a, b)
        outs[tier] = a
    assert not torch.equal(outs["exact"], outs["economy"])
