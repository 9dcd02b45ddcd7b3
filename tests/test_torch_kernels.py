"""PyTorch port, GEMM kernels: the plain versions the CUDA kernels are
held to on the card, held here bitwise against the JAX package — its
oracles (repro.kernels.ref) and its Pallas kernels in interpret mode.

Int forms: int32 accumulators bitwise equal.  Fused forms: bitwise equal
given the same sx, sw (passed explicitly, which keeps XLA's 1-ulp
rewrite of x / (m / qmax) out of the comparison)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.luts import nibble_sub_luts, signed_product_lut
from repro.core.multipliers import MultiplierSpec as JSpec
from repro.kernels import ref as jref
from repro.kernels.approx_matmul import lut_matmul as j_lut
from repro.kernels.approx_matmul import lut_matmul_fused as j_lut_fused
from repro.kernels.approx_matmul import nibble_lut_matmul as j_nib
from repro.kernels.approx_matmul import nibble_lut_matmul_fused as j_nib_fused
from repro.kernels.mitchell_gemm import mitchell_matmul as j_log
from repro.kernels.mitchell_gemm import mitchell_matmul_fused as j_log_fused
from repro_torch.core.multipliers import MultiplierSpec as TSpec
from repro_torch.core.quantization import quant_scale
from repro_torch.kernels import approx_matmul, build, mitchell_gemm, ops
from repro_torch.kernels import ref as tref

SHAPES = [(8, 16, 8), (33, 70, 17), (64, 64, 64), (128, 96, 40)]
# the balanced tier's multiplier and the exact table
LUT_SPECS = [("appro42", "orplane", 10), ("exact", "yang1", None)]
# the nibble-decomposable multipliers: the exact table (the Table IV exact
# family's fc) and appro42 with its approximate columns in the low half
NIBBLE_SPECS = [("exact", None), ("appro42", 4), ("appro42", 2)]


def _int_ops(m, k, n, seed=0, lo=-127):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, 128, (m, k), dtype=np.int8),
            rng.integers(lo, 128, (k, n), dtype=np.int8))


def _float_ops(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    return x, w


def _scales(x, w):
    qmax = 127
    sx = np.float32(np.maximum(np.abs(x).max(), np.float32(1e-8))
                    / np.float32(qmax))
    sw = (np.maximum(np.abs(w).max(axis=0), np.float32(1e-8))
          / np.float32(qmax)).astype(np.float32)
    return sx, sw


def _table(family, comp, nac):
    spec = TSpec(family, 8, True, comp, nac)
    return ops.lut_table(spec, "cpu"), signed_product_lut(
        JSpec(family, 8, True, comp, nac)).ravel()


@pytest.mark.parametrize("shape", SHAPES + [(5, 9, 6, "int8-min")],
                         ids=str)
@pytest.mark.parametrize("spec", LUT_SPECS, ids=str)
def test_lut_int_plain_matches_reference(shape, spec):
    m, k, n = shape[:3]
    lo = -128 if len(shape) == 4 else -127
    xq, wq = _int_ops(m, k, n, seed=m + n, lo=lo)
    if lo == -128:
        xq[:, 0] = -128
        wq[0, :] = -128
    t16, j32 = _table(*spec)
    got = approx_matmul.lut_matmul(torch.from_numpy(xq),
                                   torch.from_numpy(wq), t16).numpy()
    want = np.asarray(jref.lut_matmul_ref(jnp.asarray(xq), jnp.asarray(wq),
                                          jnp.asarray(j32)))
    kern = np.asarray(j_lut(jnp.asarray(xq), jnp.asarray(wq),
                            jnp.asarray(j32), block=(32, 32, 128),
                            interpret=True))
    assert got.dtype == np.int32
    assert np.array_equal(got, want) and np.array_equal(got, kern)
    assert np.array_equal(
        tref.lut_matmul_ref(torch.from_numpy(xq), torch.from_numpy(wq),
                            t16).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES + [(5, 9, 6, "int8-min")],
                         ids=str)
@pytest.mark.parametrize("compensated", [False, True])
def test_log_int_plain_matches_reference(shape, compensated):
    m, k, n = shape[:3]
    lo = -128 if len(shape) == 4 else -127
    xq, wq = _int_ops(m, k, n, seed=3 + m, lo=lo)
    if lo == -128:
        xq[:, 0] = -128
        wq[0, :] = -128
    got = mitchell_gemm.mitchell_matmul(torch.from_numpy(xq),
                                        torch.from_numpy(wq),
                                        compensated=compensated).numpy()
    want = np.asarray(jref.mitchell_matmul_ref(
        jnp.asarray(xq), jnp.asarray(wq), compensated=compensated))
    kern = np.asarray(j_log(jnp.asarray(xq), jnp.asarray(wq),
                            compensated=compensated, block=(32, 32, 32),
                            interpret=True))
    assert got.dtype == np.int32
    assert np.array_equal(got, want) and np.array_equal(got, kern)


@pytest.mark.parametrize("bits", [4, 6])
def test_lut_int_refuses_operands_outside_the_table(bits):
    """Below 8 bits an int8 operand can lie outside the 2^b-row table;
    the wrapper refuses it (the kernel would read past its table) and
    matches the reference on operands inside it."""
    half = 1 << (bits - 1)
    rng = np.random.default_rng(bits)
    xq = rng.integers(-half, half, (6, 20), dtype=np.int8)
    wq = rng.integers(-half, half, (20, 5), dtype=np.int8)
    t16 = ops.lut_table(TSpec("appro42", bits, True, "orplane"), "cpu")
    j32 = signed_product_lut(JSpec("appro42", bits, True, "orplane")).ravel()
    got = approx_matmul.lut_matmul(torch.from_numpy(xq), torch.from_numpy(wq),
                                   t16, bits=bits).numpy()
    want = np.asarray(jref.lut_matmul_ref(jnp.asarray(xq), jnp.asarray(wq),
                                          jnp.asarray(j32), bits=bits))
    assert np.array_equal(got, want)
    for bad in (half, -half - 1):
        xb = xq.copy()
        xb[2, 3] = bad
        with pytest.raises(ValueError, match="lie in"):
            approx_matmul.lut_matmul(torch.from_numpy(xb),
                                     torch.from_numpy(wq), t16, bits=bits)
        wb = wq.copy()
        wb[3, 2] = bad
        with pytest.raises(ValueError, match="lie in"):
            approx_matmul.lut_matmul(torch.from_numpy(xq),
                                     torch.from_numpy(wb), t16, bits=bits)


def test_log_int_wraps_like_int32_at_16_bits():
    """16-bit operands overflow an int32 sum; the plain version wraps as
    the reference's int32 sum does."""
    rng = np.random.default_rng(5)
    xq = rng.integers(20000, 32768, (2, 64)).astype(np.int32)
    wq = rng.integers(20000, 32768, (64, 3)).astype(np.int32)
    got = mitchell_gemm.mitchell_matmul(torch.from_numpy(xq),
                                        torch.from_numpy(wq), bits=16).numpy()
    want = np.asarray(jref.mitchell_matmul_ref(jnp.asarray(xq),
                                               jnp.asarray(wq), bits=16))
    assert np.array_equal(got, want)
    exact_sum = xq.astype(np.int64) @ wq.astype(np.int64)
    assert (np.abs(exact_sum) > 2 ** 31).any()     # the sum did wrap


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("spec", LUT_SPECS, ids=str)
def test_lut_fused_plain_matches_jax_kernel(shape, spec):
    m, k, n = shape
    x, w = _float_ops(m, k, n, seed=m * n)
    sx, sw = _scales(x, w)
    t16, j32 = _table(*spec)
    got = approx_matmul.lut_matmul_fused(
        torch.from_numpy(x), torch.from_numpy(w), t16,
        torch.tensor(sx), torch.from_numpy(sw)).numpy()
    want = np.asarray(j_lut_fused(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(j32), jnp.asarray(sx),
                                  jnp.asarray(sw), block=(32, 32, 128),
                                  interpret=True))
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("compensated", [False, True])
def test_log_fused_plain_matches_jax_kernel(shape, compensated):
    m, k, n = shape
    x, w = _float_ops(m, k, n, seed=m + k)
    sx, sw = _scales(x, w)
    got = mitchell_gemm.mitchell_matmul_fused(
        torch.from_numpy(x), torch.from_numpy(w), torch.tensor(sx),
        torch.from_numpy(sw), compensated=compensated).numpy()
    want = np.asarray(j_log_fused(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(sx), jnp.asarray(sw),
                                  compensated=compensated,
                                  block=(32, 32, 32), interpret=True))
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_fused_equals_quantize_int_dequantize():
    """The fused plain forms are the int forms between quantization and
    the (acc * sx) * sw epilogue, bit for bit."""
    x, w = _float_ops(17, 40, 9, seed=1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    sx, sw = ops._scales(tx, tw, 8)
    xq = torch.clamp(torch.round(tx / sx), -127, 127).to(torch.int8)
    wq = torch.clamp(torch.round(tw / sw), -127, 127).to(torch.int8)
    spec = TSpec("appro42", 8, True, "orplane", 10)
    want = (ops.approx_matmul_bit_exact(xq, wq, spec).float() * sx) * sw
    assert torch.equal(ops.approx_matmul_fused(tx, tw, spec), want)
    want = (ops.log_matmul(xq, wq, compensated=False).float() * sx) * sw
    assert torch.equal(ops.log_matmul_fused(tx, tw, compensated=False), want)


def test_bf16_operands_widen_exactly():
    """bf16 operands give the same result as their f32 widening (the
    kernels take bf16 weights and widen on load)."""
    x, w = _float_ops(9, 48, 20, seed=2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    spec = TSpec("appro42", 8, True, "orplane", 10)
    assert torch.equal(ops.approx_matmul_fused(xb, wb, spec),
                       ops.approx_matmul_fused(xb.float(), wb.float(), spec))
    assert torch.equal(ops.log_matmul_fused(xb, wb),
                       ops.log_matmul_fused(xb.float(), wb.float()))


def test_scales_match_quant_scale():
    x, w = _float_ops(6, 30, 11, seed=4)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    sx, sw = ops._scales(torch.from_numpy(x), wb, 8)
    assert torch.equal(sx, quant_scale(torch.from_numpy(x), 8))
    assert torch.equal(sw, quant_scale(wb.float(), 8, axis=0).reshape(-1))


def test_wrappers_refuse_other_devices_and_mixes():
    x = torch.zeros((4, 8), dtype=torch.int8, device="meta")
    w = torch.zeros((8, 4), dtype=torch.int8, device="meta")
    t16 = ops.lut_table(TSpec("exact", 8, True), "meta")
    with pytest.raises(ValueError, match="device"):
        approx_matmul.lut_matmul(x, w, t16)
    with pytest.raises(ValueError, match="device"):
        mitchell_gemm.mitchell_matmul(x, torch.zeros((8, 4),
                                                     dtype=torch.int8))
    with pytest.raises(ValueError, match="contraction"):
        mitchell_gemm.mitchell_matmul(torch.zeros((4, 8), dtype=torch.int8),
                                      torch.zeros((7, 4), dtype=torch.int8))


# ------------------------------------------------- nibble sub-LUT GEMMs ----


def _subs(family, nac):
    spec = TSpec(family, 8, True, n_approx_cols=nac)
    jspec = JSpec(family, 8, True, n_approx_cols=nac)
    return (ops.nibble_table(spec, "cpu"), nibble_sub_luts(jspec).ravel(),
            signed_product_lut(jspec).ravel())


@pytest.mark.parametrize("shape", SHAPES + [(5, 9, 6, "int8-min")],
                         ids=str)
@pytest.mark.parametrize("spec", NIBBLE_SPECS, ids=str)
def test_nibble_int_plain_matches_reference(shape, spec):
    """The int form over the sub-tables: bitwise equal to the JAX
    kernel (interpret mode) and to the full-table oracle, with |-128|
    saturating to 127 as the signed table's sign-magnitude wrapper."""
    m, k, n = shape[:3]
    lo = -128 if len(shape) == 4 else -127
    xq, wq = _int_ops(m, k, n, seed=11 + m + n, lo=lo)
    if lo == -128:
        xq[:, 0] = -128
        wq[0, :] = -128
    tsub, jsub, jfull = _subs(*spec)
    got = approx_matmul.nibble_lut_matmul(torch.from_numpy(xq),
                                          torch.from_numpy(wq), tsub).numpy()
    kern = np.asarray(j_nib(jnp.asarray(xq), jnp.asarray(wq),
                            jnp.asarray(jsub), interpret=True))
    full = np.asarray(jref.lut_matmul_ref(jnp.asarray(xq), jnp.asarray(wq),
                                          jnp.asarray(jfull)))
    assert got.dtype == np.int32
    assert np.array_equal(got, kern) and np.array_equal(got, full)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("spec", NIBBLE_SPECS, ids=str)
def test_nibble_fused_plain_matches_jax_kernel(shape, spec):
    m, k, n = shape
    x, w = _float_ops(m, k, n, seed=m * k + 1)
    sx, sw = _scales(x, w)
    tsub, jsub, _ = _subs(*spec)
    got = approx_matmul.nibble_lut_matmul_fused(
        torch.from_numpy(x), torch.from_numpy(w), tsub, torch.tensor(sx),
        torch.from_numpy(sw)).numpy()
    want = np.asarray(j_nib_fused(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(jsub), jnp.asarray(sx),
                                  jnp.asarray(sw), interpret=True))
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("k_slice", [4, 16, 32])
def test_nibble_kernel_k_slice_invariance(k_slice):
    """The reference's k_slice (its live gather temporary) changes no
    sum: the plain version equals the JAX kernel at every slice."""
    xq, wq = _int_ops(24, 70, 12, seed=k_slice)
    tsub, jsub, _ = _subs("appro42", 4)
    got = approx_matmul.nibble_lut_matmul(torch.from_numpy(xq),
                                          torch.from_numpy(wq), tsub).numpy()
    kern = np.asarray(j_nib(jnp.asarray(xq), jnp.asarray(wq),
                            jnp.asarray(jsub), block=(8, 32, 128),
                            k_slice=k_slice, interpret=True))
    assert np.array_equal(got, kern)


def test_nibble_fused_equals_quantize_int_dequantize():
    x, w = _float_ops(17, 40, 9, seed=6)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    sx, sw = ops._scales(tx, tw, 8)
    xq = torch.clamp(torch.round(tx / sx), -127, 127).to(torch.int8)
    wq = torch.clamp(torch.round(tw / sw), -127, 127).to(torch.int8)
    spec = TSpec("exact", 8, True)
    want = (ops.nibble_matmul_bit_exact(xq, wq, spec).float() * sx) * sw
    assert torch.equal(ops.nibble_matmul_fused(tx, tw, spec), want)
    xb, wb = tx.to(torch.bfloat16), tw.to(torch.bfloat16)
    assert torch.equal(ops.nibble_matmul_fused(xb, wb, spec),
                       ops.nibble_matmul_fused(xb.float(), wb.float(), spec))


def test_nibble_table_is_one_int32_form():
    """GEMM, conv and attention take one storage form of the sub-tables,
    and an undecomposable spec has none."""
    spec = TSpec("appro42", 8, True, n_approx_cols=4)
    subs = ops.nibble_table(spec, "cpu")
    assert subs.dtype == torch.int32 and subs.numel() == 4 << 8
    assert ops._attn_table("nibble", spec, "cpu") is subs
    assert np.array_equal(subs.numpy(), nibble_sub_luts(
        JSpec("appro42", 8, True, n_approx_cols=4)).ravel())
    with pytest.raises(ValueError, match="not nibble-decomposable"):
        ops.nibble_table(TSpec("appro42", 8, True), "cpu")


def test_library_digest_covers_headers(tmp_path, monkeypatch):
    """A header edit must rebuild every source that may include it: the
    library path hashes each csrc/*.cuh with the source and the flags."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name) for name in build.SOURCES}
    header = csrc / "cim_gemm.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)
    assert build.library_path("lut_gemm") == after["lut_gemm"]
