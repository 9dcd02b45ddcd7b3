"""PyTorch port, fault injection (core/faults.py and the faulted routes of
the dispatch engine) against the JAX package: the defect masks, faulted
tables and faulted weight words byte-equal to the reference's, the
magnitude-table LUT kernel's plain version equal to the signed-table
gather, faulted GEMMs and convs bitwise the reference's, the routing of a
faulted GEMM away from the nibble kernels, and the refusals (attention,
the mesh path, the surrogate modes)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx_gemm as jag
from repro.core import faults as jfaults
from repro.core.luts import signed_product_lut as j_signed_lut
from repro.core.multipliers import MultiplierSpec as JSpec
from repro_torch.core import approx_gemm as ag
from repro_torch.core import faults
from repro_torch.core.approx_gemm import (GemmParams, cim_conv2d,
                                          cim_matmul, model_matmul,
                                          plan_misses)
from repro_torch.core.compiler import CiMConfig, compile_macro
from repro_torch.core.faults import FAULT_MODES, FaultConfig
from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.kernels import approx_matmul as am
from repro_torch.kernels import ops, ref

F = FaultConfig(p_sa0=0.02, p_sa1=0.02, seed=3)
SPEC_KEY = ("appro42", 8, "orplane", 10)
# (family, compressor, n_approx_cols): the ladder's balanced multiplier,
# the log families, and the exact family
GEMM_FAMS = [("appro42", "orplane", 10), ("mitchell", "yang1", None),
             ("log_our", "yang1", None), ("exact", "yang1", None)]


def _jf(f: FaultConfig) -> jfaults.FaultConfig:
    return jfaults.FaultConfig(p_sa0=f.p_sa0, p_sa1=f.p_sa1, seed=f.seed)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's small torch ops, restored
    after it (beside the other test workers torch's default pool waits
    for cores they hold)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------------ config ----


@pytest.mark.parametrize("kw", [{"p_sa0": -0.1}, {"p_sa1": 1.5},
                                {"p_sa0": 0.6, "p_sa1": 0.5}])
def test_config_validation(kw):
    with pytest.raises(ValueError):
        FaultConfig(**kw)


def test_config_rate_hash_and_from_yield():
    f = FaultConfig(p_sa0=0.01, p_sa1=0.03, seed=7)
    assert f.rate == pytest.approx(0.04)
    assert hash(f) == hash(FaultConfig(p_sa0=0.01, p_sa1=0.03, seed=7))
    assert f != dataclasses.replace(f, seed=8)
    # the characterized rate of the Table V geometry: the reference's
    got = FaultConfig.from_yield(rows=32, seed=4, sa1_frac=0.25, scale=2.0)
    want = jfaults.FaultConfig.from_yield(rows=32, seed=4, sa1_frac=0.25,
                                          scale=2.0)
    assert (got.p_sa0, got.p_sa1, got.seed) == (want.p_sa0, want.p_sa1,
                                                want.seed)
    assert FaultConfig.from_yield(rows=32, scale=1e6).rate == 1.0


def test_fault_needs_an_integer_mode():
    for mode in ("surrogate", "surrogate_fast"):
        with pytest.raises(ValueError, match="integer storage"):
            GemmParams(family="appro42", mode=mode, fault=F)
        with pytest.raises(ValueError, match="integer storage"):
            CiMConfig(family="appro42", mode=mode, fault=F)
    for mode in FAULT_MODES:
        assert GemmParams(family="appro42", mode=mode, fault=F).fault == F
    cfg = CiMConfig(family="appro42", mode="hardware", fault=F)
    assert compile_macro(cfg).gemm_params().fault == F


# ------------------------------------------------------------- masks ----


@pytest.mark.parametrize("seed,tag,nbits,shape", [
    (3, "w", 8, (64, 32)), (0, "w", 4, (7, 5)), (9, "lut", 16, (16, 16)),
    (2**40 + 5, "subs1", 8, (3, 4, 5)), (1, "w", 1, (33,))])
def test_masks_byte_equal_the_reference(seed, tag, nbits, shape):
    f = FaultConfig(p_sa0=0.05, p_sa1=0.03, seed=seed)
    got = faults.stuck_at_masks(f, shape, nbits, tag)
    want = jfaults.stuck_at_masks(_jf(f), shape, nbits, tag)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    assert not (got[0] & got[1]).any()          # never stuck both ways


def test_masks_drawn_in_row_chunks_equal_the_one_shot_draw(monkeypatch):
    """PCG64's doubles are one draw each, in order: masks drawn in row
    chunks (boundaries inside the array) are the reference's one-shot
    masks, and so are the device masks built from them."""
    monkeypatch.setattr(faults, "_CHUNK_DRAWS", 7 * 40 * 8)   # 7 rows
    faults.clear_fault_caches()
    shape = (30, 40)
    got = faults.stuck_at_masks(F, shape, 8, "w")
    want = jfaults.stuck_at_masks(_jf(F), shape, 8, "w")
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    keep, m1 = faults.weight_masks(F, shape, 8, "cpu")
    assert keep.dtype == torch.uint8 and m1.dtype == torch.uint8
    assert np.array_equal(keep.numpy(), ~want[0] & 0xFF)
    assert np.array_equal(m1.numpy(), want[1])
    faults.clear_fault_caches()


def test_fault_unsigned_words_equal_the_reference():
    words = np.random.default_rng(0).integers(0, 256, (32, 32))
    got = faults.fault_unsigned_words(words, F, 8, "lut")
    assert np.array_equal(got, jfaults.fault_unsigned_words(words, _jf(F),
                                                            8, "lut"))
    assert got.min() >= 0 and got.max() < 256
    assert (faults.fault_unsigned_words(words, FaultConfig(p_sa1=1.0), 8,
                                        "lut") == 255).all()


@pytest.mark.parametrize("bits", [4, 8])
def test_weight_faults_equal_the_reference(bits):
    qmax = (1 << (bits - 1)) - 1
    wq = np.random.default_rng(bits).integers(-qmax, qmax + 1, (48, 16)
                                              ).astype(np.int8)
    got = faults.apply_weight_faults(torch.from_numpy(wq), F, bits)
    want = np.asarray(jfaults.apply_weight_faults(jnp.asarray(wq), _jf(F),
                                                  bits))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    assert (got.numpy() != wq).any() and np.abs(got.numpy()).max() <= qmax
    clean = faults.apply_weight_faults(torch.from_numpy(wq), FaultConfig(),
                                       bits)
    assert np.array_equal(clean.numpy(), wq)
    # one mask per (fault, shape, bits, tag) on a device, drawn once
    assert faults.weight_masks(F, (48, 16), bits, "cpu")[0] is \
        faults.weight_masks(F, (48, 16), bits, "cpu")[0]


# ----------------------------------------------------- stored tables ----


@pytest.mark.parametrize("key", [SPEC_KEY, ("exact", 8, "yang1", None),
                                 ("appro42", 4, "yang1", None)])
def test_faulted_tables_byte_equal_the_reference(key):
    for f in (F, FaultConfig.from_yield(rows=32)):
        got = faults.faulted_signed_lut_flat(key, f)
        want = jfaults.faulted_signed_lut_flat(key, _jf(f))
        assert got.dtype == want.dtype and np.array_equal(got, want)
        subs = faults.faulted_nibble_subs_flat(key, f)
        jsubs = jfaults.faulted_nibble_subs_flat(key, _jf(f))
        assert (subs is None) == (jsubs is None)
        if subs is not None:
            assert np.array_equal(subs, jsubs)
    # the Table V rate: the faulted 8-bit table leaves int16
    tab = faults.faulted_signed_lut_flat(SPEC_KEY,
                                         FaultConfig.from_yield(rows=32))
    assert np.abs(tab).max() > np.iinfo(np.int16).max


@pytest.mark.parametrize("bits", range(2, 9))
def test_magnitude_table_builds_the_signed_table(bits):
    """The kernel's form of a table (uint16 magnitudes, padded to 16
    bytes) rebuilds the reference's faulted and clean signed tables, and
    its plain GEMM is the signed-table gather, on operands at the edges."""
    key = ("appro42", bits, "yang1", None)
    spec = MultiplierSpec("appro42", bits, True, "yang1", None)
    half = 1 << (bits - 1)
    rng = np.random.default_rng(bits)
    xq = torch.from_numpy(rng.integers(-half, half, (9, 21)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-half, half, (21, 6)).astype(np.int8))
    xq[0, :2] = -half
    for f, want in ((F, jfaults.faulted_signed_lut_flat(key, _jf(F))),
                    (None, j_signed_lut(JSpec("appro42", bits, True,
                                              "yang1")).ravel())):
        mag = ops.magnitude_lut(spec, f, "cpu")
        assert mag.dtype == torch.uint16
        assert mag.numel() == am.mag_entries(bits) and mag.numel() * 2 >= 16
        table = am.signed_from_magnitude(mag, bits)
        assert np.array_equal(table.numpy(), want)
        assert torch.equal(am.lut_matmul_mag(xq, wq, mag, bits),
                           ref.lut_matmul_ref(xq, wq,
                                              torch.from_numpy(want), bits))
    if bits < 8:                       # an int8 operand past the table
        with pytest.raises(ValueError):
            am.lut_matmul_mag(xq + half, wq, mag, bits)


# ---------------------------------------------------------- dispatch ----


def _pinned(rng, shape, axis):
    """Normal values whose max |v| over `axis` (None: all) is 127 * 2^e,
    so each quantization scale is a power of two and the reference's
    jitted x / (m / qmax) rewrite moves no code."""
    v = rng.standard_normal(shape).astype(np.float32)
    m = np.abs(v).max(axis=axis, keepdims=axis is not None)
    e = rng.integers(-6, -2, size=np.shape(m))
    return (v / m * (127.0 * 2.0 ** e)).astype(np.float32)


def _gps(family, comp, nac, mode, fault=F):
    kw = dict(family=family, bits=8, mode=mode, compressor=comp,
              n_approx_cols=nac)
    return (GemmParams(**kw, fault=fault),
            jag.GemmParams(**kw, fault=_jf(fault)))


@pytest.mark.parametrize("mode", ["hardware", "bit_exact"])
@pytest.mark.parametrize("family,comp,nac", GEMM_FAMS)
def test_faulted_gemms_bitwise_the_reference(family, comp, nac, mode):
    rng = np.random.default_rng(5)
    x, w = _pinned(rng, (12, 64), None), _pinned(rng, (64, 24), 0)
    gp, jgp = _gps(family, comp, nac, mode)
    with torch.no_grad():
        got = cim_matmul(torch.from_numpy(x), torch.from_numpy(w), gp)
        clean = cim_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           dataclasses.replace(gp, fault=None))
    want = np.asarray(jag.cim_matmul(jnp.asarray(x), jnp.asarray(w), jgp))
    assert np.array_equal(got.numpy(), want)
    assert not torch.equal(got, clean)
    xb, wb = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(
        torch.bfloat16)
    with torch.no_grad():
        got = model_matmul(xb, wb, gp)
    want = jag.model_matmul(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(w, jnp.bfloat16), jgp)
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("frontend", ["cim", "model"])
def test_faulted_exact_mode_matches_the_reference(frontend):
    """The exact macro with faulted words (the model frontend: true
    quantization, the faulted words dequantized under the STE) within an
    f32 / bf16 rounding of the reference; the fault moves the result."""
    rng = np.random.default_rng(6)
    x, w = _pinned(rng, (12, 64), None), _pinned(rng, (64, 24), 0)
    gp, jgp = _gps("exact", "yang1", None, "exact")
    if frontend == "cim":
        xt, wt, xj, wj = (torch.from_numpy(x), torch.from_numpy(w),
                          jnp.asarray(x), jnp.asarray(w))
        tol, run, jrun = 1e-5, cim_matmul, jag.cim_matmul
    else:
        xt, wt = (torch.from_numpy(x).to(torch.bfloat16),
                  torch.from_numpy(w).to(torch.bfloat16))
        xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
        tol, run, jrun = 2e-2, model_matmul, jag.model_matmul
    with torch.no_grad():
        got = run(xt, wt, gp).float().numpy()
        clean = run(xt, wt, dataclasses.replace(gp, fault=None)).float()
    want = np.asarray(jrun(xj, wj, jgp).astype(jnp.float32))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale
    assert np.abs(got - clean.numpy()).max() > 10 * tol * scale
    # gradients as without the fault: the macro's STE is the float
    # product's, the model frontend's weight gradient goes straight
    # through the faulted read path (as through fake_quant)
    if frontend == "cim":
        xg = torch.from_numpy(x).requires_grad_(True)
        run(xg, torch.from_numpy(w), gp).sum().backward()
        assert torch.allclose(xg.grad,
                              torch.from_numpy(w).sum(1).expand(12, -1))
    else:
        wg = torch.from_numpy(w).requires_grad_(True)
        run(torch.from_numpy(x), wg, gp).sum().backward()
        xq = ag.fake_quant(torch.from_numpy(x), 8)
        assert torch.allclose(wg.grad, xq.sum(0)[:, None].expand(-1, 24))


def test_faulted_nibble_spec_routes_to_the_full_lut():
    """A faulted balanced/4 (nibble-decomposable) GEMM plans the full-LUT
    gather on both devices, never a nibble kernel (which holds clean
    sub-tables), and its plans are apart from the clean ones."""
    gp = GemmParams(family="appro42", bits=8, mode="hardware",
                    compressor="orplane", n_approx_cols=4)
    gpf = dataclasses.replace(gp, fault=F)
    assert gpf.routing_spec is None and gp.routing_spec == gp.spec
    for backend in ("cpu", "cuda"):
        pre = "cuda" if backend == "cuda" else "torch"
        assert ag.plan_gemm("appro42", "hardware", 8, 4, 64, 8, backend,
                            spec=gp.routing_spec).entry.name == \
            f"{pre}_lut_nibble"
        assert ag.plan_gemm("appro42", "hardware", 8, 4, 64, 8, backend,
                            spec=gpf.routing_spec).entry.name == \
            f"{pre}_lut_gather"
    xq = torch.zeros((2, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="full-LUT"):
        ag._run_nibble(xq, xq.T.contiguous(), gpf)
    rng = np.random.default_rng(8)
    x, w = (torch.from_numpy(_pinned(rng, (4, 64), None)),
            torch.from_numpy(_pinned(rng, (64, 8), 0)))
    with torch.no_grad():
        y, yf = cim_matmul(x, w, gp), cim_matmul(x, w, gpf)
        n0 = plan_misses()
        for _ in range(2):
            assert torch.equal(cim_matmul(x, w, gp), y)
            assert torch.equal(cim_matmul(x, w, gpf), yf)
    assert plan_misses() == n0 and not torch.equal(y, yf)


@pytest.mark.parametrize("family,comp,nac", GEMM_FAMS)
def test_faulted_conv_bitwise_the_reference(family, comp, nac):
    """A faulted cim_conv2d runs conv_im2col and the faulted int route,
    bitwise the reference's (which pins faulted convs there too)."""
    rng = np.random.default_rng(9)
    x = _pinned(rng, (2, 6, 6, 4), None)
    w = _pinned(rng, (36, 5), 0)
    gp, jgp = _gps(family, comp, nac, "hardware")
    with torch.no_grad():
        got = cim_conv2d(torch.from_numpy(x), torch.from_numpy(w), gp)
        clean = cim_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                           dataclasses.replace(gp, fault=None))
    want = np.asarray(jag.cim_conv2d(jnp.asarray(x), jnp.asarray(w), jgp))
    assert np.array_equal(got.numpy(), want)
    assert not torch.equal(got, clean)
    assert ag._fault_conv_plan(ag.ConvParams(), "cuda").entry.name == \
        "conv_im2col"


# ---------------------------------------------------------- refusals ----


def test_faulted_attention_and_mesh_and_surrogate_refuse():
    from repro_torch.core.approx_gemm import cim_attention
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.common import CiMContext, CiMParams, cim_linear

    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(NotImplementedError, match="faulted CiM attention"):
        cim_attention(q, q, q, GemmParams(family="appro42", mode="hardware",
                                          fault=F))
    # a faulted lane with attn=True refuses at its first attention, never
    # running the clean table (the models layer turns only ValueError
    # into the float path)
    from repro_torch.models.attention import _cim_sdpa
    p = CiMParams.from_config(CiMConfig(family="appro42", mode="hardware",
                                        attn=True, fault=F))
    assert p.gemm_params().fault == F
    pos = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        _cim_sdpa(q, q, q, p, causal=True, window=None, qpos=pos, kpos=pos,
                  kval=pos + 1)
    gp = GemmParams(family="appro42", mode="hardware", fault=F)
    x, w = torch.zeros((4, 8)), torch.zeros((8, 4))
    # the mesh frontends refuse before they touch the mesh
    with pytest.raises(ValueError, match="mesh"):
        cim_matmul(x, w, gp, mesh=object(), x_spec=(None, None),
                   w_spec=(None, "model"))
    with pytest.raises(ValueError, match="mesh"):
        cim_conv2d(torch.zeros((2, 4, 4, 2)), torch.zeros((18, 4)), gp,
                   mesh=object(), x_spec=(None, None, None, None),
                   w_spec=(None, "model"))
    # cim_linear under an ambient mesh, in every mode (the float shard
    # path would fake-quant past the defect map)
    ctx = CiMContext(CiMParams.from_config(CiMConfig(
        family="exact", mode="exact", fault=F)))
    tok = tmesh._AMBIENT.set(object())
    try:
        with pytest.raises(ValueError, match="mesh"):
            cim_linear(x, w, ctx, "wq")
    finally:
        tmesh._AMBIENT.reset(tok)
    assert cim_linear(x, w, ctx, "wq").shape == (4, 4)
    with pytest.raises(ValueError, match="integer storage"):
        GemmParams(family="appro42", mode="surrogate", fault=F)
