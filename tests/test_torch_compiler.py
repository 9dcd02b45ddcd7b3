"""PyTorch port, compiler semantics: product tables, characterization,
the tier ladder and quantization held against the JAX package.

Tables and metrics are framework-free artefacts and must be byte-equal;
quantization must be bitwise equal for f32 and bf16 inputs."""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import dse as jdse
from repro.core import error_model as jerr
from repro.core import luts as jluts
from repro.core import quantization as jq
from repro.serving.tiers import build_tiers as jbuild_tiers
from repro_torch.core import dse as tdse
from repro_torch.core import error_model as terr
from repro_torch.core import luts as tluts
from repro_torch.core import quantization as tq
from repro_torch.core.compiler import CiMConfig, compile_macro
from repro_torch.core.multipliers import MultiplierSpec as TSpec
from repro_torch.kernels import ops
from repro_torch.serving.tiers import build_tiers as tbuild_tiers

SPECS = jdse.design_space(bits=8)


def _tspec(spec):
    return TSpec(*dataclasses.astuple(spec))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.short_name())
def test_tables_byte_equal(spec):
    ts = _tspec(spec)
    a, b = jluts.signed_product_lut(spec), tluts.signed_product_lut(ts)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    a, b = jluts.nibble_sub_luts(spec), tluts.nibble_sub_luts(ts)
    assert (a is None) == (b is None)
    if a is not None:
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_design_space_is_the_same_grid():
    assert [dataclasses.astuple(s) for s in SPECS] == \
        [dataclasses.astuple(s) for s in tdse.design_space(bits=8)]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.short_name())
def test_characterize_metrics_equal(spec):
    a = jerr.characterize(spec, cache=False)
    b = terr.characterize(_tspec(spec), cache=False)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_every_8bit_table_fits_int16():
    """The CUDA LUT kernel keeps the table as int16 in shared memory;
    every 8-bit design point must fit (the largest magnitude is 16,192)."""
    worst = 0
    for spec in tdse.design_space(bits=8):
        t = ops._lut16_np(spec.family, spec.bits, spec.compressor,
                          spec.n_approx_cols)
        full = tluts.signed_product_lut(dataclasses.replace(spec,
                                                            signed=True))
        assert np.array_equal(t.astype(np.int32), full.ravel())
        worst = max(worst, int(np.abs(full).max()))
    assert worst == 16192


def test_table_that_does_not_fit_int16_raises():
    ops._lut16_np.cache_clear()
    with pytest.raises(ValueError, match="int16"):
        ops._lut16_np("exact", 9, "yang1", None)


def test_zero_annihilation_assertion_kept():
    bad = np.zeros((16, 16), np.int64)
    bad[8, 3] = 7
    with pytest.raises(AssertionError, match="annihilate"):
        tluts.assert_zero_annihilation(bad, 8, "bad4b")


def test_hardware_ladder_equals_reference():
    a = jbuild_tiers(mode="hardware")
    b = tbuild_tiers(mode="hardware")
    assert [t.name for t in a] == [t.name for t in b] \
        == ["exact", "balanced", "economy"]
    for ja, tb in zip(a, b):
        assert dataclasses.astuple(ja.cim.spec) == \
            dataclasses.astuple(tb.cim.spec)
        assert ja.cim.mode == tb.cim.mode
        assert ja.nmed == tb.nmed
        assert ja.energy_per_mac_j == tb.energy_per_mac_j
    # the ladder this slice serves: exact runs mode="exact", balanced the
    # full-LUT gather (appro42/orplane/10 is not nibble-decomposable)
    bal = b[1].cim
    assert (bal.family, bal.compressor, bal.n_approx_cols) == \
        ("appro42", "orplane", 10)
    assert not tluts.nibble_decomposable(bal.spec)
    assert b[0].cim.mode == "exact" and b[2].cim.family == "mitchell"


def _inputs(dtype, shape=(7, 33), seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0, 0] = 0.5 * np.abs(x).max()         # exercise ties of round-half
    if dtype == "bfloat16":
        xn = x.astype(ml_dtypes.bfloat16)
        return jnp.asarray(xn), torch.from_numpy(
            xn.view(np.uint16)).view(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [None, 0])
def test_quantization_bitwise(dtype, axis):
    jx, tx = _inputs(dtype)
    js = jq.quant_scale(jx, 8, axis=axis)
    ts = tq.quant_scale(tx, 8, axis=axis)
    assert np.array_equal(_np(js), _np(ts))
    assert np.array_equal(_np(jq.quantize(jx, js, 8)),
                          _np(tq.quantize(tx, ts, 8)))
    # an f32 scale on a bf16 tensor computes in f32, as the reference
    js32 = js.astype(jnp.float32)
    ts32 = ts.to(torch.float32)
    assert np.array_equal(_np(jq.quantize(jx, js32, 8)),
                          _np(tq.quantize(tx, ts32, 8)))
    assert np.array_equal(_np(jq.dequantize(jq.quantize(jx, js, 8), js)),
                          _np(tq.dequantize(tq.quantize(tx, ts, 8), ts)))
    assert np.array_equal(_np(jq.fake_quant(jx, 8, axis=axis)),
                          _np(tq.fake_quant(tx, 8, axis=axis)))


def test_fake_quant_straight_through_gradient():
    x = torch.randn(5, 9, dtype=torch.float32, requires_grad=True)
    tq.fake_quant(x, 8).sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


@pytest.mark.parametrize("field,value", [("alloc", (("mlp", "exact", "yang1",
                                                     None),)),
                                         ("per_token", True),
                                         ("attn", True)])
def test_later_slice_fields_raise(field, value):
    """Fields of later slices were refused as values; every one is ported
    now and accepted.  `attn` (CiM attention) is validated as the
    reference validates it; so is `per_token` (speculative decoding's
    verifier), which the macro does not pass on, as the reference's does
    not; and `alloc` (per-module allocation), normalized to a tuple of
    4-tuples and compiled to per-module GemmParams."""
    if field == "alloc":
        table = [list(e) for e in value]
        cfg = CiMConfig(family="appro42", mode="hardware", alloc=table)
        assert cfg.alloc == value
        assert compile_macro(cfg).gemm_params().family == "appro42"
        return
    if field == "per_token":
        cfg = CiMConfig(family="appro42", mode="hardware", per_token=True)
        assert cfg.per_token
        assert not compile_macro(cfg).gemm_params().per_token
        return
    if field == "attn":
        assert CiMConfig(family="appro42", mode="hardware", attn=True).attn
        heads = ("exact", "appro42")
        assert CiMConfig(mode="hardware", attn=True,
                         attn_heads=heads).attn_heads == heads
        with pytest.raises(ValueError, match="requires attn=True"):
            CiMConfig(mode="hardware", attn_heads=heads)
        with pytest.raises(ValueError, match="not in"):
            CiMConfig(mode="hardware", attn=True, attn_heads=("warp",))
        return
    raise AssertionError(f"no case for {field}")


def test_macro_matmul_runs_cim_matmul_for_its_mode():
    """CiMMacro.matmul is cim_matmul on the macro's params (its mode, or
    the one asked for), and warmup counts its shapes."""
    from repro_torch.core.approx_gemm import NoiseKey, cim_matmul

    macro = compile_macro(CiMConfig(family="appro42", bits=8,
                                    mode="surrogate"))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 20, generator=g)
    w = torch.randn(20, 12, generator=g)
    for mode in (None, "exact", "hardware", "surrogate_fast"):
        assert torch.equal(macro.matmul(x, w, mode=mode),
                           cim_matmul(x, w, macro.gemm_params(mode)))
    assert torch.equal(macro.matmul(x, w, NoiseKey(1)),
                       cim_matmul(x, w, macro.gemm_params(), NoiseKey(1)))
    assert macro.warmup([(6, 20, 12), (3, 20, 12)], device="cpu") == 2
