"""PyTorch port, CiM attention: the plain versions the CUDA attention
kernels are held to on the card, held here against the JAX package, and
the dispatch and model-layer routing mirrored from tests/test_attn.py.

Contracts (inputs made by numpy from a seed; scales passed explicitly,
which keeps XLA's rewrites of the scale arithmetic out of the
comparison):
  * the integer dots of every path and the score step: bitwise;
  * attention outputs: within one probability quantum times the largest
    |v| (max|v| / 127).  XLA's exp and torch's may differ by an ulp, and
    the probability tile is quantized at the fixed scale 1/127, so an ulp
    on a rounding boundary moves one whole pq level; the online-step
    test counts how many levels move;
  * within the port, the plain fused and materialized forms: bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx_gemm as jag
from repro.core import autotune as jautotune
from repro.core.multipliers import MultiplierSpec as JSpec
from repro.kernels import attn_gemm as J
from repro.kernels.ops import _lut_np, _subs_np
from repro_torch.core import approx_gemm as ag
from repro_torch.core import autotune
from repro_torch.core.approx_gemm import (ATTN_MODES, AttnParams,
                                          GemmParams, _attn_bit_safe,
                                          attn_materialized_oracle,
                                          cim_attention, plan_attn,
                                          plan_misses, select_attn_kernel)
from repro_torch.core.multipliers import MultiplierSpec as TSpec
from repro_torch.kernels import attn_gemm as T
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models.common import CiMParams

B, H, KH, SQ, SKV, D = 2, 4, 2, 21, 29, 12
BLOCK = (8, 16)
# (path, family, compressor, n_approx_cols): each datapath once, the
# balanced tier's multiplier on the lut path, log_our beside mitchell
PATHS = [("lut", "appro42", "orplane", 10), ("log", "mitchell", "yang1", None),
         ("log", "log_our", "yang1", None), ("nibble", "exact", "yang1", None),
         ("mxu", "exact", "yang1", None)]
# (family, mode, reference kernel, port entry on cpu, port entry on cuda)
HW_CASES = [
    ("exact", "exact", "pallas_attn_mxu", "torch_attn_mxu", "cuda_attn_mxu"),
    ("exact", "hardware", "pallas_attn_nibble", "torch_attn_nibble",
     "cuda_attn_nibble"),
    ("appro42", "hardware", "pallas_attn_lut", "torch_attn_lut",
     "cuda_attn_lut"),
    ("mitchell", "hardware", "pallas_attn_log", "torch_attn_log",
     "cuda_attn_log"),
    ("log_our", "hardware", "pallas_attn_log", "torch_attn_log",
     "cuda_attn_log"),
    ("appro42", "bit_exact", "attn_xla", "torch_attn", "torch_attn"),
]


def _ops(b=B, sq=SQ, skv=SKV, h=H, kh=KH, d=D, seed=0):
    """Kernel-layout f32 operands (B, H, S, D)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, kh, skv, d)).astype(np.float32),
            rng.standard_normal((b, kh, skv, d)).astype(np.float32))


def _positions(variant, b=B, sq=SQ, skv=SKV):
    """(qpos, kpos, kval, window) of one masking variant."""
    qpos = np.broadcast_to(np.arange(skv - sq, skv, dtype=np.int32),
                           (b, sq)).copy()
    kpos = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv)).copy()
    kval = np.ones((b, skv), np.int32)
    window = None
    if variant == "window":
        window = 5
    elif variant == "ragged":
        kval = (kpos < np.asarray([[17], [skv]])).astype(np.int32)
    elif variant == "decode":
        kval = (kpos < np.asarray([[23], [skv]])).astype(np.int32)
    return qpos, kpos, kval, window


def _tables(path, fam, comp, nac):
    if path == "lut":
        j = _lut_np(fam, 8, comp, nac)
    elif path == "nibble":
        j = _subs_np(fam, 8, comp, nac)
    else:
        return None, None
    return jnp.asarray(j), ops._attn_table(path, TSpec(fam, 8, True, comp,
                                                       nac), "cpu")


def _scales(q, k, v):
    return [np.array(s) for s in J.attn_scales(jnp.asarray(q),
                                                 jnp.asarray(k),
                                                 jnp.asarray(v), 8)]


def _both(q, k, v, qpos, kpos, kval, sc):
    arrs = (q, k, v, *sc, qpos, kpos, kval)
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs])


# ------------------------------------------------- integer dots, scores ----


@pytest.mark.parametrize("path,fam,comp,nac", PATHS, ids=lambda p: str(p))
def test_int_dot_bitwise_against_reference(path, fam, comp, nac):
    rng = np.random.default_rng(1)
    jt, tt = _tables(path, fam, comp, nac)
    # QK^T-shaped (signed operands) and PV-shaped (pq in [0, qmax])
    for lo, (m, kk, n) in ((-127, (SQ, D, 16)), (0, (SQ, 16, D))):
        a = rng.integers(lo, 128, (B, H, m, kk)).astype(np.int32)
        b = rng.integers(-127, 128, (B, H, kk, n)).astype(np.int32)
        want = np.asarray(J._int_dot(jnp.asarray(a), jnp.asarray(b), jt,
                                     path=path, bits=8,
                                     compensated=fam == "log_our",
                                     k_slice=16))
        got = T._int_dot(torch.from_numpy(a), torch.from_numpy(b), tt,
                         path=path, bits=8, compensated=fam == "log_our")
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("path,fam,comp,nac", PATHS, ids=lambda p: str(p))
def test_score_step_bitwise_against_reference(path, fam, comp, nac):
    q, k, v = _ops(seed=2)
    sc = _scales(q, k, v)
    rng = np.random.default_rng(3)
    mask = rng.random((B, H, SQ, 16)) < 0.8
    jt, tt = _tables(path, fam, comp, nac)
    kq = np.repeat(k, H // KH, axis=1)[:, :, :16]
    sq_b = sc[0][:, :, None, None]
    sk_b = np.repeat(sc[1], H // KH, axis=1)[:, :, None, None]
    kw = dict(path=path, bits=8, compensated=fam == "log_our",
              sm_scale=J._sm_scale(D))
    want = np.asarray(J._score_step(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(sq_b),
        jnp.asarray(sk_b), jnp.asarray(mask), jt, k_slice=16, **kw))
    got = T._score_step(torch.from_numpy(q), torch.from_numpy(kq),
                        torch.from_numpy(sq_b), torch.from_numpy(sk_b),
                        torch.from_numpy(mask), tt, **kw)
    assert np.array_equal(got.numpy(), want)


def test_online_step_moves_few_probability_levels(record_property):
    """Given the same score tile, the online step agrees with the
    reference: the running max bitwise, and the quantized probability
    tile up to the pq levels that an ulp of exp moves (counted)."""
    q, k, v = _ops(seed=4)
    sc = _scales(q, k, v)
    rng = np.random.default_rng(5)
    s = (rng.standard_normal((B, H, SQ, 16)) * 3).astype(np.float32)
    mask = rng.random((B, H, SQ, 16)) < 0.8
    s = np.where(mask, s, np.float32(T.NEG_INF)).astype(np.float32)
    vq = np.repeat(v, H // KH, axis=1)[:, :, :16]
    svb = np.repeat(sc[2], H // KH, axis=1)[:, :, None, None]
    m0 = np.full((B, H, SQ, 1), T.NEG_INF, np.float32)
    l0 = np.zeros((B, H, SQ, 1), np.float32)
    a0 = np.zeros((B, H, SQ, D), np.float32)
    jm, jl, ja = J._online_step(
        *(jnp.asarray(x) for x in (s, mask, vq, svb, m0, l0, a0)), None,
        path="mxu", bits=8, compensated=False, k_slice=16)
    tm, tl, ta = T._online_step(
        *(torch.from_numpy(x) for x in (s, mask, vq, svb, m0, l0, a0)), None,
        path="mxu", bits=8, compensated=False)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    pj = np.where(mask, np.exp(np.asarray(s - np.asarray(jm))), 0)
    pt = torch.where(torch.from_numpy(mask),
                     torch.exp(torch.from_numpy(s) - tm), 0).numpy()
    moved = int((np.round(pj * 127) != np.round(pt * 127)).sum())
    record_property("pq_levels_moved", moved)
    assert moved <= mask.size // 100
    tol = np.abs(v).max() / 127 * 16        # a level moved per kv entry
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=tol)


# ------------------------------------------------ outputs against JAX ----


@pytest.mark.parametrize("variant", ["causal", "window", "ragged", "decode"])
@pytest.mark.parametrize("path,fam,comp,nac", PATHS, ids=lambda p: str(p))
def test_attn_reference_matches_jax(path, fam, comp, nac, variant):
    sq = 1 if variant == "decode" else SQ
    q, k, v = _ops(sq=sq, seed=6)
    qpos, kpos, kval, window = _positions(variant, sq=sq)
    jt, tt = _tables(path, fam, comp, nac)
    jin, tin = _both(q, k, v, qpos, kpos, kval, _scales(q, k, v))
    kw = dict(path=path, bits=8, causal=True, window=window,
              compensated=fam == "log_our", block=BLOCK)
    want = np.asarray(J.attn_reference(*jin, jt, **kw))
    got = T.attn_fused(*tin, tt, **kw)
    tol = np.abs(v).max() / 127
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # the oracle: the same numbers bit for bit
    assert torch.equal(T.attn_materialized(*tin, tt, **kw), got)


@pytest.mark.parametrize("kh", [1, 2, 4])
def test_attn_reference_matches_jax_across_gqa_groups(kh):
    q, k, v = _ops(kh=kh, seed=7)
    qpos, kpos, kval, _ = _positions("causal")
    jt, tt = _tables("lut", "appro42", "orplane", 10)
    jin, tin = _both(q, k, v, qpos, kpos, kval, _scales(q, k, v))
    kw = dict(path="lut", bits=8, block=BLOCK)
    want = np.asarray(J.attn_reference(*jin, jt, **kw))
    got = T.attn_fused(*tin, tt, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=np.abs(v).max() / 127)
    assert torch.equal(T.attn_materialized(*tin, tt, **kw), got)


def test_plain_fused_matches_jax_pallas_kernel():
    """One case against the reference's Pallas kernel in interpret mode."""
    q, k, v = _ops(seed=8)
    qpos, kpos, kval, _ = _positions("ragged")
    jt, tt = _tables("lut", "appro42", "orplane", 10)
    jin, tin = _both(q, k, v, qpos, kpos, kval, _scales(q, k, v))
    kw = dict(path="lut", bits=8, block=BLOCK)
    want = np.asarray(J.attn_fused(*jin, jt, interpret=True, **kw))
    got = T.attn_fused(*tin, tt, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=np.abs(v).max() / 127)


def test_scales_and_float_attention_match_jax():
    q, k, v = _ops(seed=9)
    qpos, kpos, kval, window = _positions("window")
    for a, b in zip(_scales(q, k, v),
                    T.attn_scales(*(torch.from_numpy(x) for x in (q, k, v)),
                                  8)):
        assert np.array_equal(a, b.numpy())
    want = np.asarray(J.attn_float(*(jnp.asarray(x) for x in
                                     (q, k, v, qpos, kpos, kval)),
                                   window=window))
    got = T.attn_float(*(torch.from_numpy(x) for x in
                         (q, k, v, qpos, kpos, kval)), window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_attention_blocks_match_reference():
    assert autotune.DEFAULT_ATTN_BLOCKS == jautotune.DEFAULT_ATTN_BLOCKS
    for kern in autotune.DEFAULT_ATTN_BLOCKS:
        for sq, skv in ((1, 320), (256, 256), (21, 29), (3, 5)):
            assert autotune.heuristic_attn_block(kern, sq, skv) \
                == jautotune.heuristic_attn_block(kern, sq, skv)
    assert autotune.bucket_attn(3, 8, 4, 33, 47, 64) \
        == jautotune.bucket_attn(3, 8, 4, 33, 47, 64)


# ------------------------------------------------------------ routing ----


@pytest.mark.parametrize("family,mode,ref,cpu,cuda", HW_CASES)
def test_attn_routing_mirrors_reference(family, mode, ref, cpu, cuda):
    gp = GemmParams(family=family, bits=8, mode=mode)
    jspec = JSpec(family, 8, True)
    assert jag.select_attn_kernel(family, mode, 8, backend="cpu",
                                  spec=jspec).name == ref
    jplan = jag.plan_attn(family, mode, 8, B, H, KH, SQ, SKV, D,
                          jag.AttnParams(), backend="cpu", spec=jspec)
    for backend, name in (("cpu", cpu), ("cuda", cuda)):
        assert select_attn_kernel(family, mode, 8, backend,
                                  spec=gp.spec).name == name
        plan = plan_attn(family, mode, 8, B, H, KH, SQ, SKV, D,
                         AttnParams(), backend=backend, spec=gp.spec)
        assert plan.entry.name == name
        assert plan.attn == AttnParams()
        assert plan.block[1] == jplan.block[1]     # bk is the numerics
        if mode == "hardware":
            assert plan.entry.cuda == (backend == "cuda")


def test_serving_ladder_routes_attention_like_the_reference():
    """Balanced (appro42/orplane/10, not nibble-decomposable) -> lut;
    economy (mitchell) -> log; every serving geometry fits a block."""
    from repro.serving.tiers import build_tiers as jbuild
    from repro_torch.serving.tiers import build_tiers as tbuild

    jt = {t.name: t.cim for t in jbuild(mode="hardware", attn=True)}
    for t in tbuild(mode="hardware", attn=True):
        c = t.cim
        assert c.attn and jt[t.name].attn
        if t.name == "exact":
            assert c.mode == "exact"          # the float attention path
            continue
        for b, sq, skv in ((4, 1, 320), (4, 256, 256), (1, 256, 256)):
            jp = jag.plan_attn(c.family, c.mode, 8, b, 16, 8, sq, skv, 128,
                               jag.AttnParams(), backend="cpu",
                               spec=JSpec(c.family, 8, True, c.compressor,
                                          c.n_approx_cols))
            tp = plan_attn(c.family, c.mode, 8, b, 16, 8, sq, skv, 128,
                           spec=c.spec)
            assert tp.entry.name == jp.entry.name.replace("pallas", "cuda")
            assert tp.block[1] == jp.block[1]


def test_attn_mode_and_geometry_validation():
    gp = GemmParams(family="appro42", bits=8, mode="hardware")
    q, k, v = (torch.from_numpy(a).transpose(1, 2) for a in _ops(seed=10))
    with pytest.raises(ValueError):
        plan_attn("appro42", "surrogate", 8, B, H, KH, SQ, SKV, D)
    with pytest.raises(ValueError):      # H % KH != 0
        cim_attention(q[:, :, :3], k, v, gp)
    with pytest.raises(ValueError):
        cim_attention(q, k, v, GemmParams(family="appro42", bits=8,
                                          mode="surrogate_fast"))
    with pytest.raises(ValueError, match="backend"):
        plan_attn("appro42", "hardware", 8, B, H, KH, SQ, SKV, D,
                  backend="tpu")
    assert "surrogate" not in ATTN_MODES


def test_attn_predicates_reject_unsafe_geometry():
    assert not _attn_bit_safe(12, "mxu", 128, 128)
    assert _attn_bit_safe(8, "mxu", 128, 128)
    assert _attn_bit_safe(12, "log", 128, 128)
    for args in ((12, "mxu", 128, 128), (8, "mxu", 12, 16),
                 (12, "log", 128, 128), (8, "lut", 300, 512)):
        assert _attn_bit_safe(*args) == jag._attn_bit_safe(*args)
    with pytest.raises(ValueError):
        plan_attn("appro42", "hardware", 16, B, H, KH, SQ, SKV, D)


def test_shared_memory_gate_admits_the_serving_geometry():
    """The Hopper footprint model: every path fits one block at the
    serving head dim and bk; the lut path's 128 KiB table leaves no room
    for a head dim of 256 (its plan falls to the next entry or raises)."""
    for name in ("cuda_attn_lut", "cuda_attn_log", "cuda_attn_nibble",
                 "cuda_attn_mxu"):
        assert ag._attn_kernel_fits(name, 8, (32, 128), 128)
    assert T.attn_smem_bytes("lut", 8, 32, 128, 128) == 210_432
    assert not ag._attn_kernel_fits("cuda_attn_lut", 8, (32, 128), 256)
    with pytest.raises(ValueError, match="shared-memory"):
        plan_attn("appro42", "hardware", 8, 1, 4, 4, 8, 256, 256,
                  spec=TSpec("appro42", 8, True, "orplane", 10))


# --------------------------------------------- frontend and STE VJP ----


def _model_ops(seed, kh=KH, sq=SQ):
    q, k, v = _ops(kh=kh, sq=sq, seed=seed)
    return tuple(torch.from_numpy(a).transpose(1, 2).contiguous()
                 for a in (q, k, v))


@pytest.mark.parametrize("family,mode", [("appro42", "hardware"),
                                         ("mitchell", "hardware"),
                                         ("exact", "exact"),
                                         ("appro42", "bit_exact")])
def test_cim_attention_bitwise_equals_materialized_oracle(family, mode):
    gp = GemmParams(family=family, bits=8, mode=mode)
    q, k, v = _model_ops(11)
    qpos, kpos, kval, _ = (torch.from_numpy(a) if a is not None else a
                           for a in _positions("ragged"))
    got = cim_attention(q, k, v, gp, q_positions=qpos, kv_positions=kpos,
                        kv_valid=kval, block=BLOCK)
    plan = plan_attn(family, mode, 8, B, H, KH, SQ, SKV, D, backend="cpu",
                     block=BLOCK, spec=gp.spec)
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    want = t(attn_materialized_oracle(t(q), t(k), t(v), gp, plan, qpos,
                                      kpos, kval))
    assert got.shape == q.shape and torch.equal(got, want)


def test_cim_attention_plan_misses_flat_on_repeated_shapes():
    gp = GemmParams(family="mitchell", bits=8, mode="hardware")
    q, k, v = _model_ops(12)
    cim_attention(q, k, v, gp)
    n0 = plan_misses()
    cim_attention(q, k, v, gp)
    cim_attention(q[:, :19], k[:, :27], v[:, :27], gp)   # same buckets
    assert plan_misses() == n0
    cim_attention(q[:, :5], k[:, :5], v[:, :5], gp)      # a new bucket
    assert plan_misses() == n0 + 1


def test_attn_ste_backward_is_exact_float_vjp():
    gp = GemmParams(family="appro42", bits=8, mode="hardware")
    q, k, v = _model_ops(13)
    qpos, kpos, kval, _ = (torch.from_numpy(a) if a is not None else a
                           for a in _positions("causal"))
    qs, ks, vs = (a.clone().requires_grad_(True) for a in (q, k, v))
    out = cim_attention(qs, ks, vs, gp, q_positions=qpos,
                        kv_positions=kpos, kv_valid=kval, block=BLOCK)
    g = torch.autograd.grad(out.sum(), (qs, ks, vs))
    qf, kf, vf = (a.clone().requires_grad_(True) for a in (q, k, v))
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    ref = t(T.attn_float(t(qf), t(kf), t(vf), qpos, kpos, kval))
    gf = torch.autograd.grad(ref.sum(), (qf, kf, vf))
    for a, b in zip(g, gf):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------- model-layer routing ----


def test_use_cim_attn_gates():
    hw = CiMParams(mode="hardware", family="appro42", attn=True)
    assert tattn._use_cim_attn(hw, is_cross=False)
    assert not tattn._use_cim_attn(hw, is_cross=True)
    assert not tattn._use_cim_attn(
        CiMParams(mode="hardware", family="appro42"), False)
    assert not tattn._use_cim_attn(
        CiMParams(mode="surrogate_fast", family="appro42", attn=True), False)
    assert not tattn._use_cim_attn(
        CiMParams(mode="exact", family="exact", attn=True), False)


def test_cim_sdpa_falls_back_on_unsupported_geometry():
    """16-bit operands: no attention entry takes them, so the helper
    returns None (the float path) and the fallback is counted."""
    p = CiMParams(mode="hardware", family="appro42", bits=16, attn=True)
    q, k, v = _model_ops(14)
    qpos, kpos, kval, _ = (torch.from_numpy(a) if a is not None else a
                           for a in _positions("causal"))
    n0 = tattn.cim_attn_fallbacks()
    assert tattn._cim_sdpa(q, k, v, p, causal=True, window=None, qpos=qpos,
                           kpos=kpos, kval=kval) is None
    assert tattn.cim_attn_fallbacks() == n0 + 1


def test_cim_sdpa_per_head_tiers_match_per_family_runs():
    heads = ("exact", "appro42", "appro42", "mitchell")
    p = CiMParams(mode="hardware", family="appro42", attn=True,
                  attn_heads=heads)
    q, k, v = _model_ops(15)
    qpos, kpos, kval, _ = (torch.from_numpy(a) if a is not None else a
                           for a in _positions("causal"))
    out = tattn._cim_sdpa(q, k, v, p, causal=True, window=None, qpos=qpos,
                          kpos=kpos, kval=kval)
    assert out is not None and out.shape == q.shape
    g = H // KH
    ke, ve = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    for i, fam in enumerate(heads):
        gp = GemmParams(family=fam, bits=8, mode="hardware")
        want = cim_attention(q[:, :, i:i + 1], ke[:, :, i:i + 1],
                             ve[:, :, i:i + 1], gp, q_positions=qpos,
                             kv_positions=kpos, kv_valid=kval)
        assert torch.equal(out[:, :, i:i + 1], want), f"head {i} ({fam})"


def test_cim_sdpa_rejects_wrong_head_count():
    p = CiMParams(mode="hardware", family="appro42", attn=True,
                  attn_heads=("exact",))
    q, k, v = _model_ops(16)
    qpos, kpos, kval, _ = (torch.from_numpy(a) if a is not None else a
                           for a in _positions("causal"))
    with pytest.raises(ValueError):
        tattn._cim_sdpa(q, k, v, p, causal=True, window=None, qpos=qpos,
                        kpos=kpos, kval=kval)


def test_wrappers_refuse_other_devices():
    q, k, v = (torch.zeros((1, 2, 4, 8), device="meta") for _ in range(3))
    s = torch.zeros((1, 2), device="meta")
    pos = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        T.attn_fused(q, k, v, s, s, s, pos, pos, pos, path="log")
    with pytest.raises(ValueError, match="datapath"):
        T.attn_fused(q, k, v, s, s, s, pos, pos, pos, path="warp")
