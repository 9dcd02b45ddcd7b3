"""PyTorch port on the card: the CUDA kernels against their plain
versions, the wrappers' contract, and the serving path through the
kernels.  Each test decides inside its body whether a card is present
and skips without one; run them with `python -m pytest -m gpu tests/`."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.approx_gemm import GemmParams, model_matmul
from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.kernels import approx_matmul, mitchell_gemm, ops, ref

pytestmark = pytest.mark.gpu

SHAPES = [(4, 2048, 1024), (64, 2048, 2048), (33, 70, 17)]
BALANCED = MultiplierSpec("appro42", 8, True, "orplane", 10)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ops(m, k, n, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    xq = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-128, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    return x, w, xq, wq


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernels_bitwise_equal_plain_versions(shape):
    dev = _card()
    x, w, xq, wq = _ops(*shape, dev)
    lut = ops.lut_table(BALANCED, dev)
    sx, sw = ops._scales(x, w, 8)
    pairs = [
        (approx_matmul.lut_matmul(xq, wq, lut),
         ref.lut_matmul_ref(xq, wq, lut)),
        (approx_matmul.lut_matmul_fused(x, w, lut, sx, sw),
         approx_matmul.lut_matmul_fused_plain(x, w, lut, sx, sw))]
    for comp in (False, True):
        pairs += [
            (mitchell_gemm.mitchell_matmul(xq, wq, compensated=comp),
             ref.mitchell_matmul_ref(xq, wq, compensated=comp)),
            (mitchell_gemm.mitchell_matmul_fused(x, w, sx, sw,
                                                 compensated=comp),
             mitchell_gemm.mitchell_matmul_fused_plain(x, w, sx, sw,
                                                       compensated=comp))]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert torch.equal(got, want)


# the magnitude-table form of lut_matmul (the faulted table's): the LM
# shapes, ragged M, K and N (one element, odd tiles), faulted at the
# Table V rate and clean
MAG_SHAPES = [(4, 2048, 1024), (64, 6144, 2048), (33, 70, 17), (1, 1, 1),
              (17, 33, 65)]


@pytest.mark.parametrize("faulted", [True, False])
@pytest.mark.parametrize("shape", MAG_SHAPES, ids=str)
def test_magnitude_table_kernel_bitwise_plain(shape, faulted):
    from repro_torch.core.faults import FaultConfig

    dev = _card()
    _, _, xq, wq = _ops(*shape, dev, seed=sum(shape))
    mag = ops.magnitude_lut(
        BALANCED, FaultConfig.from_yield(rows=32) if faulted else None, dev)
    got = approx_matmul.lut_matmul_mag(xq, wq, mag)
    torch.cuda.synchronize()
    assert torch.equal(got, approx_matmul.lut_matmul_mag_plain(xq, wq, mag))
    if not faulted:
        assert torch.equal(got, approx_matmul.lut_matmul(
            xq, wq, ops.lut_table(BALANCED, dev)))


@pytest.mark.parametrize("bits", range(2, 9))
def test_magnitude_table_kernel_at_every_width(bits):
    """Operands at [-2^{b-1}, 2^{b-1}) (the saturating minimum included)
    through the faulted and the clean table of the exact family and
    appro42; the wrapper refuses a table of another form and operands
    outside the table."""
    from repro_torch.core.faults import FaultConfig

    dev = _card()
    half = 1 << (bits - 1)
    g = torch.Generator(device=dev).manual_seed(bits)
    xq = torch.randint(-half, half, (33, 70), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    wq = torch.randint(-half, half, (70, 17), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    xq[0, :3] = -half
    for fam in ("exact", "appro42"):
        spec = MultiplierSpec(fam, bits, True)
        for f in (FaultConfig(p_sa0=0.05, p_sa1=0.05, seed=bits), None):
            mag = ops.magnitude_lut(spec, f, dev)
            got = approx_matmul.lut_matmul_mag(xq, wq, mag, bits)
            assert torch.equal(got, approx_matmul.lut_matmul_mag_plain(
                xq, wq, mag, bits))
        assert torch.equal(got, approx_matmul.lut_matmul(
            xq, wq, ops.lut_table(spec, dev), bits))
    with pytest.raises(ValueError, match="magnitude table"):
        approx_matmul.lut_matmul_mag(xq, wq, mag.view(torch.int16), bits)
    with pytest.raises(ValueError, match="magnitude table"):
        approx_matmul.lut_matmul_mag(xq, wq, mag[:-1].clone(), bits)
    if bits < 8:
        with pytest.raises(ValueError):
            approx_matmul.lut_matmul_mag(xq + half, wq, mag, bits)


# the int forms on the split-K cluster kernel at its edges: one row tile
# of 4, 16 or 64 rows or several, K one step, ragged or split over a
# cluster, N ragged (rows not 16-byte multiples: the element loads), and
# one shape with both operands one byte off 16-byte alignment
INT_EDGES = [(1, 31, 7), (4, 1, 1), (17, 33, 17), (65, 6144, 17),
             (130, 33, 2048), (2048, 31, 1), (1, 2048, 2048)]


@pytest.mark.parametrize("shape", INT_EDGES, ids=str)
def test_int_forms_on_the_cluster_kernel_at_its_edges(shape):
    """lut_matmul, lut_matmul_mag (faulted) and mitchell_matmul (both
    compensations) bitwise their plain versions, -128 in x's first
    column, each one launch of its cluster entry."""
    from repro_torch.core.faults import FaultConfig

    dev = _card()
    m, k, n = shape
    _, _, xq, wq = _ops(m, k, n, dev, seed=m + k + n)
    xq[:, :1] = -128
    if shape == (1, 2048, 2048):
        bx = torch.empty(xq.numel() + 1, dtype=torch.int8, device=dev)
        bw = torch.empty(wq.numel() + 1, dtype=torch.int8, device=dev)
        xq = bx[1:].view(m, k).copy_(xq)
        wq = bw[1:].view(k, n).copy_(wq)
    lut = ops.lut_table(BALANCED, dev)
    mag = ops.magnitude_lut(BALANCED, FaultConfig.from_yield(rows=32), dev)
    kerns = {**approx_matmul.KERNELS, **mitchell_gemm.KERNELS}
    before = {name: kerns[name].launches
              for name in ("lut_matmul", "lut_matmul_mag", "mitchell_matmul")}
    pairs = [(approx_matmul.lut_matmul(xq, wq, lut),
              ref.lut_matmul_ref(xq, wq, lut)),
             (approx_matmul.lut_matmul_mag(xq, wq, mag),
              approx_matmul.lut_matmul_mag_plain(xq, wq, mag))]
    for comp in (False, True):
        pairs.append((mitchell_gemm.mitchell_matmul(xq, wq, compensated=comp),
                      ref.mitchell_matmul_ref(xq, wq, compensated=comp)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert torch.equal(got, want)
    assert {name: kerns[name].launches - v for name, v in before.items()} \
        == {"lut_matmul": 1, "lut_matmul_mag": 1, "mitchell_matmul": 2}


@pytest.mark.parametrize("bits", [3, 5, 7])
def test_log_int_forms_below_8_bits_on_the_card(bits):
    """Below 8 bits mitchell takes every int8 and log_our every operand of
    magnitude below 2^bits, bitwise the plain version; log_our refuses one
    past it."""
    dev = _card()
    lim = 1 << bits
    _, _, xq, wq = _ops(33, 70, 17, dev, seed=bits)
    inside = xq.clamp(-lim + 1, lim - 1)
    w_in = wq.clamp(-lim + 1, lim - 1)
    got = mitchell_gemm.mitchell_matmul(xq, wq, bits, False)
    assert torch.equal(got, ref.mitchell_matmul_ref(xq, wq, bits, False))
    got = mitchell_gemm.mitchell_matmul(inside, w_in, bits, True)
    assert torch.equal(got, ref.mitchell_matmul_ref(inside, w_in, bits,
                                                    True))
    past = inside.clone()
    past[0, 0] = -lim
    with pytest.raises(ValueError, match="log_our"):
        mitchell_gemm.mitchell_matmul(past, w_in, bits, True)


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _card()
    x, w, xq, wq = _ops(8, 64, 16, dev)
    lut = ops.lut_table(BALANCED, dev)
    with pytest.raises(ValueError, match="int8"):
        approx_matmul.lut_matmul(xq.int(), wq, lut)
    with pytest.raises(ValueError, match="contiguous"):
        mitchell_gemm.mitchell_matmul(xq, wq.t().contiguous().t())
    with pytest.raises(ValueError, match="table"):
        approx_matmul.lut_matmul(xq, wq, lut.int())
    with pytest.raises(ValueError, match="devices"):
        mitchell_gemm.mitchell_matmul(xq, wq.cpu())
    # below 8 bits: operands inside the table match the plain version,
    # and one outside it is refused before the kernel could read past it
    lut4 = ops.lut_table(MultiplierSpec("appro42", 4, True, "orplane"), dev)
    x4, w4 = xq // 16, wq // 16                   # [-8, 8)
    assert torch.equal(approx_matmul.lut_matmul(x4, w4, lut4, bits=4),
                       ref.lut_matmul_ref(x4, w4, lut4, bits=4))
    with pytest.raises(ValueError, match="lie in"):
        approx_matmul.lut_matmul(xq, w4, lut4, bits=4)


@pytest.mark.parametrize("family", ["appro42", "mitchell"])
def test_model_matmul_on_the_card_runs_the_kernel_and_equals_cpu(family):
    dev = _card()
    kw = dict(family=family, bits=8, mode="hardware")
    if family == "appro42":
        kw.update(compressor="orplane", n_approx_cols=10)
    gp = GemmParams(**kw)
    x, w, _, _ = _ops(16, 256, 96, dev, seed=3)
    kern = (approx_matmul if family == "appro42" else mitchell_gemm)
    name = ("lut_matmul_fused" if family == "appro42"
            else "mitchell_matmul_fused")
    before = kern.KERNELS[name].launches
    got = model_matmul(x.reshape(2, 8, 256), w, gp)
    assert kern.KERNELS[name].launches == before + 1
    want = model_matmul(x.cpu().reshape(2, 8, 256), w.cpu(), gp)
    assert torch.equal(got.cpu(), want)


def test_engine_serves_on_the_card_through_the_kernels():
    from repro_torch.configs import get_config
    from repro_torch.serving import (SimClock, build_engine, build_tiers,
                                     poisson_workload)

    _card()
    cfg = get_config("qwen3-1.7b", smoke=True)
    eng = build_engine(cfg, tiers=build_tiers(mode="hardware"),
                       slots_per_tier=2, max_len=32, prompt_buckets=(8,),
                       group_buckets=(1, 2))
    eng.warmup()
    counts = {n: k.launches for n, k in
              {**approx_matmul.KERNELS, **mitchell_gemm.KERNELS}.items()}
    wl = poisson_workload(6, 100.0, cfg.vocab, prompt_len=(4, 8),
                          max_new=(2, 5),
                          tier_mix=(("exact", None, .3),
                                    ("balanced", None, .4),
                                    ("economy", None, .3)), seed=1)
    res = eng.run(wl, clock=SimClock())
    for r in wl:
        assert len(res[r.rid].tokens) == r.max_new
    assert eng.steady_plan_misses() == 0
    assert approx_matmul.KERNELS["lut_matmul_fused"].launches > \
        counts["lut_matmul_fused"]
    assert mitchell_gemm.KERNELS["mitchell_matmul_fused"].launches > \
        counts["mitchell_matmul_fused"]
    assert dataclasses.is_dataclass(res[0])
    assert np.isfinite(eng.lanes["balanced"].backend.last_decode_logits).all()


# ---------------------------------------------------------------------------
# CiM attention kernels
# ---------------------------------------------------------------------------

# (path, spec or None, compensated)
ATTN_PATHS = [("lut", BALANCED, False), ("log", None, False),
              ("log", None, True), ("nibble", MultiplierSpec("exact", 8, True),
                                    False), ("mxu", None, False)]
# (B, H, KH, Sq, Skv, D, variant): the reference's test geometry and the
# serving decode geometry (ragged fill levels)
ATTN_GEOMS = [(2, 4, 2, 21, 29, 12, "causal"), (2, 4, 2, 21, 29, 12, "window"),
              (2, 4, 2, 1, 29, 12, "ragged"), (4, 16, 8, 1, 320, 128,
                                               "ragged")]


def _attn_case(dev, b, h, kh, sq, skv, d, variant, seed=0):
    from repro_torch.kernels import attn_gemm

    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, h, sq, d, generator=g)
    k = torch.randn(b, kh, skv, d, generator=g)
    v = torch.randn(b, kh, skv, d, generator=g)
    qpos = torch.arange(skv - sq, skv, dtype=torch.int32).expand(b, sq)
    kpos = torch.arange(skv, dtype=torch.int32).expand(b, skv)
    fill = torch.tensor([skv - 3 * i for i in range(b)])[:, None]
    if variant == "long":            # a long cache, every slot below it
        fill = torch.tensor([skv - 1, 1500, 700, 130][:b])[:, None]
    kval = ((kpos < fill) if variant in ("ragged", "long")
            else torch.ones(b, skv, dtype=torch.bool)).to(torch.int32)
    ts = [t.contiguous().to(dev) for t in (q, k, v)]
    if variant == "offset":          # K/V one float past 16-byte alignment
        for i in (1, 2):
            buf = torch.empty(ts[i].numel() + 1, device=dev)
            ts[i] = buf[1:].view(ts[i].shape).copy_(ts[i])
    sc = attn_gemm.attn_scales(*ts, 8)
    return ts, sc, [t.contiguous().to(dev) for t in (qpos, kpos, kval)], \
        (5 if variant == "window" else None)


def _beyond_lsum_rounding(got, want):
    """Outputs of an attention kernel further from its plain version (on
    the same card) than the l sum's rounding: the two differ only in the
    order of that sum, which moves an output by at most 8 eps of |want|;
    one moved pq level moves it by about max|v| / (127 l), far more."""
    eps = torch.finfo(torch.float32).eps
    return int(((got - want).abs() > 8 * eps * want.abs()).sum())


@pytest.mark.parametrize("geom", ATTN_GEOMS, ids=str)
@pytest.mark.parametrize("path,spec,comp", ATTN_PATHS, ids=str)
def test_attn_kernels_against_plain_versions(path, spec, comp, geom):
    """Scores bitwise against the plain version and the template's (the
    cluster kernel's witness, forced at 8 bits), fused bitwise against
    materialized and the template's materialized, fused against the
    plain version within the l sum's rounding in every output (the order
    of that sum differs)."""
    from repro_torch.kernels import attn_gemm

    dev = _card()
    (q, k, v), sc, pos, window = _attn_case(dev, *geom)
    table = ops._attn_table(path, spec, dev)
    kw = dict(path=path, bits=8, causal=True, window=window,
              compensated=comp, block=(8, 128 if geom[4] > 64 else 16))
    scores = attn_gemm.attn_scores(q, k, sc[0], sc[1], *pos, table, **kw)
    plain_scores = attn_gemm.attn_scores_plain(q, k, sc[0], sc[1], *pos,
                                               table, **kw)
    tpl_scores = attn_gemm._attn_scores_forced(
        q, k, sc[0], sc[1], *pos, table, route="template", **kw)
    fused = attn_gemm.attn_fused(q, k, v, *sc, *pos, table, **kw)
    mat = attn_gemm.attn_materialized(q, k, v, *sc, *pos, table, **kw)
    tpl_mat = attn_gemm._attn_materialized_forced(
        q, k, v, *sc, *pos, table, route="template", **kw)
    plain = attn_gemm.attn_reference(q, k, v, *sc, *pos, table, **kw)
    torch.cuda.synchronize()
    assert torch.equal(scores, plain_scores)
    assert torch.equal(scores, tpl_scores)
    assert torch.equal(fused, mat)
    assert torch.equal(mat, tpl_mat)
    assert _beyond_lsum_rounding(fused, plain) == 0


# the cluster kernel at every split it takes: ATTN_GEOMS' reference
# geometry (2 kv blocks of 16), a long ragged decode (16 kv blocks of
# 128, fills 2047, 1500, 700, 130), and the two cases of its element-wise
# K/V ring: a head dim of 10 and K/V one float off 16-byte alignment
ATTN_SPLIT_GEOMS = ATTN_GEOMS[:3] + [(2, 4, 2, 1, 29, 12, "decode"),
                                     (4, 16, 8, 1, 2048, 128, "long"),
                                     (2, 4, 2, 21, 29, 10, "causal"),
                                     (2, 4, 2, 21, 29, 12, "offset")]


@pytest.mark.parametrize("geom", ATTN_SPLIT_GEOMS, ids=str)
@pytest.mark.parametrize("path,spec,comp", ATTN_PATHS, ids=str)
def test_attn_cluster_kernel_at_every_split(path, spec, comp, geom):
    """The cluster kernel forced to every split of the kv blocks that
    leaves no range empty, fused and PV (the scores mode at every split of
    its grid): bitwise equal to the template's materialized oracle, and
    within the l sum's rounding of its plain version in every output."""
    from repro_torch.kernels import attn_gemm

    dev = _card()
    (q, k, v), sc, pos, window = _attn_case(dev, *geom)
    table = ops._attn_table(path, spec, dev)
    bk = 128 if geom[4] > 64 else 16
    kw = dict(path=path, bits=8, causal=True, window=window,
              compensated=comp, block=(8, bk))
    scores = attn_gemm._attn_scores_forced(q, k, sc[0], sc[1], *pos, table,
                                           route="template", **kw)
    mat = attn_gemm._attn_pv_forced(scores, v, sc[2], *pos, table,
                                    route="template", **kw)
    plain = attn_gemm.attn_reference(q, k, v, *sc, *pos, table, **kw)
    nk = -(-geom[4] // bk)
    for splits in range(1, min(attn_gemm.MAX_SPLITS, nk) + 1):
        force = {"splits": splits}
        before = attn_gemm.KERNELS["attn_fused"].launches
        fused = attn_gemm._attn_fused_forced(q, k, v, *sc, *pos, table,
                                             force, **kw)
        pv = attn_gemm._attn_pv_forced(scores, v, sc[2], *pos, table,
                                       force=force, **kw)
        torch.cuda.synchronize()
        assert attn_gemm.KERNELS["attn_fused"].launches == before + 1
        assert torch.equal(fused, mat), splits
        assert torch.equal(pv, mat), splits
        assert _beyond_lsum_rounding(fused, plain) == 0, splits
    for splits in range(1, min(attn_gemm.MAX_SCORE_SPLITS, nk) + 1):
        got = attn_gemm._attn_scores_forced(q, k, sc[0], sc[1], *pos, table,
                                            force={"splits": splits}, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, scores), splits


def test_attn_wide_log_operands_take_the_template():
    """9..12-bit log operands run the template's three kernels
    (fused_route, materialized_route) and no cluster kernel, fused ==
    materialized bit for bit, within the l sum's rounding of the plain
    version."""
    from repro_torch.kernels import attn_gemm

    dev = _card()
    (q, k, v), _, pos, _ = _attn_case(dev, 2, 4, 2, 21, 29, 12, "causal")
    sc = attn_gemm.attn_scales(q, k, v, 12)
    kw = dict(path="log", bits=12, compensated=True, block=(8, 16))
    before = {n: kern.launches for n, kern in attn_gemm.KERNELS.items()}
    fused = attn_gemm.attn_fused(q, k, v, *sc, *pos, **kw)
    mat = attn_gemm.attn_materialized(q, k, v, *sc, *pos, **kw)
    plain = attn_gemm.attn_reference(q, k, v, *sc, *pos, **kw)
    torch.cuda.synchronize()
    assert {n: kern.launches - before[n]
            for n, kern in attn_gemm.KERNELS.items()} == {
        "attn_fused": 0, "attn_scores": 0, "attn_pv": 0,
        "attn_fused_wide": 1, "attn_scores_wide": 1, "attn_pv_wide": 1}
    assert torch.equal(fused, mat)
    assert _beyond_lsum_rounding(fused, plain) == 0


# (the shared-memory model the launch sends, its operands' bits, the
# kernel the call launches): the template's fused kernel (9..12-bit log
# operands) and its scores stage (forced at 8 bits, as the witness), and
# the cluster kernel in its three modes
REFUSING = [("attn_smem_bytes", "log", 12, "attn_fused_wide"),
            ("attn_smem_bytes", "lut", 8, "attn_scores_wide"),
            ("attn_cluster_smem", "lut", 8, "attn_fused"),
            ("attn_cluster_smem", "lut", 8, "attn_scores"),
            ("attn_cluster_smem", "lut", 8, "attn_pv")]


@pytest.mark.parametrize("model,path,bits,kernel", REFUSING, ids=str)
def test_attn_kernel_refuses_a_shared_memory_total_not_its_own(
        monkeypatch, model, path, bits, kernel):
    """The planner's shared-memory model (attn_smem_bytes for the
    template, attn_cluster_smem for the cluster kernel) and the kernel's
    layout are held together at every launch: a total that drifts from
    the kernel's is refused, not launched."""
    from repro_torch.kernels import attn_gemm

    dev = _card()
    (q, k, v), _, pos, _ = _attn_case(dev, 2, 4, 2, 21, 29, 12, "causal")
    sc = attn_gemm.attn_scales(q, k, v, bits)
    table = ops._attn_table(path, BALANCED, dev) if path == "lut" else None
    kw = dict(path=path, bits=bits, block=(8, 16))
    scores = attn_gemm.attn_scores(q, k, sc[0], sc[1], *pos, table, **kw)
    call = {
        "attn_scores_wide": lambda: attn_gemm._attn_scores_forced(
            q, k, sc[0], sc[1], *pos, table, route="template", **kw),
        "attn_scores": lambda: attn_gemm.attn_scores(
            q, k, sc[0], sc[1], *pos, table, **kw),
        "attn_pv": lambda: attn_gemm.attn_pv(scores, v, sc[2], *pos, table,
                                             **kw)}.get(
        kernel, lambda: attn_gemm.attn_fused(q, k, v, *sc, *pos, table,
                                             **kw))
    call()
    real = getattr(attn_gemm, model)
    monkeypatch.setattr(attn_gemm, model, lambda *a: real(*a) + 16)
    before = attn_gemm.KERNELS[kernel].launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        call()
    assert attn_gemm.KERNELS[kernel].launches == before


def test_cim_attention_on_the_card_runs_the_kernel():
    """cim_attention on CUDA tensors launches the fused kernel, which its
    plan's plain version on the same card matches within the l sum's
    rounding; against the CPU (whose exp may differ by an ulp and so move
    a pq level) it is within one probability quantum of max|v|."""
    from repro_torch.core.approx_gemm import (_attn_run_kwargs,
                                              cim_attention, plan_attn)
    from repro_torch.kernels import attn_gemm

    dev = _card()
    (q, k, v), _, (qpos, kpos, kval), _ = _attn_case(dev, 2, 4, 2, 21, 29,
                                                     12, "ragged", seed=4)
    t = lambda a: a.transpose(1, 2).contiguous()  # noqa: E731
    gp = GemmParams(family="appro42", bits=8, mode="hardware",
                    compressor="orplane", n_approx_cols=10)
    before = attn_gemm.KERNELS["attn_fused"].launches
    got = cim_attention(t(q), t(k), t(v), gp, q_positions=qpos,
                        kv_positions=kpos, kv_valid=kval)
    assert attn_gemm.KERNELS["attn_fused"].launches == before + 1
    plan = plan_attn("appro42", "hardware", 8, 2, 4, 2, 21, 29, 12,
                     backend="cuda", spec=gp.spec)
    plain = ops.cim_attn_reference(q, k, v, qpos, kpos, kval,
                                   **_attn_run_kwargs(gp, plan))
    assert _beyond_lsum_rounding(got, t(plain)) == 0
    want = cim_attention(t(q).cpu(), t(k).cpu(), t(v).cpu(), gp,
                         q_positions=qpos.cpu(), kv_positions=kpos.cpu(),
                         kv_valid=kval.cpu())
    assert float((got.cpu() - want).abs().max()) <= \
        float(v.abs().max()) / 127


# ---------------------------------------------------------------------------
# nibble sub-LUT GEMMs and implicit-GEMM conv kernels (the Table IV CNN)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(256, 64, 10), (33, 70, 17)], ids=str)
@pytest.mark.parametrize("core", ["lut", "nibble", "mitchell", "log_our"])
def test_fused_kernels_take_f32_operands_bitwise(core, shape):
    """The f32 x f32 instantiation the CNN's fc runs (the Table IV fc at
    the evaluation batch, and a ragged shape) equals its plain version."""
    dev = _card()
    m, k, n = shape
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(m, k, generator=g, device=dev)
    w = torch.randn(k, n, generator=g, device=dev) * 0.1
    sx, sw = ops._scales(x, w, 8)
    if core == "lut":
        lut = ops.lut_table(BALANCED, dev)
        got = approx_matmul.lut_matmul_fused(x, w, lut, sx, sw)
        want = approx_matmul.lut_matmul_fused_plain(x, w, lut, sx, sw)
    elif core == "nibble":
        subs = ops.nibble_table(MultiplierSpec("exact", 8, True), dev)
        got = approx_matmul.nibble_lut_matmul_fused(x, w, subs, sx, sw)
        want = approx_matmul.nibble_lut_matmul_fused_plain(x, w, subs, sx,
                                                           sw)
    else:
        comp = core == "log_our"
        got = mitchell_gemm.mitchell_matmul_fused(x, w, sx, sw,
                                                  compensated=comp)
        want = mitchell_gemm.mitchell_matmul_fused_plain(x, w, sx, sw,
                                                         compensated=comp)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want)


NIBBLE = [MultiplierSpec("exact", 8, True),
          MultiplierSpec("appro42", 8, True, n_approx_cols=4)]
# (B, H, W, C, N, kh, kw, stride): two Table IV CNN convs at the
# evaluation batch and tests/test_conv.py's ragged shapes
CONV_GEOMS = [(256, 16, 16, 3, 16, 3, 3, 1), (256, 4, 4, 32, 64, 3, 3, 1),
              (2, 9, 10, 5, 7, 3, 3, 1), (1, 7, 7, 3, 4, 5, 5, 1),
              (3, 8, 6, 4, 5, 1, 1, 1), (2, 10, 9, 3, 6, 3, 3, 2)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("spec", NIBBLE, ids=str)
def test_nibble_kernels_bitwise_equal_plain_versions(shape, spec):
    dev = _card()
    x, w, xq, wq = _ops(*shape, dev, seed=5)
    xq[:, 0] = -128                           # the saturating magnitude
    subs = ops.nibble_table(spec, dev)
    sx, sw = ops._scales(x, w, 8)
    got = approx_matmul.nibble_lut_matmul(xq, wq, subs)
    fused = approx_matmul.nibble_lut_matmul_fused(x, w, subs, sx, sw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.nibble_matmul_ref(xq, wq, subs))
    assert torch.equal(got, ref.lut_matmul_ref(xq, wq,
                                               ops.lut_table(spec, dev)))
    assert torch.equal(fused, approx_matmul.nibble_lut_matmul_fused_plain(
        x, w, subs, sx, sw))


@pytest.mark.parametrize("geom", CONV_GEOMS, ids=str)
def test_conv_kernels_bitwise_equal_plain_versions(geom):
    from repro_torch.kernels import conv_gemm

    dev = _card()
    b, h, w, c, n, kh, kw, s = geom
    g = torch.Generator(device=dev).manual_seed(sum(geom))
    x = torch.rand(b, h, w, c, generator=g, device=dev)
    w3 = torch.randn(kh * kw, c, n, generator=g, device=dev) * 0.1
    sx, sw = ops._scales(x, w3.reshape(-1, n), 8)
    geo = dict(kh=kh, kw=kw, stride=s)
    cases = [(ops.lut_table(MultiplierSpec("appro42", 8, True), dev), False)]
    cases += [(ops.nibble_table(sp, dev), True) for sp in NIBBLE]
    for table, nib in cases:
        got = conv_gemm.conv_lut_fused(x, w3, table, sx, sw, nibble=nib,
                                       **geo)
        want = conv_gemm.conv_lut_fused_plain(x, w3, table, sx, sw,
                                              nibble=nib, **geo)
        torch.cuda.synchronize()
        assert torch.equal(got, want), nib
    for comp in (False, True):
        got = conv_gemm.conv_log_fused(x, w3, sx, sw, compensated=comp, **geo)
        want = conv_gemm.conv_log_fused_plain(x, w3, sx, sw,
                                              compensated=comp, **geo)
        torch.cuda.synchronize()
        assert torch.equal(got, want), comp


# the fused LUT and log convs' tile kernel (csrc/conv_tile.cuh) at its
# edges: several N tiles and ragged channels, ragged N, N = 1, one pixel
# tile, a plane wider than one tile in both dimensions, stride 2 with 5x5
# and 7x7 taps, C = 3 and C = 96 on a 60-wide plane
CONV_TILE_EDGES = [(3, 12, 12, 17, 80, 3, 3, 1), (2, 9, 9, 3, 7, 3, 3, 1),
                   (2, 11, 7, 17, 1, 3, 3, 1), (1, 5, 5, 4, 16, 3, 3, 1),
                   (1, 20, 700, 8, 16, 3, 3, 1), (2, 13, 13, 3, 16, 5, 5, 2),
                   (2, 30, 30, 3, 64, 7, 7, 2), (1, 20, 60, 96, 24, 3, 3, 1),
                   (1, 20, 60, 3, 24, 3, 3, 1)]


def _tile_variants(dev):
    """(form, bits, table): the full table at 8 and 4 bits, the nibble
    sub-tables of the exact family and of appro42 with 4 approximate
    columns, mitchell and log_our."""
    a8, a4 = MultiplierSpec("appro42", 8, True), MultiplierSpec("appro42",
                                                                4, True)
    return [("lut", 8, ops.lut_table(a8, dev)),
            ("lut", 4, ops.lut_table(a4, dev)),
            ("nibble", 8, ops.nibble_table(NIBBLE[0], dev)),
            ("nibble", 8, ops.nibble_table(NIBBLE[1], dev)),
            ("mitchell", 8, None), ("log_our", 8, None)]


def _tile_plain(form, bits, table, x, w3, sx, sw, geo):
    from repro_torch.kernels import conv_gemm

    if form in ("lut", "nibble"):
        return conv_gemm.conv_lut_fused_plain(x, w3, table, sx, sw, bits,
                                              nibble=form == "nibble", **geo)
    return conv_gemm.conv_log_fused_plain(x, w3, sx, sw, bits,
                                          compensated=form == "log_our",
                                          **geo)


def _partial_variants(dev):
    """(form, bits, table) of the partial forms on the tile kernel at 2,
    4, 6 and 8 bits: appro42's full table, the exact family's nibble
    sub-tables, mitchell and log_our."""
    out = []
    for bits in (2, 4, 6, 8):
        out += [("lut", bits, ops.lut_table(MultiplierSpec("appro42", bits,
                                                           True), dev)),
                ("nibble", bits, ops.nibble_table(MultiplierSpec(
                    "exact", bits, True), dev)),
                ("mitchell", bits, None), ("log_our", bits, None)]
    return out


def _partial_pair(form, bits, table, x, w3, sx, sw, geo):
    """(the partial's plain version, the fused kernel) of one variant."""
    from repro_torch.kernels import conv_gemm

    if form in ("lut", "nibble"):
        nib = form == "nibble"
        return (conv_gemm.conv_lut_partial_plain(x, w3, table, sx, sw, bits,
                                                 nibble=nib, **geo),
                conv_gemm.conv_lut_fused(x, w3, table, sx, sw, bits,
                                         nibble=nib, **geo))
    comp = form == "log_our"
    return (conv_gemm.conv_log_partial_plain(x, w3, sx, sw, bits,
                                             compensated=comp, **geo),
            conv_gemm.conv_log_fused(x, w3, sx, sw, bits, compensated=comp,
                                     **geo))


@pytest.mark.parametrize("geom", CONV_TILE_EDGES, ids=str)
def test_conv_tile_kernel_bitwise_at_its_edges(geom):
    """Every variant of the two fused entries on the tile kernel, with the
    plan's micro-tile and every other one, equals its plain version bit
    for bit; log at 12 and 16 bits takes the template (the wide entry).
    The partial forms at 2, 4, 6 and 8 bits, against global scales 1.25x
    the shard's own, take the tile kernel at every micro-tile too: the
    int32 sum bitwise the plain partial, through the epilogue bitwise the
    fused kernel; the 12-bit log partial takes the template (its wide
    entry)."""
    from repro_torch.kernels import conv_gemm

    dev = _card()
    b, h, w, c, n, kh, kw, s = geom
    g = torch.Generator(device=dev).manual_seed(sum(geom))
    x = torch.randn(b, h, w, c, generator=g, device=dev)
    w3 = torch.randn(kh * kw, c, n, generator=g, device=dev) * 0.1
    geo = dict(kh=kh, kw=kw, stride=s)
    tile = {k: conv_gemm.KERNELS[k] for k in ("conv_lut_fused",
                                              "conv_log_fused",
                                              "conv_log_fused_wide")}
    for form, bits, table in _tile_variants(dev):
        sx, sw = ops._scales(x, w3.reshape(-1, n), bits)
        want = _tile_plain(form, bits, table, x, w3, sx, sw, geo)
        for force in (None,) + conv_gemm.TILE_MICRO:
            if force is None:
                got = (conv_gemm.conv_lut_fused(
                    x, w3, table, sx, sw, bits, nibble=form == "nibble",
                    **geo) if table is not None else conv_gemm.conv_log_fused(
                    x, w3, sx, sw, bits, compensated=form == "log_our",
                    **geo))
            else:
                try:
                    conv_gemm.conv_plan(form, bits, b, h, w, c, n, kh, kw, s,
                                        132, 1, force=force)
                except ValueError:       # no tile of this micro-tile fits
                    continue
                got = conv_gemm._conv_tile_forced(x, w3, table, sx, sw, form,
                                                  bits, kh, kw, s, force)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (form, bits, force)
    for bits in (12, 16):
        sx, sw = ops._scales(x, w3.reshape(-1, n), bits)
        before = {k: v.launches for k, v in tile.items()}
        for comp in (False, True):
            got = conv_gemm.conv_log_fused(x, w3, sx, sw, bits,
                                           compensated=comp, **geo)
            want = conv_gemm.conv_log_fused_plain(x, w3, sx, sw, bits,
                                                  compensated=comp, **geo)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (bits, comp)
        assert {k: v.launches - before[k] for k, v in tile.items()} == {
            "conv_lut_fused": 0, "conv_log_fused": 0,
            "conv_log_fused_wide": 2}
    part = {k: conv_gemm.KERNELS[k] for k in ("conv_lut_partial",
                                              "conv_log_partial",
                                              "conv_log_partial_wide")}
    for form, bits, table in _partial_variants(dev):
        sx, sw = ops._scales(x, w3.reshape(-1, n), bits)
        sx, sw = sx * 1.25, sw * 1.25
        want, fused = _partial_pair(form, bits, table, x, w3, sx, sw, geo)
        entry = ("conv_lut_partial" if table is not None
                 else "conv_log_partial")
        for force in (None,) + conv_gemm.TILE_MICRO:
            before = {k: v.launches for k, v in part.items()}
            if force is None:
                got = (conv_gemm.conv_lut_partial(
                    x, w3, table, sx, sw, bits, nibble=form == "nibble",
                    **geo) if table is not None
                    else conv_gemm.conv_log_partial(
                        x, w3, sx, sw, bits, compensated=form == "log_our",
                        **geo))
            else:
                try:
                    conv_gemm.conv_plan(form, bits, b, h, w, c, n, kh, kw, s,
                                        132, 1, force=force)
                except ValueError:       # no tile of this micro-tile fits
                    continue
                got = conv_gemm._conv_tile_forced(x, w3, table, sx, sw, form,
                                                  bits, kh, kw, s, force,
                                                  partial=True)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32, (form, bits, force)
            assert torch.equal(got, want), (form, bits, force)
            assert torch.equal((got.float() * sx) * sw, fused), (form, bits,
                                                                 force)
            assert {k: v.launches - before[k] for k, v in part.items()} == {
                k: int(k == entry) for k in part}
    sx, sw = ops._scales(x, w3.reshape(-1, n), 12)
    before = {k: v.launches for k, v in part.items()}
    for comp in (False, True):
        got = conv_gemm.conv_log_partial(x, w3, sx, sw, 12, compensated=comp,
                                         **geo)
        want = conv_gemm.conv_log_partial_plain(x, w3, sx, sw, 12,
                                                compensated=comp, **geo)
        fused = conv_gemm.conv_log_fused(x, w3, sx, sw, 12, compensated=comp,
                                         **geo)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want), comp
        assert torch.equal((got.float() * sx) * sw, fused), comp
    assert {k: v.launches - before[k] for k, v in part.items()} == {
        "conv_lut_partial": 0, "conv_log_partial": 0,
        "conv_log_partial_wide": 2}


def test_conv_tile_plan_reads_the_cards_residency():
    """The plan's grid is at most the blocks the card holds at once (the
    C query of the instantiation launched), and a plan the kernel does
    not take is refused at launch."""
    from repro_torch.kernels import conv_gemm

    dev = _card()
    x = torch.randn(256, 16, 16, 16, device=dev)
    w3 = torch.randn(9, 16, 16, device=dev) * 0.1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for form in ("lut", "nibble", "mitchell", "log_our"):
        plan = conv_gemm.device_plan(form, 8, x, w3, 3, 3, 1)
        held = conv_gemm._tile_capacity(0, conv_gemm.TILE_KIND[form], 8,
                                        plan.rp, plan.rn)
        assert held >= 1 and plan.grid == min(plan.tiles, sms * held)
    sx, sw = ops._scales(x, w3.reshape(-1, 16), 8)
    plan = conv_gemm.device_plan("mitchell", 8, x, w3, 3, 3, 1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        conv_gemm._LOG(x.data_ptr(), w3.data_ptr(), sx.data_ptr(),
                       sw.data_ptr(), torch.empty(1, device=dev).data_ptr(),
                       256, 16, 16, 16, 16, 3, 3, 1, 8, 0, plan.smem,
                       plan.rp, plan.rn, plan.ib, plan.tr, plan.tc,
                       plan.cc, plan.tg, plan.tiles + 1,
                       torch.cuda.current_stream().cuda_stream)


def test_conv_and_nibble_wrappers_raise_on_what_the_kernels_do_not_take(
        monkeypatch):
    from repro_torch.kernels import conv_gemm

    dev = _card()
    x = torch.rand(2, 8, 8, 4, device=dev)
    w3 = torch.randn(9, 4, 6, device=dev)
    sx, sw = ops._scales(x, w3.reshape(-1, 6), 8)
    subs = ops.nibble_table(NIBBLE[0], dev)
    with pytest.raises(ValueError, match="f32"):
        conv_gemm.conv_log_fused(x.to(torch.bfloat16), w3, sx, sw)
    with pytest.raises(ValueError, match="contiguous"):
        conv_gemm.conv_log_fused(x.transpose(1, 2), w3, sx, sw)
    with pytest.raises(ValueError, match="sub-tables"):
        conv_gemm.conv_lut_fused(x, w3, subs.to(torch.int16), sx, sw,
                                 nibble=True)
    with pytest.raises(ValueError, match="even width"):
        approx_matmul.nibble_lut_matmul(
            torch.zeros(4, 8, dtype=torch.int8, device=dev),
            torch.zeros(8, 4, dtype=torch.int8, device=dev), subs, bits=7)
    with pytest.raises(ValueError, match="devices"):
        conv_gemm.conv_log_fused(x, w3.cpu(), sx, sw)
    # the shared-memory total of the planner's model and the kernel's
    # layout are held together at every launch
    conv_gemm.conv_log_fused(x, w3, sx, sw)
    real = conv_gemm.gemm_smem_bytes
    monkeypatch.setattr(conv_gemm, "gemm_smem_bytes",
                        lambda *a: real(*a) + 16)
    before = conv_gemm.KERNELS["conv_log_fused"].launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        conv_gemm.conv_log_fused(x, w3, sx, sw)
    assert conv_gemm.KERNELS["conv_log_fused"].launches == before


@pytest.mark.parametrize("fam", ["exact", "appro42", "mitchell", "log_our"])
def test_cnn_forward_on_the_card_runs_the_kernels(fam):
    """A hardware-mode CNN forward launches five conv kernels of its
    family's entry and one fc GEMM kernel, equals the im2col oracle on
    the card bit for bit, and matches the CPU's plain versions."""
    from repro_torch.kernels import conv_gemm
    from repro_torch.launch.table4_cnn import eval_images, hardware_context
    from repro_torch.models.cnn import cnn_forward, init_cnn

    dev = _card()
    params = init_cnn(torch.Generator().manual_seed(0), device=dev)
    x, _ = eval_images(16, device=dev)
    ctx = hardware_context(fam)
    kernels = {**approx_matmul.KERNELS, **mitchell_gemm.KERNELS,
               **conv_gemm.KERNELS}
    conv = "conv_log_fused" if fam in ("mitchell", "log_our") \
        else "conv_lut_fused"
    fc = {"exact": "nibble_lut_matmul_fused",
          "appro42": "lut_matmul_fused"}.get(fam, "mitchell_matmul_fused")
    with torch.no_grad():
        cnn_forward(params, x, ctx)                  # plans built
        before = {n: k.launches for n, k in kernels.items()}
        got = cnn_forward(params, x, ctx)
        after = {n: k.launches - before[n] for n, k in kernels.items()}
        base = cnn_forward(params, x, ctx, fused=False)
        cpu = cnn_forward({k: v.cpu() for k, v in params.items()}, x.cpu(),
                          ctx)
    torch.cuda.synchronize()
    assert after == {n: {conv: 5, fc: 1}.get(n, 0) for n in kernels}
    assert torch.equal(got, base)
    assert float((got.cpu() - cpu).abs().max()) <= 5e-2


# ---------------------------------------------------------------------------
# the surrogate GEMM kernels and the exact-mode conv kernel
# ---------------------------------------------------------------------------

# (mu, c0, c1): the reference tests' coefficients and a c1 = 0 law
SURROGATE_COEFFS = [(-0.013, 1480.0, 2.1e-4), (0.02, 3.3, 0.0)]


def _sq_close(got, want, k):
    """SQ of the kernel (f32 sum in K order) against the exact value
    rounded once: within (K - 1) 2^-24 relative, plus its half ulp."""
    return bool(((got - want).abs() <= k * 2.0 ** -24 * want.abs()).all())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("coeffs", SURROGATE_COEFFS, ids=str)
def test_surrogate_kernels_against_plain_versions(shape, coeffs):
    """cim_gemm_core: D bitwise, SQ within K 2^-24 relative;
    cim_gemm_fused: bitwise with and without noise (bf16 and f32
    operands; SQ exact on the tensor cores)."""
    from repro_torch.kernels import cim_gemm

    dev = _card()
    m, k, n = shape
    mu, c0, c1 = coeffs
    x, w, xq, wq = _ops(m, k, n, dev, seed=9)
    xq[:, 0] = -128
    d, sq = cim_gemm.cim_gemm_core(xq, wq, need_sq=True)
    d0, sq0 = cim_gemm.cim_gemm_core(xq, wq, need_sq=False)
    pd, psq = cim_gemm.cim_gemm_core_plain(xq, wq)
    torch.cuda.synchronize()
    assert torch.equal(d, pd) and torch.equal(d0, pd)
    assert _sq_close(sq, psq, k) and not sq0.any()
    eps = torch.randn(m, n, generator=torch.Generator(device=dev)
                      .manual_seed(3), device=dev)
    for xs, ws in ((x, w), (x.float(), w.float())):
        sx, sw = ops._scales(xs, ws, 8)
        det = cim_gemm.cim_gemm_fused(xs, ws, sx, sw, None, mu, c0, c1)
        pdet = cim_gemm.cim_gemm_fused_plain(xs, ws, sx, sw, None, mu, c0,
                                             c1)
        got = cim_gemm.cim_gemm_fused(xs, ws, sx, sw, eps, mu, c0, c1)
        want = cim_gemm.cim_gemm_fused_plain(xs, ws, sx, sw, eps, mu, c0, c1)
        torch.cuda.synchronize()
        assert torch.equal(det, pdet)
        assert torch.equal(got, want)
        assert not torch.equal(got, det)


# cim_gemm_core's tensor-core route: ragged M, K (below one 32-deep
# fragment, between, above one 64-byte stage) and N (below one n8 tile,
# one, ragged, many 64-column tiles); K = 2048, 6144 at N = 2048 split K
# (at most 96 tiles of 64 x 64 there, fewer than two blocks an SM of an
# H100, so the launch splits K over a cluster)
CORE_M = [1, 4, 17, 64, 130]
CORE_K = [1, 31, 33, 2048, 6144]
CORE_N = [1, 7, 8, 17, 2048]


@pytest.mark.parametrize("k", CORE_K)
@pytest.mark.parametrize("m", CORE_M)
def test_core_tensor_core_route_bitwise_equal_plain_version(m, k):
    """cim_gemm_core without SQ (the int8 tensor cores, K split over a
    cluster's blocks and summed through its distributed shared memory):
    D bitwise equal to the plain version
    and, where its shape rules allow, to torch._int_mm; SQ all zeros; for
    random operands and for operands all -128 and all 127."""
    from repro_torch.kernels import cim_gemm

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(13 * m + k)
    for n in CORE_N:
        xq = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-128, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        for v in (None, -128, 127):
            a, b = ((xq, wq) if v is None
                    else (torch.full_like(xq, v), torch.full_like(wq, v)))
            d, sq = cim_gemm.cim_gemm_core(a, b, need_sq=False)
            want, _ = cim_gemm.cim_gemm_core_plain(a, b, need_sq=False)
            torch.cuda.synchronize()
            assert torch.equal(d, want), (n, v)
            assert sq.shape == (m, n) and not sq.any(), (n, v)
            if m > 16 and k % 8 == 0 and n % 8 == 0:
                assert torch.equal(d, torch._int_mm(a, b)), (n, v)


# conv_mxu_fused: the shared geometries plus C = 17 (a chunk padded to
# 20), N = 80 and 130 (two and three N tiles), stride 2 with 5x5 and 7x7
# taps, images in groups with a ragged last group, channels in several
# chunks and taps in two groups (C = 96 on a 60-wide plane), and one
# ResNet-18 conv2_x layer
MXU_GEOMS = CONV_GEOMS + [(8, 12, 12, 17, 80, 3, 3, 1),
                          (4, 9, 11, 5, 130, 3, 3, 2),
                          (2, 13, 13, 3, 16, 5, 5, 2),
                          (2, 30, 30, 3, 64, 7, 7, 2),
                          (5, 4, 4, 8, 10, 3, 3, 1),
                          (1, 20, 60, 96, 24, 3, 3, 1),
                          (4, 56, 56, 64, 64, 3, 3, 1)]


@pytest.mark.parametrize("geom", MXU_GEOMS, ids=str)
def test_conv_mxu_kernel_bitwise_equal_plain_version(geom):
    """The exact-mode conv kernel equals its plain version bit for bit and
    a float conv of the dequantized operands (TF32 off) within 1e-5."""
    from repro_torch.core.approx_gemm import (ConvParams, _float_conv,
                                              _full_f32_convs)
    from repro_torch.kernels import conv_gemm
    from repro_torch.kernels.ref import quantize_tile

    dev = _card()
    b, h, w, c, n, kh, kw, s = geom
    g = torch.Generator(device=dev).manual_seed(sum(geom) + 1)
    x = torch.randn(b, h, w, c, generator=g, device=dev)
    w3 = torch.randn(kh * kw, c, n, generator=g, device=dev) * 0.1
    sx, sw = ops._scales(x, w3.reshape(-1, n), 8)
    got = conv_gemm.conv_mxu_fused(x, w3, sx, sw, kh=kh, kw=kw, stride=s)
    want = conv_gemm.conv_mxu_fused_plain(x, w3, sx, sw, kh=kh, kw=kw,
                                          stride=s)
    xdq = quantize_tile(x, sx, 127).float() * sx
    wdq = quantize_tile(w3, sw, 127).float() * sw
    with _full_f32_convs():
        lib = _float_conv(xdq, wdq.reshape(-1, n), ConvParams(kh, kw, s))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.allclose(got, lib, rtol=1e-5, atol=1e-5)


def test_surrogate_wrappers_raise_on_what_the_kernels_do_not_take():
    from repro_torch.kernels import cim_gemm, conv_gemm

    dev = _card()
    x, w, xq, wq = _ops(8, 64, 16, dev)
    sx, sw = ops._scales(x, w, 8)
    eps = torch.randn(8, 16, device=dev)
    with pytest.raises(ValueError, match="int8"):
        cim_gemm.cim_gemm_core(xq.int(), wq)
    with pytest.raises(ValueError, match="eps must be"):
        cim_gemm.cim_gemm_fused(x, w, sx, sw, eps[:4], -0.01, 1.0, 1e-4)
    with pytest.raises(ValueError, match="contiguous f32"):
        cim_gemm.cim_gemm_fused(x, w, sx, sw, eps.double(), -0.01, 1.0,
                                1e-4)
    with pytest.raises(ValueError, match="devices"):
        cim_gemm.cim_gemm_fused(x, w, sx, sw, eps.cpu(), -0.01, 1.0, 1e-4)
    x4 = torch.rand(2, 8, 8, 4, device=dev)
    w3 = torch.randn(9, 4, 6, device=dev)
    s4, s6 = ops._scales(x4, w3.reshape(-1, 6), 8)
    with pytest.raises(ValueError, match="f32"):
        conv_gemm.conv_mxu_fused(x4.to(torch.bfloat16), w3, s4, s6)


def test_conv_mxu_kernel_refuses_a_shared_memory_total_not_its_own(
        monkeypatch):
    """The planner's shared-memory model (gemm_smem_bytes("mxu")) and the
    tensor-core conv kernel's layout are held together at every launch:
    a total other than the kernel's own is refused, and not counted."""
    from repro_torch.kernels import conv_gemm

    dev = _card()
    x = torch.rand(2, 8, 8, 4, device=dev)
    w3 = torch.randn(9, 4, 6, device=dev)
    sx, sw = ops._scales(x, w3.reshape(-1, 6), 8)
    conv_gemm.conv_mxu_fused(x, w3, sx, sw)
    real = conv_gemm.gemm_smem_bytes
    monkeypatch.setattr(conv_gemm, "gemm_smem_bytes",
                        lambda *a: real(*a) + 16)
    before = conv_gemm.KERNELS["conv_mxu_fused"].launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        conv_gemm.conv_mxu_fused(x, w3, sx, sw)
    assert conv_gemm.KERNELS["conv_mxu_fused"].launches == before


def test_surrogate_frontends_on_the_card_run_the_kernels():
    """Surrogate model_matmul and cim_matmul on CUDA tensors launch the
    fused kernel (no fallback to the plain route) and agree with the
    CPU's torch_surrogate route; the same key gives the same noise and
    cim_conv2d in exact mode launches the exact conv kernel."""
    from repro_torch.core.approx_gemm import (NoiseKey,
                                              _run_fused_surrogate,
                                              cim_conv2d, cim_matmul)
    from repro_torch.kernels import cim_gemm, conv_gemm

    dev = _card()
    gp = GemmParams(family="log_our", bits=8, mode="surrogate", mu=-0.013,
                    c0=1480.0, c1=2.1e-4)
    x, w, _, _ = _ops(16, 256, 96, dev, seed=4)
    kern = cim_gemm.KERNELS["cim_gemm_fused"]
    before = kern.launches
    got = model_matmul(x.reshape(2, 8, 256), w, gp)
    assert kern.launches == before + 1
    want = model_matmul(x.cpu().reshape(2, 8, 256), w.cpu(), gp)
    assert got.dtype == torch.bfloat16
    # the card's output is the plain cim_gemm_fused's on the same bf16
    # operands, bit for bit
    plain = _run_fused_surrogate(x.cpu(), w.cpu(), None, gp)
    assert torch.equal(got.reshape(16, 96).cpu(), plain.to(torch.bfloat16))
    # the CPU's torch_surrogate route rounds each fake-quantized operand,
    # the dot and the shifted output to bf16, the kernel only its output
    # (a bf16 ulp is up to 2^-7 of a value): within four ulps of the
    # largest output
    assert float((got.float().cpu() - want.float()).abs().max()) <= \
        2.0 ** -5 * float(want.float().abs().max())
    xf, wf = x.float(), w.float()
    a = cim_matmul(xf, wf, gp, NoiseKey(5))
    b = cim_matmul(xf, wf, gp, NoiseKey(5))
    c = cim_matmul(xf, wf, gp, NoiseKey(6))
    assert kern.launches == before + 4
    assert torch.equal(a, b) and not torch.equal(a, c)
    conv = conv_gemm.KERNELS["conv_mxu_fused"]
    before = conv.launches
    x4 = torch.randn(2, 8, 8, 4, device=dev)
    w2 = torch.randn(36, 6, device=dev)
    y = cim_conv2d(x4, w2, GemmParams(family="exact", bits=8, mode="exact"))
    assert conv.launches == before + 1
    ycpu = cim_conv2d(x4.cpu(), w2.cpu(),
                      GemmParams(family="exact", bits=8, mode="exact"))
    assert torch.equal(y.cpu(), ycpu)


def test_engine_serves_the_surrogate_ladder_on_the_card():
    from repro_torch.configs import get_config
    from repro_torch.kernels import cim_gemm
    from repro_torch.serving import (SimClock, build_engine, build_tiers,
                                     poisson_workload)

    _card()
    cfg = get_config("qwen3-1.7b", smoke=True)
    eng = build_engine(cfg, tiers=build_tiers(mode="surrogate"),
                       slots_per_tier=2, max_len=32, prompt_buckets=(8,),
                       group_buckets=(1, 2))
    eng.warmup()
    before = cim_gemm.KERNELS["cim_gemm_fused"].launches
    wl = poisson_workload(6, 100.0, cfg.vocab, prompt_len=(4, 8),
                          max_new=(2, 5),
                          tier_mix=(("exact", None, .3),
                                    ("balanced", None, .4),
                                    ("economy", None, .3)), seed=1)
    res = eng.run(wl, clock=SimClock())
    for r in wl:
        assert len(res[r.rid].tokens) == r.max_new
    assert eng.steady_plan_misses() == 0
    assert cim_gemm.KERNELS["cim_gemm_fused"].launches > before


# ---------------------------------------------------------------------------
# the mesh path's partial kernels (deferred epilogue, raw int32 out)
# ---------------------------------------------------------------------------

# the contraction-sharded wo and mlp.wo of qwen3-1.7b at model = 2, and a
# ragged shape
PARTIAL_SHAPES = [(4, 1024, 2048), (64, 3072, 2048), (33, 70, 17)]


@pytest.mark.parametrize("shape", PARTIAL_SHAPES, ids=str)
def test_partial_kernels_bitwise_equal_plain_versions(shape):
    dev = _card()
    x, w, _, _ = _ops(*shape, dev, seed=11)
    lut = ops.lut_table(BALANCED, dev)
    subs = ops.nibble_table(MultiplierSpec("exact", 8, True), dev)
    sx, sw = ops._scales(x, w, 8)
    pairs = [
        (approx_matmul.lut_matmul_partial(x, w, lut, sx, sw),
         approx_matmul.lut_matmul_partial_plain(x, w, lut, sx, sw),
         approx_matmul.lut_matmul_fused(x, w, lut, sx, sw)),
        (approx_matmul.nibble_lut_matmul_partial(x, w, subs, sx, sw),
         approx_matmul.nibble_lut_matmul_partial_plain(x, w, subs, sx, sw),
         approx_matmul.nibble_lut_matmul_fused(x, w, subs, sx, sw))]
    for comp in (False, True):
        pairs.append((
            mitchell_gemm.mitchell_matmul_partial(x, w, sx, sw,
                                                  compensated=comp),
            mitchell_gemm.mitchell_matmul_partial_plain(x, w, sx, sw,
                                                        compensated=comp),
            mitchell_gemm.mitchell_matmul_fused(x, w, sx, sw,
                                                compensated=comp)))
    torch.cuda.synchronize()
    for got, want, fused in pairs:
        assert got.dtype == torch.int32 and torch.equal(got, want)
        # the fused kernel is the partial one and the epilogue
        assert torch.equal(approx_matmul.epilogue(got, sx, sw), fused)


def test_nibble_partial_clips_below_the_int8_minimum():
    """Scales supplied by the caller may quantize an operand past -qmax
    (-255 here): it clips to -127, and the nibble core's saturation of
    |-128| is never reached, on the card as in the plain version."""
    dev = _card()
    x, w, _, _ = _ops(8, 64, 16, dev, seed=12)
    sx, sw = ops._scales(x, w, 8)
    x[:, 0] = -2.0 * float(x.abs().max())
    subs = ops.nibble_table(MultiplierSpec("exact", 8, True), dev)
    got = approx_matmul.nibble_lut_matmul_partial(x, w, subs, sx, sw)
    want = approx_matmul.nibble_lut_matmul_partial_plain(x, w, subs, sx, sw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("geom", CONV_GEOMS, ids=str)
def test_conv_partial_kernels_bitwise_equal_plain_versions(geom):
    from repro_torch.kernels import conv_gemm

    dev = _card()
    b, h, w, c, n, kh, kw, s = geom
    g = torch.Generator(device=dev).manual_seed(sum(geom) + 1)
    x = torch.rand(b, h, w, c, generator=g, device=dev)
    w3 = torch.randn(kh * kw, c, n, generator=g, device=dev) * 0.1
    sx, sw = ops._scales(x, w3.reshape(-1, n), 8)
    geo = dict(kh=kh, kw=kw, stride=s)
    cases = [(ops.lut_table(MultiplierSpec("appro42", 8, True), dev), False)]
    cases += [(ops.nibble_table(sp, dev), True) for sp in NIBBLE]
    for table, nib in cases:
        got = conv_gemm.conv_lut_partial(x, w3, table, sx, sw, nibble=nib,
                                         **geo)
        want = conv_gemm.conv_lut_partial_plain(x, w3, table, sx, sw,
                                                nibble=nib, **geo)
        fused = conv_gemm.conv_lut_fused(x, w3, table, sx, sw, nibble=nib,
                                         **geo)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want), nib
        assert torch.equal((got.float() * sx) * sw, fused), nib
    for comp in (False, True):
        got = conv_gemm.conv_log_partial(x, w3, sx, sw, compensated=comp,
                                         **geo)
        want = conv_gemm.conv_log_partial_plain(x, w3, sx, sw,
                                                compensated=comp, **geo)
        fused = conv_gemm.conv_log_fused(x, w3, sx, sw, compensated=comp,
                                         **geo)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want), comp
        assert torch.equal((got.float() * sx) * sw, fused), comp


def test_partial_wrappers_raise_on_what_the_kernels_do_not_take():
    from repro_torch.kernels import conv_gemm

    dev = _card()
    x, w, _, _ = _ops(8, 64, 16, dev)
    sx, sw = ops._scales(x, w, 8)
    lut = ops.lut_table(BALANCED, dev)
    with pytest.raises(ValueError, match="f32/bf16"):
        approx_matmul.lut_matmul_partial(x.int(), w, lut, sx, sw)
    with pytest.raises(ValueError, match="sw must be"):
        mitchell_gemm.mitchell_matmul_partial(x, w, sx, sw[:3])
    with pytest.raises(ValueError, match="devices"):
        approx_matmul.nibble_lut_matmul_partial(
            x, w.cpu(), ops.nibble_table(MultiplierSpec("exact", 8, True),
                                         dev), sx, sw)
    x4 = torch.rand(2, 6, 6, 4, device=dev)
    w3 = torch.randn(9, 4, 5, device=dev)
    s4, s5 = ops._scales(x4, w3.reshape(-1, 5), 8)
    with pytest.raises(ValueError, match="f32 operands"):
        conv_gemm.conv_log_partial(x4.to(torch.bfloat16), w3, s4, s5)


def _mesh_rank(rank, world, dev):
    """One rank of a (2, 2) mesh on the card: the mesh GEMM and conv
    against the single-device call, and which kernels each layout ran."""
    from repro_torch.core import approx_gemm as ag
    from repro_torch.kernels import conv_gemm as cg
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import P

    mesh = make_host_mesh(2)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(8, 256, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(256, 128, generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    out = {}
    kernels = {**approx_matmul.KERNELS, **mitchell_gemm.KERNELS,
               **cg.KERNELS}
    for fam, extra in (("appro42", dict(compressor="orplane",
                                         n_approx_cols=10)),
                       ("mitchell", {})):
        gp = GemmParams(family=fam, bits=8, mode="hardware", **extra)
        base = model_matmul(x, w, gp)
        for lname, xs, ws in (("K", P("data", "model"), P("model", None)),
                              ("N", P("data", None), P(None, "model"))):
            before = {k: v.launches for k, v in kernels.items()}
            got = model_matmul(x, w, gp, mesh=mesh, x_spec=xs, w_spec=ws)
            ran = sorted(k for k, v in kernels.items()
                         if v.launches > before[k])
            out[f"{fam}/{lname}"] = (bool(torch.equal(got, base)), ran)
    x4 = torch.rand(4, 8, 8, 16, generator=g, device=dev)
    w2 = torch.randn(9 * 16, 8, generator=g, device=dev)
    gp = GemmParams(family="log_our", bits=8, mode="hardware")
    base = ag.cim_conv2d(x4, w2, gp)
    for lname, ws in (("C", P("model", None)), ("N", P(None, "model"))):
        got = ag.cim_conv2d(x4, w2, gp, mesh=mesh,
                            x_spec=P("data", None, None, None), w_spec=ws)
        out[f"conv/{lname}"] = (bool(torch.equal(got, base)), [])
    return out


def test_mesh_on_the_card_runs_the_partial_kernels():
    from repro_torch.launch.mesh import spawn

    _card()
    res = spawn(_mesh_rank, 4, device="cuda", timeout=300)
    for r in res:
        assert all(ok for ok, _ in r.values()), r
        assert r["appro42/K"][1] == ["lut_matmul_partial"]
        assert r["appro42/N"][1] == ["lut_matmul_fused"]
        assert r["mitchell/K"][1] == ["mitchell_matmul_partial"]
        assert r["mitchell/N"][1] == ["mitchell_matmul_fused"]


# the sLSTM kernel against its plain version, within the tolerance
# kernels/slstm_scan.py states (ATOL, STATE_RTOL; its mechanism there):
# xlstm-125m's width at T = 1, 37, 512 and at batch 8 (two row tiles a
# head), the smoke width (dh 16, a ragged row tile at B = 5)
SLSTM_CASES = [(4, 4, 192, 1), (4, 4, 192, 37), (4, 4, 192, 512),
               (2, 4, 16, 24), (5, 4, 16, 9), (8, 4, 192, 37)]
# the cluster sizes whose block fits at dh = 192, each forced at the
# full-width cases; a head too wide for any cluster (the streamed route)
SLSTM_SIZES = (3, 4, 6, 8, 12, 16)
SLSTM_WIDE = (2, 1, 512, 9)


def _slstm_inputs(b, t, nh, dh, dev, seed, nonzero):
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.randn(b, t, 4 * nh * dh, generator=g, device=dev)
    r = torch.randn(nh, dh, 4 * dh, generator=g, device=dev) * 0.05
    bias = torch.randn(nh, 4 * dh, generator=g, device=dev) * 0.1
    state = None
    if nonzero:
        shape = (b, nh, dh)
        state = (torch.rand(shape, generator=g, device=dev) * 2 - 1,
                 torch.rand(shape, generator=g, device=dev) * 1.5 + 0.5,
                 torch.rand(shape, generator=g, device=dev) - 0.5,
                 torch.rand(shape, generator=g, device=dev) * 2 - 1)
    return u, r, bias, state


@pytest.mark.parametrize("nonzero", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("case", SLSTM_CASES, ids=str)
def test_slstm_kernel_against_plain_version(case, nonzero):
    """xlstm-125m's width (4 heads of 192) at T = 1, 37 and 512 and the
    smoke width (dh 16, a ragged row tile at B = 5), from zeros and from
    a cached state."""
    from repro_torch.kernels import ref, slstm_scan

    dev = _card()
    b, nh, dh, t = case
    u, r, bias, state = _slstm_inputs(b, t, nh, dh, dev, t + dh, nonzero)
    n0 = slstm_scan.KERNELS["slstm_scan"].launches
    routes = dict(slstm_scan.ROUTES)
    got = slstm_scan.slstm_scan(u, r, bias, nh, state)
    torch.cuda.synchronize()
    assert slstm_scan.KERNELS["slstm_scan"].launches == n0 + 1
    assert slstm_scan.ROUTES == {"cluster": routes["cluster"] + 1,
                                 "streamed": routes["streamed"]}
    want = ref.slstm_scan_ref(u, r, bias, nh, state)
    assert got[0].shape == (b, t, nh, dh)
    assert slstm_scan.close(got, want), float((got[0] - want[0]).abs().max())


@pytest.mark.parametrize("case", SLSTM_CASES[:3], ids=str)
@pytest.mark.parametrize("cs", SLSTM_SIZES, ids=lambda v: f"cs{v}")
def test_slstm_every_cluster_size_against_plain_version(cs, case):
    """Every cluster size the plan may pick at dh = 192, forced, from a
    cached state."""
    from repro_torch.kernels import ref, slstm_scan

    dev = _card()
    b, nh, dh, t = case
    assert cs in slstm_scan.fitting_sizes(dh, dev)
    u, r, bias, state = _slstm_inputs(b, t, nh, dh, dev, t + cs, True)
    routes = dict(slstm_scan.ROUTES)
    got = slstm_scan._launch(u, r, bias, nh, state, cs)
    torch.cuda.synchronize()
    assert slstm_scan.ROUTES["cluster"] == routes["cluster"] + 1
    want = ref.slstm_scan_ref(u, r, bias, nh, state)
    assert slstm_scan.close(got, want), float((got[0] - want[0]).abs().max())


@pytest.mark.parametrize("nonzero", [False, True], ids=["zero", "state"])
def test_slstm_streamed_route_at_a_wide_head(nonzero):
    """A head of 512 fits no cluster: the plan streams it, by shape."""
    from repro_torch.kernels import ref, slstm_scan

    dev = _card()
    b, nh, dh, t = SLSTM_WIDE
    assert slstm_scan.device_plan(b, nh, dh, dev).route == "streamed"
    u, r, bias, state = _slstm_inputs(b, t, nh, dh, dev, 5, nonzero)
    n0 = slstm_scan.KERNELS["slstm_scan"].launches
    routes = dict(slstm_scan.ROUTES)
    got = slstm_scan.slstm_scan(u, r, bias, nh, state)
    torch.cuda.synchronize()
    assert slstm_scan.KERNELS["slstm_scan"].launches == n0 + 1
    assert slstm_scan.ROUTES == {"cluster": routes["cluster"],
                                 "streamed": routes["streamed"] + 1}
    want = ref.slstm_scan_ref(u, r, bias, nh, state)
    assert slstm_scan.close(got, want), float((got[0] - want[0]).abs().max())


def test_slstm_refused_cluster_launch_raises():
    """A cluster size that does not divide dh, or whose slice does not fit
    a block, is refused by the C entry and raises; nothing is counted and
    nothing runs on the other route."""
    from repro_torch.kernels import slstm_scan

    dev = _card()
    u, r, bias, _ = _slstm_inputs(4, 3, 4, 192, dev, 0, False)
    n0 = slstm_scan.KERNELS["slstm_scan"].launches
    routes = dict(slstm_scan.ROUTES)
    for cs in (5, 2, 1, 17):
        with pytest.raises(RuntimeError, match="CUDA error"):
            slstm_scan._launch(u, r, bias, 4, None, cs)
    assert slstm_scan.KERNELS["slstm_scan"].launches == n0
    assert slstm_scan.ROUTES == routes


def test_slstm_capacity_bounds_the_plan():
    """The C query gives 0 for a cluster size that does not divide dh or
    lies beyond 16, and holds no more blocks than the SMs do (32 an SM);
    at xlstm-125m's dh = 192 exactly the sizes 3, 4, 6, 8, 12 and 16 fit
    (1 and 2 need more threads or shared memory than a block has), at dh
    = 512 and 1024 none, so the plan streams those heads; the plan takes
    the cluster route at xlstm-125m's width, its waves from the
    capacity."""
    from repro_torch.kernels import slstm_scan
    from repro_torch.kernels.build import query

    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dh in (8, 13, 16, 64, 192, 256, 384, 512, 1024):
        for cs in range(1, 18):
            cap = query("slstm_scan", "slstm_scan_capacity", dh, cs)
            if dh % cs or cs > slstm_scan.MAX_CLUSTER:
                assert cap == 0, (dh, cs, cap)
            assert 0 <= cap and cap * cs <= sms * 32, (dh, cs, cap)
    assert slstm_scan.fitting_sizes(192, dev) == list(SLSTM_SIZES)
    assert slstm_scan.fitting_sizes(16, dev) == [1, 2, 4, 8, 16]
    for dh in (512, 1024):
        assert slstm_scan.fitting_sizes(dh, dev) == []
        assert slstm_scan.device_plan(2, 1, dh, dev).route == "streamed"
    for b in (4, 8):
        plan = slstm_scan.device_plan(b, 4, 192, dev)
        cap = slstm_scan._capacity(0, 192, plan.cs)
        assert plan.route == "cluster" and plan.cs in SLSTM_SIZES
        assert plan.waves == -(-4 * -(-b // slstm_scan.ROWS) // cap)


def test_slstm_profiler_classes_the_cluster_kernel():
    """chip_smoke.py's profile classes the cluster kernel as "sLSTM
    scan", by the name the profiler records."""
    import importlib.util
    import os

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import slstm_scan

    dev = _card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    u, r, bias, state = _slstm_inputs(4, 5, 4, 192, dev, 1, True)
    slstm_scan.slstm_scan(u, r, bias, 4, state)        # built, planned
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        slstm_scan.slstm_scan(u, r, bias, 4, state)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA and "slstm" in e.name.lower()}
    assert names and all("slstm_cluster" in n for n in names), names
    assert {smoke._kernel_class(n, set()) for n in names} == {"sLSTM scan"}


def test_profile_read_is_the_profilers_tree_on_the_card():
    """chip_smoke.py's `_profile_read` gives on the card what the
    profiler's own event list gives: the kernels (a port kernel, cuBLAS,
    elementwise and a copy) with their times, the top-level aten ops and
    the matmul's kernels, which the profile classes as torch.matmul; in
    every profile, and one of three sees them all."""
    import importlib.util
    import os

    from torch.profiler import ProfilerActivity, profile

    from test_torch_smoke_profile import same_as_the_tree

    dev = _card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    x, w, _, _ = _ops(64, 2048, 2048, dev)
    lut = ops.lut_table(BALANCED, dev)
    sx, sw = ops._scales(x, w, 8)

    def run():
        y = approx_matmul.lut_matmul_fused(x, w, lut, sx, sw)
        z = torch.matmul(x, w).float()
        (y + z).softmax(-1).sum().cpu()
        torch.cuda.synchronize()

    run()
    seen = []
    for _ in range(3):              # CUPTI drops a record now and then
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        kern, n_ops, mm = same_as_the_tree(smoke, prof)
        seen.append(({smoke._kernel_class(n, mm) for n, _ in kern}, n_ops))
    assert any({"CiM LUT kernel", "torch.matmul", "copies"} <= classes
               and n_ops >= 5 for classes, n_ops in seen), seen


def test_slstm_wrapper_raises_on_what_the_kernel_does_not_take():
    from repro_torch.kernels import slstm_scan

    dev = _card()
    u, r, bias, _ = _slstm_inputs(1, 3, 2, 8, dev, 0, False)
    with pytest.raises(ValueError, match="f32"):
        slstm_scan.slstm_scan(u.to(torch.bfloat16), r, bias, 2)
    with pytest.raises(ValueError, match="contiguous"):
        slstm_scan.slstm_scan(u, r.transpose(1, 2).contiguous().transpose(
            1, 2), bias, 2)
    with pytest.raises(ValueError, match="different devices"):
        slstm_scan.slstm_scan(u, r.cpu(), bias, 2)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def test_xlstm_lm_on_the_card_runs_the_kernel():
    """xlstm-125m-smoke on the balanced tier: every sLSTM call (prefill
    and each decode step) launches the kernel on the cluster route, and
    the card's logits agree with the CPU's (4e-2,
    tests/test_torch_lm_xlstm.py's tier tolerance)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import slstm_scan
    from repro_torch.models.transformer import LM
    from repro_torch.serving import build_tiers

    dev = _card()
    tier = {t.name: t for t in build_tiers(mode="hardware")}["balanced"]
    cfg = dataclasses.replace(get_config("xlstm-125m", smoke=True),
                              cim=tier.cim)
    cpu, gpu = LM(cfg, device="cpu"), LM(cfg, device=dev)
    p_cpu = cpu.init(0)
    p_gpu = _tree_to(p_cpu, dev)
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(3))
    n0 = slstm_scan.KERNELS["slstm_scan"].launches
    routes = dict(slstm_scan.ROUTES)
    with torch.inference_mode():
        lc, cc = cpu.prefill(p_cpu, {"tokens": toks})
        lg, cg = gpu.prefill(p_gpu, {"tokens": toks.to(dev)})
        for step in range(2):
            tok = lc[:, -1].argmax(-1, keepdim=True)
            lc, cc = cpu.decode_step(p_cpu, cc, tok, 8 + step)
            lg, cg = gpu.decode_step(p_gpu, cg, tok.to(dev), 8 + step)
    torch.cuda.synchronize()
    assert slstm_scan.KERNELS["slstm_scan"].launches == n0 + 3
    assert slstm_scan.ROUTES == {"cluster": routes["cluster"] + 3,
                                 "streamed": routes["streamed"]}
    assert torch.allclose(lg.float().cpu(), lc.float(), rtol=0, atol=4e-2)


@pytest.mark.parametrize("d", [2048, 768, 1536, 128])
def test_rms_norm_rows_do_not_depend_on_the_row_count(d):
    """The norm of rows 0-1 of a 4-row bf16 input equals the same rows
    normed alone, bit for bit (a data rank of the mesh holds 2 of the
    pool's 4 rows), at qwen3-1.7b's width and xlstm-125m's, the mLSTM's
    inner width and qwen3's head width (its q and k norms): over 64
    inputs, both the bf16 norm and its f32 mean square (a one-ulp
    difference there moves the norm only now and then), and at 1, 2, 4,
    8 and 2048 rows."""
    from repro_torch.models.common import rms_norm, row_mean_square

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(d)
    w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(
        torch.bfloat16)
    for _ in range(64):
        x = (torch.randn(4, d, generator=g, device=dev) * 3).to(
            torch.bfloat16)
        for rows in (x, x[:, None, :]):          # (B, D) and (B, 1, D)
            four = rms_norm(rows, w)
            assert torch.equal(rms_norm(rows[:2].clone(), w), four[:2])
            assert torch.equal(rms_norm(rows[1:2].clone(), w), four[1:2])
            ms = row_mean_square(rows.float())
            assert torch.equal(row_mean_square(rows[:2].float()), ms[:2])
    big = torch.randn(2048, d, generator=g, device=dev)
    ms = row_mean_square(big)
    for n in (1, 2, 4, 8):
        assert torch.equal(row_mean_square(big[-n:].clone()), ms[-n:])


# ---------------------------------------------------------------------------
# the split-K cluster kernel (csrc/cluster_gemm.cuh): lut_matmul_fused and
# mitchell_matmul_fused up to 8 bits
# ---------------------------------------------------------------------------

# every M in {1, 4, 17, 64, 65, 130, 2048}, K in {1, 31, 33, 2048, 6144}
# and N in {1, 7, 8, 17, 2048}: one row tile of 4, 16 or 64 rows or
# several, one K step or up to 8 slices, ragged tiles and rows that are
# not 16-byte multiples (element loads)
CLUSTER_EDGES = [(1, 31, 7), (4, 1, 1), (17, 33, 17), (64, 2048, 8),
                 (65, 6144, 17), (130, 33, 2048), (2048, 31, 1),
                 (4, 6144, 2048), (2048, 2048, 7), (1, 2048, 2048),
                 (130, 6144, 8)]
LUT4 = MultiplierSpec("appro42", 4, True, "orplane")


def _float_ops(m, k, n, dev, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w = (torch.randn(k, n, generator=g, device=dev) * 0.02).to(dtype)
    return x, w


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", CLUSTER_EDGES, ids=str)
def test_cluster_kernels_bitwise_equal_plain_versions(shape, dtype):
    """LUT at 4 and 8 bits, mitchell and log_our at 8 bits (the cluster
    kernel) and at 16 (the tiled template) against the plain versions."""
    dev = _card()
    x, w = _float_ops(*shape, dev, dtype, seed=sum(shape))
    pairs = []
    for spec in (BALANCED, LUT4):
        lut = ops.lut_table(spec, dev)
        sx, sw = ops._scales(x, w, spec.bits)
        pairs.append((approx_matmul.lut_matmul_fused(x, w, lut, sx, sw,
                                                     spec.bits),
                      approx_matmul.lut_matmul_fused_plain(x, w, lut, sx, sw,
                                                           spec.bits)))
    for bits in (8, 16):
        sx, sw = ops._scales(x, w, bits)
        for comp in (False, True):
            pairs.append((
                mitchell_gemm.mitchell_matmul_fused(x, w, sx, sw, bits, comp),
                mitchell_gemm.mitchell_matmul_fused_plain(x, w, sx, sw, bits,
                                                          comp)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", CLUSTER_EDGES, ids=str)
def test_cluster_partials_bitwise_equal_plain_versions(shape, dtype):
    """The partial forms at the cluster kernel's edges: the LUT at 4 and 8
    bits and mitchell and log_our at 8 on the cluster kernel, the log
    forms at 16 on the tiled template (fused_route); int32, bitwise the
    plain versions, through the epilogue bitwise the fused kernels, and
    each launched on its bits' route."""
    dev = _card()
    x, w = _float_ops(*shape, dev, dtype, seed=sum(shape) + 1)
    kerns = {**approx_matmul.KERNELS, **mitchell_gemm.KERNELS}
    names = ("lut_matmul_partial", "mitchell_matmul_partial",
             "mitchell_matmul_partial_wide")
    before = {n: kerns[n].launches for n in names}
    cases = []
    for spec in (BALANCED, LUT4):
        lut = ops.lut_table(spec, dev)
        sx, sw = ops._scales(x, w, spec.bits)
        cases.append((approx_matmul.lut_matmul_partial(x, w, lut, sx, sw,
                                                       spec.bits),
                      approx_matmul.lut_matmul_partial_plain(
                          x, w, lut, sx, sw, spec.bits),
                      approx_matmul.lut_matmul_fused(x, w, lut, sx, sw,
                                                     spec.bits), sx, sw))
    for bits in (8, 16):
        sx, sw = ops._scales(x, w, bits)
        for comp in (False, True):
            cases.append((
                mitchell_gemm.mitchell_matmul_partial(x, w, sx, sw, bits,
                                                      comp),
                mitchell_gemm.mitchell_matmul_partial_plain(x, w, sx, sw,
                                                            bits, comp),
                mitchell_gemm.mitchell_matmul_fused(x, w, sx, sw, bits,
                                                    comp), sx, sw))
    torch.cuda.synchronize()
    for got, want, fused, sx, sw in cases:
        assert got.dtype == torch.int32 and torch.equal(got, want)
        assert torch.equal(approx_matmul.epilogue(got, sx, sw), fused)
    assert {n: kerns[n].launches - c for n, c in before.items()} == \
        {"lut_matmul_partial": 2, "mitchell_matmul_partial": 2,
         "mitchell_matmul_partial_wide": 2}


def test_cluster_partial_capacity_query_bounds_the_plan():
    """The partial instantiations' own capacity queries: positive for
    every row tile and split, no larger for a larger cluster, and the
    plan at a shard shape (M = 4) a split they hold."""
    dev = _card()
    x, w = _float_ops(4, 1024, 2048, dev, torch.bfloat16)
    for kern, flags in ((approx_matmul.KERNELS["lut_matmul_partial"], ()),
                        (mitchell_gemm.KERNELS["mitchell_matmul_partial"],
                         (1,))):
        for rows in approx_matmul.CLUSTER_ROWS:
            caps = [approx_matmul._capacity(
                kern.library, kern.symbol + "_capacity", 0,
                (8, *flags, 1, 1), rows, s) for s in range(1, 9)]
            assert all(c > 0 for c in caps), (kern.symbol, rows, caps)
            assert caps == sorted(caps, reverse=True)
        plan = approx_matmul.fused_plan(kern, x, w, 8, *flags)
        assert plan.rows == 4 and plan.tiles == 32 and plan.splits > 1


def test_cluster_kernels_take_mixed_and_misaligned_operands():
    """x bf16 with w f32 and the reverse; operands whose storage starts 2
    or 4 bytes past a 16-byte boundary (loaded by elements)."""
    dev = _card()
    lut = ops.lut_table(BALANCED, dev)
    for xt, wt in ((torch.bfloat16, torch.float32),
                   (torch.float32, torch.bfloat16)):
        x, _ = _float_ops(4, 2048, 1024, dev, xt)
        _, w = _float_ops(4, 2048, 1024, dev, wt, seed=1)
        for shift in (0, 1):
            if shift:
                x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
                w = torch.cat([w.new_zeros(1), w.flatten()])[1:].view(w.shape)
                assert x.data_ptr() % 16 and w.data_ptr() % 16
            sx, sw = ops._scales(x, w, 8)
            assert torch.equal(
                approx_matmul.lut_matmul_fused(x, w, lut, sx, sw),
                approx_matmul.lut_matmul_fused_plain(x, w, lut, sx, sw))
            for comp in (False, True):
                assert torch.equal(
                    mitchell_gemm.mitchell_matmul_fused(x, w, sx, sw, 8, comp),
                    mitchell_gemm.mitchell_matmul_fused_plain(x, w, sx, sw, 8,
                                                              comp))


@pytest.mark.parametrize("bits", [8, 16])
def test_fused_route_picks_the_kernel_on_the_card(bits):
    """Both sides of fused_route: 8 bits launches the cluster kernel, 16
    the tiled template, each bitwise equal to the plain version."""
    dev = _card()
    x, w = _float_ops(4, 2048, 1024, dev, torch.bfloat16)
    sx, sw = ops._scales(x, w, bits)
    kern = mitchell_gemm.KERNELS
    before = {n: kern[n].launches for n in
              ("mitchell_matmul_fused", "mitchell_matmul_fused_wide")}
    got = mitchell_gemm.mitchell_matmul_fused(x, w, sx, sw, bits, False)
    want = mitchell_gemm.mitchell_matmul_fused_plain(x, w, sx, sw, bits,
                                                     False)
    assert torch.equal(got, want)
    name = ("mitchell_matmul_fused" if mitchell_gemm.fused_route(bits)
            == "cluster" else "mitchell_matmul_fused_wide")
    assert {n: kern[n].launches - c for n, c in before.items()} == \
        {n: int(n == name) for n in before}


@pytest.mark.parametrize("m", [4, 64])
def test_fused_scaled_with_a_sliced_column_scale(m):
    """The mesh's output-sharded form: global scales over the whole
    weight, the shard's columns and its slice of sw (storage offset)."""
    dev = _card()
    x, w = _float_ops(m, 2048, 2048, dev, torch.bfloat16, seed=5)
    sx, sw = ops._scales(x, w, 8)
    shard, sws = w[:, 1024:].contiguous(), sw[1024:]
    assert sws.data_ptr() != sw.data_ptr()
    lut = ops.lut_table(BALANCED, dev)
    assert torch.equal(
        ops.lut_fused_scaled(x, shard, BALANCED, sx, sws),
        approx_matmul.lut_matmul_fused_plain(x, shard, lut, sx, sws))
    for comp in (False, True):
        assert torch.equal(
            ops.log_fused_scaled(x, shard, sx, sws, compensated=comp),
            mitchell_gemm.mitchell_matmul_fused_plain(x, shard, sx, sws, 8,
                                                      comp))


def test_cluster_kernel_refuses_a_plan_it_does_not_take():
    """The C entry checks the plan: a slice that is empty, a split past 8,
    a K slice not a multiple of the step, or rows it has no tile for
    raise at launch."""
    dev = _card()
    x, w = _float_ops(4, 256, 64, dev, torch.bfloat16)
    sx, sw = ops._scales(x, w, 8)
    out = torch.empty(4, 64, device=dev)
    kern = mitchell_gemm.KERNELS["mitchell_matmul_fused"]
    from repro_torch.kernels.build import stream_of

    def launch(rows, splits, k_split):
        kern(x.data_ptr(), 1, w.data_ptr(), 1, sx.data_ptr(), sw.data_ptr(),
             out.data_ptr(), 4, 256, 64, 8, 0, rows, splits, k_split,
             stream_of(x))

    launch(4, 2, 128)                       # the plan's own cut runs
    for bad in ((4, 3, 128), (4, 9, 32), (4, 2, 100), (8, 1, 256),
                (4, 1, 128)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            launch(*bad)


def test_cluster_capacity_query_bounds_the_plan():
    """The device's cluster capacity (cudaOccupancyMaxActiveClusters) for
    every row count, split and operand type: positive, never more threads
    than the SMs hold (2048 an SM), and no larger for a larger cluster;
    the plan on the card picks a split that fits."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kern, flags, threads in ((approx_matmul.KERNELS["lut_matmul_fused"],
                                  (), 512),
                                 (mitchell_gemm.KERNELS[
                                     "mitchell_matmul_fused"], (0,), 256)):
        for xb, wb in ((1, 1), (0, 0), (1, 0)):
            for rows in approx_matmul.CLUSTER_ROWS:
                caps = [approx_matmul._capacity(
                    kern.library, kern.symbol + "_capacity", 0,
                    (8, *flags, xb, wb), rows, s) for s in range(1, 9)]
                assert all(c > 0 for c in caps), (kern.symbol, rows, caps)
                assert all(c * s * threads <= sms * 2048
                           for s, c in enumerate(caps, 1)), caps
                assert caps == sorted(caps, reverse=True)
        x, w = _float_ops(4, 2048, 2048, dev, torch.bfloat16)
        plan = approx_matmul.fused_plan(kern, x, w, 8, *flags)
        assert plan.rows == 4 and plan.tiles == 32
        assert approx_matmul._capacity(
            kern.library, kern.symbol + "_capacity", 0, (8, *flags, 1, 1),
            4, plan.splits) > 0


# the nibble forms on the cluster kernel (ClusterNibbleCore): the exact
# family at every even width, appro42 with 4 approximate columns at 8
NIBBLE_WIDTHS = [(MultiplierSpec("exact", b, True), b) for b in (2, 4, 6, 8)] \
    + [(NIBBLE[1], 8)]


def _nibble_cases(x, w, dev):
    """(partial, plain partial, fused, plain fused, sx, sw) for every
    NIBBLE_WIDTHS entry on x, w."""
    cases = []
    for spec, bits in NIBBLE_WIDTHS:
        subs = ops.nibble_table(spec, dev)
        sx, sw = ops._scales(x, w, bits)
        cases.append((
            approx_matmul.nibble_lut_matmul_partial(x, w, subs, sx, sw, bits),
            approx_matmul.nibble_lut_matmul_partial_plain(x, w, subs, sx, sw,
                                                          bits),
            approx_matmul.nibble_lut_matmul_fused(x, w, subs, sx, sw, bits),
            approx_matmul.nibble_lut_matmul_fused_plain(x, w, subs, sx, sw,
                                                        bits), sx, sw))
    return cases


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", CLUSTER_EDGES, ids=str)
def test_nibble_cluster_kernels_bitwise_at_the_edges(shape, dtype):
    """The nibble fused and partial forms at the cluster kernel's edges, at
    2, 4, 6 and 8 bits (the exact family) and for appro42/4: bitwise the
    plain versions, each partial through the epilogue bitwise its fused
    form, every launch on the fused and partial entries (the int entry
    never)."""
    dev = _card()
    x, w = _float_ops(*shape, dev, dtype, seed=sum(shape) + 2)
    kerns = approx_matmul.KERNELS
    names = ("nibble_lut_matmul_fused", "nibble_lut_matmul_partial",
             "nibble_lut_matmul")
    before = {n: kerns[n].launches for n in names}
    cases = _nibble_cases(x, w, dev)
    torch.cuda.synchronize()
    for part, part_plain, fused, fused_plain, sx, sw in cases:
        assert part.dtype == torch.int32 and torch.equal(part, part_plain)
        assert fused.dtype == torch.float32 and torch.equal(fused,
                                                            fused_plain)
        assert torch.equal(approx_matmul.epilogue(part, sx, sw), fused)
    n = len(NIBBLE_WIDTHS)
    assert {k: kerns[k].launches - c for k, c in before.items()} == \
        {"nibble_lut_matmul_fused": n, "nibble_lut_matmul_partial": n,
         "nibble_lut_matmul": 0}


def test_nibble_cluster_kernels_take_mixed_and_misaligned_operands():
    """x bf16 with w f32 and the reverse; bf16 operands 2 bytes and f32
    operands 4 bytes past a 16-byte boundary (loaded by elements)."""
    dev = _card()
    for xt, wt in ((torch.bfloat16, torch.float32),
                   (torch.float32, torch.bfloat16),
                   (torch.bfloat16, torch.bfloat16),
                   (torch.float32, torch.float32)):
        x, _ = _float_ops(4, 2048, 1024, dev, xt)
        _, w = _float_ops(4, 2048, 1024, dev, wt, seed=1)
        for shift in (0, 1):
            if shift:
                x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
                w = torch.cat([w.new_zeros(1), w.flatten()])[1:].view(w.shape)
                assert x.data_ptr() % 16 and w.data_ptr() % 16
            for part, part_plain, fused, fused_plain, _, _ in _nibble_cases(
                    x, w, dev):
                assert torch.equal(part, part_plain)
                assert torch.equal(fused, fused_plain)


def test_nibble_cluster_capacity_query_bounds_the_plan():
    """The nibble instantiations' capacity queries: positive for each of
    their row tiles (NIBBLE_ROWS), split, operand type and even width,
    never more threads than the SMs hold, no larger for a larger
    cluster; an odd width and a 64-row tile refused; the plan at a decode
    shape a split they hold, at a prefill 16-row tiles."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name in ("nibble_lut_matmul_fused", "nibble_lut_matmul_partial"):
        kern = approx_matmul.KERNELS[name]
        for bits in (2, 8):
            for xb, wb in ((1, 1), (0, 0), (1, 0)):
                for rows in approx_matmul.NIBBLE_ROWS:
                    caps = [approx_matmul._capacity(
                        kern.library, kern.symbol + "_capacity", 0,
                        (bits, xb, wb), rows, s) for s in range(1, 9)]
                    assert all(c > 0 for c in caps), (name, rows, caps)
                    assert all(c * s * 256 <= sms * 2048
                               for s, c in enumerate(caps, 1)), caps
                    assert caps == sorted(caps, reverse=True)
        for bits, rows in ((7, 4), (8, 64)):
            with pytest.raises(RuntimeError, match="CUDA error"):
                approx_matmul._capacity(kern.library,
                                        kern.symbol + "_capacity", 0,
                                        (bits, 1, 1), rows, 1)
        x, w = _float_ops(4, 2048, 2048, dev, torch.bfloat16)
        plan = approx_matmul.fused_plan(kern, x, w, 8)
        assert plan.rows == 4 and plan.tiles == 32 and plan.splits > 1
        x, w = _float_ops(64, 2048, 2048, dev, torch.bfloat16)
        plan = approx_matmul.fused_plan(kern, x, w, 8)
        assert plan.rows == 16 and plan.tiles == 128


def test_nibble_cluster_kernel_refuses_what_it_does_not_take():
    """The C entry refuses a plan it does not take (an empty slice, a
    split past 8, a K slice off the step, rows it has no tile for, the
    frame's 64-row tile) and an odd width: each raises at launch."""
    dev = _card()
    x, w = _float_ops(4, 256, 64, dev, torch.bfloat16)
    sx, sw = ops._scales(x, w, 8)
    subs = ops.nibble_table(NIBBLE[0], dev)
    out = torch.empty(4, 64, device=dev)
    kern = approx_matmul.KERNELS["nibble_lut_matmul_fused"]
    from repro_torch.kernels.build import stream_of

    def launch(rows, splits, k_split, bits=8):
        kern(x.data_ptr(), 1, w.data_ptr(), 1, subs.data_ptr(),
             sx.data_ptr(), sw.data_ptr(), out.data_ptr(), 4, 256, 64, bits,
             rows, splits, k_split, stream_of(x))

    launch(4, 2, 128)                       # the plan's own cut runs
    for bad in ((4, 3, 128), (4, 9, 32), (4, 2, 100), (8, 1, 256),
                (4, 1, 128), (64, 1, 256), (4, 2, 128, 7)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            launch(*bad)


@pytest.mark.parametrize("shape", CLUSTER_EDGES, ids=str)
def test_nibble_int_form_bitwise_at_the_cluster_edges(shape):
    """nibble_lut_matmul on the split-K cluster kernel at its edges, at 2,
    4, 6 and 8 bits (the exact family) and for appro42/4: int8 operands
    over the whole int8 range (-128 in x's first column; below 8 bits most
    magnitudes lie past qmax, which the kernel saturates) bitwise
    ref.nibble_matmul_ref, one launch of nibble_gemm_int8_cluster a call;
    at (1, 2048, 2048) both operands one byte off 16-byte alignment (the
    element loads)."""
    dev = _card()
    m, k, n = shape
    _, _, xq, wq = _ops(m, k, n, dev, seed=m + k + n + 3)
    xq[:, :1] = -128
    if shape == (1, 2048, 2048):
        bx = torch.empty(xq.numel() + 1, dtype=torch.int8, device=dev)
        bw = torch.empty(wq.numel() + 1, dtype=torch.int8, device=dev)
        xq = bx[1:].view(m, k).copy_(xq)
        wq = bw[1:].view(k, n).copy_(wq)
        assert xq.data_ptr() % 16 and wq.data_ptr() % 16
    kern = approx_matmul.KERNELS["nibble_lut_matmul"]
    assert kern.symbol == "nibble_gemm_int8_cluster"
    before = kern.launches
    pairs = []
    for spec, bits in NIBBLE_WIDTHS:
        subs = ops.nibble_table(spec, dev)
        pairs.append((approx_matmul.nibble_lut_matmul(xq, wq, subs, bits),
                      ref.nibble_matmul_ref(xq, wq, subs, bits)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.dtype == torch.int32 and torch.equal(got, want)
    assert kern.launches - before == len(NIBBLE_WIDTHS)


# ---------------------------------------------------------------------------
# the fused surrogate GEMM on the split-K cluster kernel
# (csrc/surrogate_cluster.cuh): bitwise against the plain version
# ---------------------------------------------------------------------------

# every row tile (16 with masked rows, 64, several), one K step or up to 8
# slices, ragged N and rows that are not 16-byte multiples (element
# loads), the CNN's fc and a noisy surrogate-mode conv's im2col GEMM
SURROGATE_EDGES = [(1, 31, 7), (4, 1, 1), (17, 33, 17), (33, 70, 17),
                   (64, 2048, 8), (130, 2048, 17), (130, 6144, 2048),
                   (256, 64, 10), (65536, 27, 16)]
# (mu, c0, c1) -> the three variants: served (no eps), noise without SQ
# (c1 = 0), noise with SQ
SURROGATE_VARIANTS = [("served", (-0.013, 1480.0, 2.1e-4), False),
                      ("noise", (0.02, 3.3, 0.0), True),
                      ("noise_sq", (-0.013, 1480.0, 2.1e-4), True)]


def _surrogate_pairs(x, w, eps, bits):
    """(kernel, plain) outputs of cim_gemm_fused in its three variants."""
    from repro_torch.kernels import cim_gemm

    sx, sw = ops._scales(x, w, bits)
    out = []
    for _, (mu, c0, c1), noisy in SURROGATE_VARIANTS:
        e = eps if noisy else None
        out.append((cim_gemm.cim_gemm_fused(x, w, sx, sw, e, mu, c0, c1,
                                            bits),
                    cim_gemm.cim_gemm_fused_plain(x, w, sx, sw, e, mu, c0,
                                                  c1, bits)))
    return out


@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.float32),
                                    (torch.bfloat16, torch.float32)],
                         ids=["bf16", "f32", "mixed"])
@pytest.mark.parametrize("shape", SURROGATE_EDGES, ids=str)
def test_fused_surrogate_bitwise_at_the_edges(shape, dtypes):
    """Each variant at 8 bits (and 2 and 4 on the smaller shapes) bitwise
    equal to the plain version, random operands and operands at +-max
    (every code +-qmax: SQ's largest sums)."""
    from repro_torch.kernels import cim_gemm

    dev = _card()
    m, k, n = shape
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.randn(m, k, generator=g, device=dev).to(dtypes[0])
    w = (torch.randn(k, n, generator=g, device=dev) * 0.02).to(dtypes[1])
    eps = torch.randn(m, n, generator=g, device=dev)
    sign = torch.where(torch.rand(k, n, generator=g, device=dev) < 0.5,
                       -1.0, 1.0)
    xmax = torch.full_like(x, 3.0)
    wmax = (sign * 0.5).to(dtypes[1])
    kern = cim_gemm.KERNELS["cim_gemm_fused"]
    for a, b in ((x, w), (xmax, wmax)):
        for bits in (8, 4, 2) if m * k * n <= 1 << 22 else (8,):
            before = kern.launches
            pairs = _surrogate_pairs(a, b, eps, bits)
            torch.cuda.synchronize()
            assert kern.launches == before + 3
            for (tag, _, _), (got, want) in zip(SURROGATE_VARIANTS, pairs):
                assert got.shape == (m, n) and bool(torch.isfinite(got).all())
                assert torch.equal(got, want), (tag, bits, float(
                    (got - want).abs().max()))


def test_fused_surrogate_takes_misaligned_operands():
    """Operands whose storage starts 2 or 4 bytes past a 16-byte boundary
    (loaded by elements) give the aligned result."""
    dev = _card()
    for dt in (torch.bfloat16, torch.float32):
        x, w = _float_ops(4, 2048, 1024, dev, dt, seed=7)
        eps = torch.randn(4, 1024, device=dev)
        xs = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
        ws = torch.cat([w.new_zeros(1), w.flatten()])[1:].view(w.shape)
        assert xs.data_ptr() % 16 and ws.data_ptr() % 16
        for (got, want), (again, _) in zip(_surrogate_pairs(xs, ws, eps, 8),
                                           _surrogate_pairs(x, w, eps, 8)):
            assert torch.equal(got, want) and torch.equal(got, again)


def test_fused_surrogate_refuses_a_launch_it_does_not_take():
    """The C entry checks the plan, the variant against eps, and SQ's K
    limit: each bad launch raises and is not counted."""
    from repro_torch.kernels import cim_gemm
    from repro_torch.kernels.build import stream_of

    dev = _card()
    x, w = _float_ops(4, 256, 64, dev, torch.bfloat16)
    sx, sw = ops._scales(x, w, 8)
    eps = torch.randn(4, 64, device=dev)
    out = torch.empty(4, 64, device=dev)
    kern = cim_gemm.KERNELS["cim_gemm_fused"]

    def launch(var, rows, splits, k_split, k=256, e=eps):
        kern(x.data_ptr(), 1, w.data_ptr(), 1, sx.data_ptr(), sw.data_ptr(),
             None if e is None else e.data_ptr(), out.data_ptr(), 4, k, 64,
             8, 1.0, 1.0, 1e-4, var, rows, splits, k_split, stream_of(x))

    launch(cim_gemm.NOISE_SQ, 16, 2, 128)      # a plan of its own kind runs
    before = kern.launches
    for bad in ((cim_gemm.NOISE_SQ, 16, 3, 128), (cim_gemm.NOISE_SQ, 4, 1,
                                                  256),
                (cim_gemm.NOISE_SQ, 16, 2, 100), (3, 16, 1, 256),
                (cim_gemm.NOISE_SQ, 64, 9, 32)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            launch(*bad)
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch(cim_gemm.SERVED, 16, 1, 256)          # eps with SERVED
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch(cim_gemm.NOISE, 16, 1, 256, e=None)   # noise without eps
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch(cim_gemm.NOISE_SQ, 16, 8, 16_704, k=cim_gemm.SQ_MAX_K)
    assert kern.launches == before
    # the wrapper refuses SQ past the limit before it launches
    xl = torch.zeros(1, cim_gemm.SQ_MAX_K, device=dev)
    wl = torch.zeros(cim_gemm.SQ_MAX_K, 1, device=dev)
    s1, s2 = ops._scales(xl, wl, 8)
    with pytest.raises(ValueError, match="SQ exactly"):
        cim_gemm.cim_gemm_fused(xl, wl, s1, s2, torch.zeros(1, 1, device=dev),
                                0.0, 1.0, 1e-4)
    assert kern.launches == before


def test_fused_surrogate_capacity_bounds_the_plan():
    """The device's cluster capacity for every variant, row tile, split
    and operand type: positive, never more threads than the SMs hold, no
    larger for a larger cluster; the plan picks a split that fits."""
    from repro_torch.kernels import cim_gemm

    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kern = cim_gemm.KERNELS["cim_gemm_fused"]
    for var in (cim_gemm.SERVED, cim_gemm.NOISE, cim_gemm.NOISE_SQ):
        for xb, wb in ((1, 1), (0, 0), (1, 0)):
            for rows in cim_gemm.FUSED_ROWS:
                caps = [approx_matmul._capacity(
                    kern.library, kern.symbol + "_capacity", 0,
                    (var, xb, wb), rows, s) for s in range(1, 9)]
                assert all(c > 0 for c in caps), (var, rows, caps)
                assert all(c * s * 256 <= sms * 2048
                           for s, c in enumerate(caps, 1)), caps
                assert caps == sorted(caps, reverse=True)
        x, w = _float_ops(4, 2048, 2048, dev, torch.bfloat16)
        plan = cim_gemm.fused_launch_plan(x, w, var)
        assert plan.rows == 16 and plan.tiles == 32
        assert approx_matmul._capacity(
            kern.library, kern.symbol + "_capacity", 0, (var, 1, 1), 16,
            plan.splits) > 0


# ---------------------------------------------------------------------------
# per-token scales and speculative decoding
# ---------------------------------------------------------------------------

# the per-token hardware lanes and the int form each one launches
PER_TOKEN_LANES = [
    (dict(family="appro42", compressor="orplane", n_approx_cols=10),
     "lut_matmul"),
    (dict(family="mitchell"), "mitchell_matmul"),
    (dict(family="appro42", compressor="orplane", n_approx_cols=4),
     "nibble_lut_matmul")]


@pytest.mark.parametrize("lane,kernel", PER_TOKEN_LANES, ids=str)
def test_per_token_gemm_on_the_card_runs_the_int_kernel(lane, kernel):
    """A per-token hardware GEMM launches its int form once (no fused
    form, no plain version), its rows are the rows of 4-row calls, and it
    equals the CPU's plain route bitwise."""
    dev = _card()
    gp = GemmParams(bits=8, mode="hardware", per_token=True, **lane)
    x, w, _, _ = _ops(20, 2048, 1024, dev, seed=5)
    kerns = {**approx_matmul.KERNELS, **mitchell_gemm.KERNELS}
    before = {n: k.launches for n, k in kerns.items()}
    got = model_matmul(x.reshape(4, 5, 2048), w, gp)
    torch.cuda.synchronize()
    moved = {n: k.launches - before[n] for n, k in kerns.items()
             if k.launches != before[n]}
    assert moved == {kernel: 1}
    rows = torch.cat([model_matmul(x[i:i + 4], w, gp)
                      for i in range(0, 20, 4)])
    assert torch.equal(rows, got.reshape(20, -1))
    want = model_matmul(x[:4].cpu(), w.cpu(), gp)
    assert torch.equal(got.reshape(20, -1)[:4].cpu(), want)


def test_per_token_surrogate_on_the_card_is_the_fused_kernel_per_tensor():
    """The fused surrogate kernel takes one scalar sx: a per-token
    surrogate GEMM on the card is the per-tensor one, as the reference's
    Pallas kernel on its TPU route."""
    from repro_torch.kernels import cim_gemm

    dev = _card()
    kw = dict(family="appro42", bits=8, mode="surrogate", mu=-0.01,
              compressor="orplane", n_approx_cols=10)
    x, w, _, _ = _ops(20, 256, 96, dev, seed=6)
    kern = cim_gemm.KERNELS["cim_gemm_fused"]
    before = kern.launches
    got = model_matmul(x, w, GemmParams(per_token=True, **kw))
    assert kern.launches == before + 1
    assert torch.equal(got, model_matmul(x, w, GemmParams(**kw)))


def test_decode_multi_on_the_card_equals_sequential_decode():
    """qwen3-1.7b-smoke on the card: decode_multi over 4 positions is
    bitwise 4 sequential decode_steps on a ragged pool, per-token exact
    and per-token balanced."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serving import build_tiers
    from repro_torch.serving.engine import LMLaneBackend

    dev = _card()
    cfg = get_config("qwen3-1.7b", smoke=True)
    params = LM(cfg, dev).init(0)
    g = torch.Generator().manual_seed(9)
    for tier in build_tiers(mode="hardware")[:2]:
        cim = dataclasses.replace(tier.cim, per_token=True)
        lm = LM(dataclasses.replace(cfg, cim=cim), dev)
        lane = LMLaneBackend(lm, params, n_slots=3, max_len=16,
                             prompt_buckets=(6,), group_buckets=(3,))
        lane.admit([torch.randint(0, cfg.vocab, (n,), generator=g).numpy()
                    for n in (6, 4, 2)], [0, 1, 2])
        toks = torch.randint(0, cfg.vocab, (3, 4), generator=g).to(dev)
        fill = torch.as_tensor(lane.slot_pos, dtype=torch.int32, device=dev)

        def clone():
            return {"layers": [{n: t.clone() for n, t in layer.items()}
                               for layer in lane.caches["layers"]]}
        with torch.inference_mode():
            lg_m, c_m = lm.decode_multi(params, clone(), toks, fill)
            c, rows, pos = clone(), [], fill
            for i in range(4):
                lg, c = lm.decode_step(params, c, toks[:, i:i + 1], pos)
                rows.append(lg[:, -1])
                pos = pos + 1
        assert torch.equal(lg_m, torch.stack(rows, dim=1)), tier.name
        for a, b in zip(c_m["layers"], c["layers"]):
            for name in ("k", "v", "pos"):
                assert torch.equal(a[name], b[name]), (tier.name, name)


def test_spec_engine_on_the_card_matches_the_exact_lane():
    """The spec engine on the card (qwen3-1.7b-smoke, drafter on the
    fused LUT kernel): tokens equal to the per-token exact engine's at
    every warmed depth, no plan built after warmup, K/V past every fill
    zero."""
    from repro_torch.configs import get_config
    from repro_torch.core.approx_gemm import plan_misses
    from repro_torch.models.transformer import LM
    from repro_torch.serving import (SimClock, build_engine, build_tiers,
                                     poisson_workload, spec_pair)
    from repro_torch.serving.spec import nonzero_past_fill

    dev = _card()
    cfg = get_config("qwen3-1.7b", smoke=True)
    params = LM(cfg, dev).init(0)
    tiers = build_tiers(mode="hardware")
    _, v_tier = spec_pair(tiers)
    kw = dict(slots_per_tier=2, max_len=32, prompt_buckets=(6,),
              group_buckets=(1, 2))
    base = build_engine(cfg, params, tiers=(v_tier,), **kw)
    spec = build_engine(cfg, params, tiers=tiers, spec_decode=2,
                        spec_ks=(1, 2, 4), **kw)
    base.warmup()
    spec.warmup()
    mark = plan_misses()
    wl = poisson_workload(6, 500.0, cfg.vocab, prompt_len=(3, 6),
                          max_new=(2, 10), tier_mix=(("exact", None, 1.0),),
                          seed=11)
    want = base.run(wl, clock=SimClock())
    sb = spec.lanes["exact"].backend
    fused = approx_matmul.KERNELS["lut_matmul_fused"]
    for k in (1, 2, 4):
        sb.set_draft_k(k)
        before = fused.launches
        got = spec.run(wl, clock=SimClock())
        assert fused.launches > before
        for r in wl:
            assert got[r.rid].tokens == want[r.rid].tokens, (k, r.rid)
        assert nonzero_past_fill(sb.caches, sb.slot_pos) == 0
    assert plan_misses() == mark


def test_per_token_exact_prefill_rows_do_not_depend_on_the_group():
    """The per-token exact lane's float products run in fixed row blocks
    (approx_gemm.ROW_BLOCK): a prompt prefilled alone gives bitwise the
    logits and caches it gets in a group of 4 (one cuBLAS product of 64
    rows moved a row of mlp_wo before)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serving import build_tiers, spec_pair

    dev = _card()
    cfg = get_config("qwen3-1.7b", smoke=True)
    params = LM(cfg, dev).init(0)
    lm = LM(dataclasses.replace(cfg, cim=spec_pair(
        build_tiers(mode="hardware"))[1].cim), dev)
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (4, 16), generator=g).to(dev)
    lens = torch.tensor([11, 16, 9, 13], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        lg4, c4 = lm.prefill(params, {"tokens": toks, "lengths": lens,
                                      "max_len": 32})
        lg1, c1 = lm.prefill(params, {"tokens": toks[:1],
                                      "lengths": lens[:1], "max_len": 32})
    assert torch.equal(lg4[:1], lg1)
    for a, b in zip(c4["layers"], c1["layers"]):
        for name in ("k", "v"):
            assert torch.equal(a[name][:1], b[name])
