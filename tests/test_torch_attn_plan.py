"""The CiM attention's cluster kernel on the CPU.  csrc/attn_cluster.cuh
splits a query tile's kv blocks over a thread-block cluster: every
block's scores and row maxima first, the prefix maxima in kv order, each
block's p, pq, sum p and integer PV on its own, then the float combine
acc = acc corr + pvf, l = l corr + sum p in kv order, kv blocks with no
admitted (query, key) pair in the tile skipped.  `_kernel_model` runs
that order in plain torch (the within-block sums as `attn_reference`
takes them) and is held bit for bit to `attn_reference`, and to the JAX
package's within one probability level; `attn_cluster_plan` (its
shared-memory model and launch cut) and `fused_route` are checked here
too.  The kernel itself runs only on
the card (tests/test_torch_gpu.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attn_gemm as J
from repro.kernels.ops import _lut_np, _subs_np
from repro_torch.core import approx_gemm as ag
from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.kernels import attn_gemm as T
from repro_torch.kernels import ops
from repro_torch.kernels.build import SMEM_BYTES
from repro_torch.kernels.ref import quantize_tile

B, H, SQ, SKV, D, BK = 2, 4, 21, 29, 12, 8        # 4 kv blocks of 8
# (path, family, compressor, n_approx_cols): each datapath, log twice
PATHS = [("lut", "appro42", "orplane", 10), ("log", "mitchell", "yang1", None),
         ("log", "log_our", "yang1", None), ("nibble", "exact", "yang1", None),
         ("mxu", "exact", "yang1", None)]
VARIANTS = ("causal", "window", "ragged", "decode")
# (B, H, KH, Sq, Skv, D, bk): chip_smoke.py's ATTN_MAIN (qwen3-1.7b's
# decode round and prefill) and ATTN_SMALL, and its long ragged decode
ATTN_MAIN = [(4, 16, 8, 1, 320, 128, 128), (4, 16, 8, 256, 256, 128, 128)]
ATTN_SMALL = [(2, 4, 2, 21, 29, 12, 16), (2, 4, 2, 1, 29, 12, 16)]
ATTN_LONG = [(4, 16, 8, 1, 2048, 128, 128)]
# (path, compensated) of the kernel's instantiations
KINDS = [("lut", False), ("log", False), ("log", True), ("nibble", False),
         ("mxu", False)]
ENTRY = {"lut": "cuda_attn_lut", "log": "cuda_attn_log",
         "nibble": "cuda_attn_nibble", "mxu": "cuda_attn_mxu"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's small torch ops, restored
    after it (beside the other test workers, torch's default pool waits
    on cores those workers hold)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _case(path, fam, comp, nac, variant, kh, seed):
    """Inputs of one case (made with numpy), the plain version's keywords
    and the multiplier spec."""
    sq = 1 if variant == "decode" else SQ
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, sq, D)).astype(np.float32)
    k = rng.standard_normal((B, kh, SKV, D)).astype(np.float32)
    v = rng.standard_normal((B, kh, SKV, D)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(SKV - sq, SKV, dtype=np.int32),
                           (B, sq)).copy()
    kpos = np.broadcast_to(np.arange(SKV, dtype=np.int32), (B, SKV)).copy()
    kval = np.ones((B, SKV), np.int32)
    window = 5 if variant == "window" else None
    if variant == "ragged":
        kval = (kpos < np.asarray([[17], [SKV]])).astype(np.int32)
    elif variant == "decode":
        kval = (kpos < np.asarray([[23], [SKV]])).astype(np.int32)
    qkv = [torch.from_numpy(a) for a in (q, k, v)]
    sc = T.attn_scales(*qkv, 8)
    spec = MultiplierSpec(fam, 8, True, comp, nac)
    table = (ops._attn_table(path, spec, "cpu")
             if path in ("lut", "nibble") else None)
    ins = [*qkv, *sc] + [torch.from_numpy(a) for a in (qpos, kpos, kval)]
    kw = dict(path=path, bits=8, causal=True, window=window,
              compensated=fam == "log_our", block=(8, BK))
    return ins, table, kw


def _model_every_split(ins, table, kw, bq, scores=None):
    """The model at every split of 1..8 (past the 4 kv blocks too), each
    in one chunk and in chunks of one block a rank; all must agree.
    `scores`: the PV mode's, Phase A a load of these stored scores."""
    nk = -(-SKV // BK)
    memo, outs = {}, []
    for splits in range(1, 9):
        for per in sorted({-(-nk // splits), 1}):
            outs.append(((splits, per), _kernel_model(
                *ins, table, **kw, bq=bq, splits=splits, per=per,
                memo=memo, scores=scores)))
    assert len(memo) == nk + 1        # every block's Phase B reused
    return outs


def _kernel_model(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval, table, *,
                  path, bits, causal, window, compensated, block, bq,
                  splits, per, memo=None, scores=None):
    """The cluster kernel's evaluation order in plain torch.

    A query tile is bq rows of every head of a kv head; its nk kv blocks
    of bk run as chunks of splits x per blocks, rank r taking blocks
    [chunk splits per + r per, + per) (ranks past nk empty).  Phase A:
    every block's masked scores (attn_gemm._score_step) and row maxima,
    NEG_INF where the tile has no admitted pair (decided from the
    positions).  Then, per chunk, the ranks in reverse (their blocks are
    independent once the prefix maxima are known): the prefix max
    (torch.maximum in kv order from the running max), then per block
    corr, p, sum p, pq and the integer PV (attn_gemm._online_step's
    expressions).  Phase C: acc = acc corr + pvf and l = l corr + sum p
    in kv order (rank, then block), a dead block leaving a tile's rows
    as they were.  The sums over a block's keys are attn_reference's.
    `memo` (a dict kept across calls on the same inputs) reuses a block's
    Phase A and, where its prefix maxima are bitwise those of the call
    that filled it, its Phase B.  With `scores` (B, H, Sq, Skvp) given,
    the order of the kernel's PV mode: Phase A takes a block's tile from
    those stored scores instead of computing it (its row maxima as
    before; a dead block's tile is discarded by the liveness, unread)."""
    memo = {} if memo is None else memo
    bk = block[1]
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    group = h // kh
    kf, vf, skb, svb, kp, kv, skvp = T._kv_side(k, v, sk_s, sv_s, kpos,
                                                kval, group, bk)
    qf = q.to(torch.float32)
    sqb = sq_s.to(torch.float32)[:, :, None, None]
    qp = qpos.to(torch.int32)
    nk = skvp // bk
    qm = (1 << (bits - 1)) - 1
    qmf = T._f32(qm, qf)
    neg = T._f32(T.NEG_INF, qf)
    vi = quantize_tile(vf, svb, qm)
    vscale = svb / qmf
    tile_of = torch.arange(sq) // bq          # each row's query tile

    # Phase A
    if "A" in memo:
        mask, s, rmax, live = memo["A"]
    else:
        mask, s, rmax, live = memo.setdefault("A", ([], [], [], []))
    for kb in range(len(s), nk):
        sl = slice(kb * bk, (kb + 1) * bk)
        m = T._mask4(qp, kp[:, sl], kv[:, sl], causal, window)  # (B,1,Sq,bk)
        pad = -(-sq // bq) * bq - sq
        tiles = torch.nn.functional.pad(m[:, 0].any(dim=-1), (0, pad))
        tiles = tiles.reshape(b, -1, bq).any(dim=-1)             # (B, tiles)
        rows_live = tiles[:, tile_of][:, None, :, None]          # (B,1,Sq,1)
        sc = (T._score_step(qf, kf[:, :, sl], sqb, skb, m, table,
                            path=path, bits=bits, compensated=compensated,
                            sm_scale=T._sm_scale(d))
              if scores is None else scores[..., sl])
        mask.append(m)
        s.append(sc)
        rmax.append(torch.where(rows_live, sc.amax(dim=-1, keepdim=True),
                                neg))
        live.append(rows_live)

    span = splits * per
    mrun = torch.full((b, h, sq, 1), T.NEG_INF, dtype=torch.float32)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32)
    lsum = torch.zeros((b, h, sq, 1), dtype=torch.float32)
    for base in range(0, nk, span):
        ranks = [[kb for kb in range(base + r * per, base + (r + 1) * per)
                  if kb < nk] for r in range(splits)]
        out = {}
        for r in reversed(range(splits)):
            m = mrun
            for kb in (x for rr in ranks[:r] for x in rr):
                m = torch.maximum(m, rmax[kb])
            for kb in ranks[r]:
                m_new = torch.maximum(m, rmax[kb])
                seen = memo.get(kb)
                if seen is not None and torch.equal(seen[0], m) and \
                        torch.equal(seen[1], m_new):
                    out[kb] = seen[2]
                else:
                    corr = torch.exp(m - m_new)
                    p = torch.where(mask[kb], torch.exp(s[kb] - m_new),
                                    T._f32(0.0, qf))
                    pq = torch.round(p * qmf).to(torch.int32)
                    pv = T._int_dot(pq, vi[:, :, kb * bk:(kb + 1) * bk],
                                    table, path=path, bits=bits,
                                    compensated=compensated)
                    out[kb] = (corr, p.sum(dim=-1, keepdim=True),
                               pv.to(torch.float32) * vscale)
                    memo[kb] = (m, m_new, out[kb])
                m = m_new
        for kb in (x for rr in ranks for x in rr):     # Phase C
            corr, psum, pvf = out[kb]
            acc = torch.where(live[kb], acc * corr + pvf, acc)
            lsum = torch.where(live[kb], lsum * corr + psum, lsum)
            mrun = torch.maximum(mrun, rmax[kb])
    return acc / torch.clamp_min(lsum, T._EPS_L)


@pytest.mark.parametrize("kh", [4, 2, 1], ids=lambda g: f"group{4 // g}")
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("path,fam,comp,nac", PATHS, ids=lambda p: str(p))
def test_kernel_order_is_bitwise_the_reference(path, fam, comp, nac,
                                               variant, kh):
    """The model at every split equals attn_reference bit for bit."""
    ins, table, kw = _case(path, fam, comp, nac, variant, kh, seed=11 + kh)
    want = T.attn_reference(*ins, table, **kw)
    for cut, got in _model_every_split(ins, table, kw,
                                       1 if variant == "decode" else 4):
        assert torch.equal(got, want), cut


@pytest.mark.parametrize("path,fam,comp,nac,variant",
                         [p + (v,) for p, v in zip(PATHS, VARIANTS + (
                             "causal",))], ids=lambda p: str(p))
def test_kernel_order_against_jax(path, fam, comp, nac, variant):
    """The model at every split against the JAX package's attn_reference:
    within one probability level of max|v| (XLA's exp and sums round
    otherwise than torch's on the CPU, which can move a pq level; the
    bound tests/test_torch_attn.py holds the plain version to)."""
    ins, table, kw = _case(path, fam, comp, nac, variant, 2, seed=5)
    jt = None
    if path == "lut":
        jt = jnp.asarray(_lut_np(fam, 8, comp, nac))
    elif path == "nibble":
        jt = jnp.asarray(_subs_np(fam, 8, comp, nac))
    want = np.asarray(J.attn_reference(*[jnp.asarray(t.numpy()) for t in ins],
                                       jt, **kw))
    tol = float(ins[2].abs().max()) / 127
    for cut, got in _model_every_split(ins, table, kw,
                                       1 if variant == "decode" else 4):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol,
                                   err_msg=str(cut))


def _capacity(smem, splits):
    """A faked device: 132 SMs in clusters of `splits`, as many 256-thread
    blocks an SM as its 228 KiB of shared memory hold (at most 8)."""
    if smem > SMEM_BYTES:
        return 0
    return (132 // splits) * min(8, 233_472 // smem)


def _assert_valid(plan, geom, path, comp, bits=8, mode="fused"):
    b, h, kh, sq, skv, d, bk = geom
    nk = -(-skv // bk)
    lone = mode == "scores"           # lone blocks on the grid, no cluster
    assert 1 <= plan.splits <= (T.MAX_SCORE_SPLITS if lone else
                                T.MAX_SPLITS)
    assert 1 <= plan.per and (plan.splits - 1) * plan.per < nk
    assert plan.chunks == -(-nk // (plan.splits * plan.per))
    assert plan.chunks == 1 or plan.per == -(-nk // plan.splits) or \
        plan.per < -(-nk // plan.splits)
    assert 1 <= plan.bq <= max(sq, 1) and plan.bq in {
        min(c, sq) for c in T.QUERY_ROWS}
    assert plan.rk in T.RING_KEYS and T.padded_block(bk) % plan.rk == 0
    assert plan.smem == T.attn_cluster_smem(path, bits, h // kh, plan.bq,
                                            plan.per, bk, d, plan.rk, comp,
                                            mode)
    assert plan.smem <= SMEM_BYTES
    assert plan.tiles == b * kh * -(-sq // plan.bq)
    if lone:
        assert plan.waves == -(-plan.tiles * plan.splits //
                               _capacity(plan.smem, 1))
    else:
        assert plan.waves == -(-plan.tiles //
                               _capacity(plan.smem, plan.splits))


@pytest.mark.parametrize("path,comp", KINDS, ids=str)
def test_plan_at_the_served_geometries(path, comp):
    for geom in ATTN_MAIN + ATTN_SMALL + ATTN_LONG:
        plan = T.attn_cluster_plan(*geom[:6], path, 8, _capacity,
                                   bk=geom[6], compensated=comp)
        _assert_valid(plan, geom, path, comp)
    # one decode round of 4 slots at 320: 3 kv blocks, one a rank, one wave
    plan = T.attn_cluster_plan(*ATTN_MAIN[0][:6], path, 8, _capacity,
                               bk=128, compensated=comp)
    assert (plan.bq, plan.splits, plan.per, plan.chunks) == (1, 3, 1, 1)


@pytest.mark.parametrize("path,comp", KINDS, ids=str)
def test_plan_fits_every_geometry_the_gate_admits(path, comp):
    """Every (bk, head dim) that core/approx_gemm._attn_kernel_fits admits
    at 8 bits (d in 12, 64, 128, 256; bk 8..128) has a plan that fits,
    at a long prefill and at a long decode (ranges in chunks where one
    does not fit)."""
    admitted = 0
    for d in (12, 64, 128, 256):
        for bk in range(8, 129):
            if not ag._attn_kernel_fits(ENTRY[path], 8, (32, bk), d):
                continue
            admitted += 1
            for geom in ((2, 8, 2, 300, 3000, d, bk), (2, 8, 2, 1, 9000, d,
                                                       bk)):
                plan = T.attn_cluster_plan(*geom[:6], path, 8, _capacity,
                                           bk=bk, compensated=comp)
                _assert_valid(plan, geom, path, comp)
    assert admitted >= 3 * 121


def test_forced_splits_and_refusals():
    geom = ATTN_LONG[0]
    for splits in range(1, 9):
        plan = T.attn_cluster_plan(*geom[:6], "lut", 8, _capacity, bk=128,
                                   splits=splits)
        assert plan.splits == splits
        _assert_valid(plan, geom, "lut", False)
    with pytest.raises(ValueError, match="empty"):   # 3 kv blocks
        T.attn_cluster_plan(*ATTN_MAIN[0][:6], "lut", 8, _capacity, bk=128,
                            splits=4)
    with pytest.raises(ValueError, match="no block"):
        T.attn_cluster_plan(*ATTN_MAIN[0][:6], "lut", 8, lambda *a: 0,
                            bk=128)


def test_forced_query_tile_and_ring_tile():
    """bq and rk forced (launch/cluster_sweep.py times every pair) keep
    the rest of the plan valid; a pair that fits no block is refused."""
    geom = ATTN_MAIN[1]
    fits = 0
    for bq in T.QUERY_ROWS:
        for rk in T.RING_KEYS:
            try:
                plan = T.attn_cluster_plan(*geom[:6], "lut", 8, _capacity,
                                           bk=128, causal=True, bq=bq, rk=rk)
            except ValueError:
                continue
            fits += 1
            assert (plan.bq, plan.rk) == (bq, rk)
            _assert_valid(plan, geom, "lut", False)
    # the 128 KiB table leaves query tiles of 1..16 rows, the larger of
    # them the smaller ring tiles
    assert fits == 17
    for bq, rk in ((32, 4), (1, 64), (1, 3)):
        with pytest.raises(ValueError, match="no block"):
            T.attn_cluster_plan(*geom[:6], "lut", 8, _capacity, bk=128,
                                bq=bq, rk=rk)


def test_route_sends_wide_log_operands_to_the_template():
    for bits in range(9, 13):
        assert T.fused_route("log", bits) == "template"
    for path in T.ATTN_PATHS:
        for bits in range(2, 9):
            assert T.fused_route(path, bits) == "cluster"
    for path, bits in (("log", 13), ("lut", 9), ("mxu", 1)):
        with pytest.raises(ValueError):
            T.fused_route(path, bits)



@pytest.mark.parametrize("bits", range(1, 14))
@pytest.mark.parametrize("path", T.ATTN_PATHS)
def test_materialized_route_mirrors_the_fused_route(path, bits):
    """The oracle's two stages take the fused form's design at every
    width: the cluster kernel up to 8 bits, the template for 9..12-bit
    log operands, a refusal past each path's widths."""
    try:
        want = T.fused_route(path, bits)
    except ValueError:
        with pytest.raises(ValueError):
            T.materialized_route(path, bits)
        return
    assert T.materialized_route(path, bits) == want
    assert T._route_of(None, path, bits) == want
    # the template pair, the cluster kernel's witness, at any width it
    # takes; the cluster kernel only up to 8 bits; a plan only to it
    assert T._route_of("template", path, bits) == "template"
    if want == "cluster":
        assert T._route_of("cluster", path, bits, {"splits": 1}) == "cluster"
    else:
        with pytest.raises(ValueError, match="at most 8-bit"):
            T._route_of("cluster", path, bits)
    with pytest.raises(ValueError, match="forced plan"):
        T._route_of("template", path, bits, {"splits": 1})
    with pytest.raises(ValueError, match="route"):
        T._route_of("plain", path, bits)


def test_forced_routes_are_refused_on_either_device():
    """A forced route or plan the kernels do not take raises before any
    kernel or plain version runs, on the CPU as on the card."""
    ins, table, kw = _case("log", "log_our", "yang1", None, "causal", 2, 3)
    q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval = ins
    wide = dict(kw, bits=12)
    with pytest.raises(ValueError, match="at most 8-bit"):
        T._attn_scores_forced(q, k, sq_s, sk_s, qpos, kpos, kval, table,
                              route="cluster", **wide)
    scores = T.attn_scores(q, k, sq_s, sk_s, qpos, kpos, kval, table, **kw)
    with pytest.raises(ValueError, match="forced plan"):
        T._attn_pv_forced(scores, v, sv_s, qpos, kpos, kval, table,
                          route="template", force={"splits": 2}, **kw)
    with pytest.raises(ValueError, match="forced plan"):
        T._attn_materialized_forced(*ins, table, force={"splits": 2},
                                    **wide)
    # on the CPU every route is the plain version, bit for bit
    want = T.attn_materialized(*ins, table, **kw)
    for route in ("template", "cluster"):
        assert torch.equal(T._attn_materialized_forced(
            *ins, table, route=route, **kw), want)


ORACLE_MODES = ("scores", "pv")


@pytest.mark.parametrize("mode", ORACLE_MODES)
@pytest.mark.parametrize("path,comp", KINDS, ids=str)
def test_oracle_plans_at_the_served_geometries(path, comp, mode):
    """The oracle's modes plan every served geometry within their limits:
    the decode round spreads its 3 kv blocks one a block (PV: a cluster
    of 3, as the fused form), the long decode's 16 blocks the scores mode
    over 16 lone blocks a tile where that is no more waves; a mode's block
    needs no more shared memory than the fused form's at its plan."""
    for geom in ATTN_MAIN + ATTN_SMALL + ATTN_LONG:
        plan = T.attn_cluster_plan(*geom[:6], path, 8, _capacity,
                                   bk=geom[6], compensated=comp, mode=mode)
        _assert_valid(plan, geom, path, comp, mode=mode)
        group = geom[1] // geom[2]
        assert plan.smem <= T.attn_cluster_smem(
            path, 8, group, plan.bq, plan.per, geom[6], geom[5], plan.rk,
            comp, "fused")
    plan = T.attn_cluster_plan(*ATTN_MAIN[0][:6], path, 8, _capacity,
                               bk=128, compensated=comp, mode=mode)
    assert (plan.bq, plan.splits, plan.per, plan.chunks) == (1, 3, 1, 1)


@pytest.mark.parametrize("mode", ORACLE_MODES)
@pytest.mark.parametrize("path,comp", KINDS, ids=str)
def test_oracle_plans_fit_every_geometry_the_gate_admits(path, comp, mode):
    """As test_plan_fits_every_geometry_the_gate_admits, for the scores
    and PV modes: every (bk, head dim) core/approx_gemm._attn_kernel_fits
    admits at 8 bits has a plan of each that fits its shared memory, at a
    long prefill and a long decode."""
    admitted = 0
    for d in (12, 64, 128, 256):
        for bk in range(8, 129):
            if not ag._attn_kernel_fits(ENTRY[path], 8, (32, bk), d):
                continue
            admitted += 1
            for geom in ((2, 8, 2, 300, 3000, d, bk), (2, 8, 2, 1, 9000, d,
                                                       bk)):
                plan = T.attn_cluster_plan(*geom[:6], path, 8, _capacity,
                                           bk=bk, compensated=comp,
                                           mode=mode)
                _assert_valid(plan, geom, path, comp, mode=mode)
    assert admitted >= 3 * 121


def test_oracle_forced_plans_and_refusals():
    """The scores mode takes any split of the kv blocks up to
    MAX_SCORE_SPLITS (no cluster), the PV mode up to a cluster's
    MAX_SPLITS; a split either does not take, a range left empty, an
    unknown mode or a capacity of none is refused."""
    geom = ATTN_LONG[0]                       # 16 kv blocks
    for splits in range(1, 17):
        plan = T.attn_cluster_plan(*geom[:6], "lut", 8, _capacity, bk=128,
                                   splits=splits, mode="scores")
        assert plan.splits == splits
        _assert_valid(plan, geom, "lut", False, mode="scores")
    for splits in range(1, 9):
        plan = T.attn_cluster_plan(*geom[:6], "lut", 8, _capacity, bk=128,
                                   splits=splits, mode="pv")
        _assert_valid(plan, geom, "lut", False, mode="pv")
    for mode, splits in (("pv", 9), ("scores", 17), ("scores", 65)):
        with pytest.raises(ValueError, match="empty"):
            T.attn_cluster_plan(*geom[:6], "lut", 8, _capacity, bk=128,
                                splits=splits, mode=mode)
    with pytest.raises(ValueError, match="no block"):
        T.attn_cluster_plan(*geom[:6], "lut", 8, lambda *a: 0, bk=128,
                            mode="scores")
    with pytest.raises(ValueError, match="mode"):
        T.attn_cluster_plan(*geom[:6], "lut", 8, _capacity, bk=128,
                            mode="materialized")
    with pytest.raises(ValueError, match="mode"):
        T.attn_cluster_smem("lut", 8, 2, 1, 1, 128, 128, 16, False, "both")


@pytest.mark.parametrize("path,comp", KINDS, ids=str)
def test_oracle_modes_share_the_fused_layout(path, comp):
    """A mode's shared memory is the fused form's without the regions it
    does not use: the scores mode has no V side, softmax state or
    accumulator and one block's stage, the PV mode no K side or q; so
    the scores mode's total does not grow with the blocks a chunk (but
    their positions), and neither mode's passes the fused form's."""
    for geom in ATTN_MAIN + ATTN_SMALL + ATTN_LONG:
        _, h, kh, _, _, d, bk = geom
        for bq, per, rk in ((1, 1, 16), (4, 3, 8), (16, 2, 4)):
            size = {m: T.attn_cluster_smem(path, 8, h // kh, bq, per, bk, d,
                                           rk, comp, m)
                    for m in T.CLUSTER_MODES}
            assert size["scores"] < size["fused"]
            assert size["pv"] < size["fused"]
            grown = T.attn_cluster_smem(path, 8, h // kh, bq, per + 1, bk,
                                        d, rk, comp, "scores")
            pos = 2 * T.padded_block(bk) * 4 + 8    # kpos, kval, live, lidx
            assert size["scores"] <= grown <= size["scores"] + pos + 48


def _poison_dead(scores, qpos, kpos, kval, *, bq, bk, causal, window):
    """The stored scores with every kv block no (query, key) pair of a
    query tile of `bq` rows admits set to NaN in that tile's rows: the PV
    mode skips such a block unread, so the result must not move."""
    s = scores.clone()
    sq, skvp = s.shape[2], s.shape[3]
    pad = skvp - kpos.shape[1]
    kp = torch.nn.functional.pad(kpos.to(torch.int32), (0, pad))
    kv = torch.nn.functional.pad(kval.to(torch.int32), (0, pad))
    dead = 0
    for k0 in range(0, skvp, bk):
        m = T._mask4(qpos.to(torch.int32), kp[:, k0:k0 + bk],
                     kv[:, k0:k0 + bk], causal, window)[:, 0]
        for t0 in range(0, sq, bq):
            for bi in range(s.shape[0]):
                if not m[bi, t0:t0 + bq].any():
                    s[bi, :, t0:t0 + bq, k0:k0 + bk] = float("nan")
                    dead += 1
    return s, dead


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("path,fam,comp,nac", PATHS, ids=lambda p: str(p))
def test_pv_mode_order_is_bitwise_the_kernel_order(path, fam, comp, nac,
                                                   variant):
    """The PV mode's order (the stored scores of attn_scores_plain, each
    row's max a kv block from the stored tile, dead blocks skipped by
    position and never read: poisoned with NaN here, the in-order
    combine) equals the fused order model bit for bit at every split, so
    attn_reference too; and the scores of a dead block are all NEG_INF,
    so the scores mode writes them without a product."""
    ins, table, kw = _case(path, fam, comp, nac, variant, 2, seed=13)
    q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval = ins
    bq = 1 if variant == "decode" else 4
    scores = T.attn_scores_plain(q, k, sq_s, sk_s, qpos, kpos, kval, table,
                                 **kw)
    poisoned, dead = _poison_dead(scores, qpos, kpos, kval, bq=bq, bk=BK,
                                  causal=True, window=kw["window"])
    assert dead > 0                   # every variant has a dead block
    nan = torch.isnan(poisoned)
    assert (scores[nan] == T.NEG_INF).all()
    want = T.attn_reference(*ins, table, **kw)
    fused = _model_every_split(ins, table, kw, bq)
    for (cut, got), (_, ref) in zip(
            _model_every_split(ins, table, kw, bq, scores=poisoned), fused):
        assert torch.equal(got, ref), cut
        assert torch.equal(got, want), cut
    assert torch.equal(T.attn_pv_plain(scores, v, sv_s, qpos, kpos, kval,
                                       table, **kw), want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_pv_mode_order_against_jax_materialized(variant):
    """The PV mode's order over attn_scores_plain's scores against the
    JAX package's attn_materialized (its Pallas _scores_kernel and
    _pv_kernel in interpret mode), within one probability level of
    max|v| (the bound test_kernel_order_against_jax holds: XLA's exp and
    sums round otherwise than torch's on the CPU)."""
    path, fam, comp, nac = PATHS[0]
    ins, table, kw = _case(path, fam, comp, nac, variant, 2, seed=21)
    q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval = ins
    bq = 1 if variant == "decode" else 4
    scores = T.attn_scores_plain(q, k, sq_s, sk_s, qpos, kpos, kval, table,
                                 **kw)
    poisoned, _ = _poison_dead(scores, qpos, kpos, kval, bq=bq, bk=BK,
                               causal=True, window=kw["window"])
    jt = jnp.asarray(_lut_np(fam, 8, comp, nac))
    want = np.asarray(J.attn_materialized(
        *[jnp.asarray(t.numpy()) for t in ins], jt, **kw))
    tol = float(v.abs().max()) / 127
    for cut, got in _model_every_split(ins, table, kw, bq, scores=poisoned):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol,
                                   err_msg=str(cut))


def test_plan_counts_the_blocks_a_causal_mask_leaves():
    """At qwen3's prefill (2 kv blocks of 128, tiles of 8 queries) a
    causal tile's first half needs one block: one rank holding both
    computes 1.5 a tile on average, either rank of a split pair one; a
    decode row needs every block of its range."""
    assert T._blocks_a_tile(2, 128, 256, 256, 8, 1, 2, True) == 1.5
    assert T._blocks_a_tile(2, 128, 256, 256, 8, 2, 1, True) == 1.0
    assert T._blocks_a_tile(2, 128, 256, 256, 8, 1, 2, False) == 2.0
    assert T._blocks_a_tile(16, 128, 1, 2048, 1, 5, 3, True) == 4.0
