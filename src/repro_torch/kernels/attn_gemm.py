"""Flash-style attention through the approximate CiM datapath: CUDA
kernels for Hopper and their plain versions.

Both inner products of self-attention, QK^T and PV, run through the
same integer machinery as the GEMM kernels (the full-LUT gather, the
nibble sub-LUTs, the log-domain product, or an exact integer dot), under
online-softmax tiling along the kv axis:

  * ``attn_fused``        — one pass: per kv block, quantize q/k against
    per-(batch, head) scales, integer QK^T, dequantize and scale by
    1/sqrt(D), mask, online-softmax update, quantize the probability
    tile at the fixed scale 1/qmax, integer PV against the quantized V
    tile, and finally ``acc / max(l, 1e-30)``.  Only (B, H, Sq, D)
    leaves the kernel.
  * ``attn_materialized`` — the oracle: two kernels (``attn_scores``,
    ``attn_pv``) with the masked (B, H, Sq, Skvp) score tensor written to
    device memory between them.  Integer sums are exact and every float
    expression runs in the same order, so fused == materialized bit for
    bit.

Masking is unified as in the reference: qpos (B, Sq), kpos and kval
(B, Skv) int32, and ``kval != 0 & (causal -> kpos <= qpos) & (window ->
kpos > qpos - window)``; the probability tile is masked too, so a fully
masked row gives 0, not a resurrected exp(0).

On CUDA tensors each entry point launches its kernels
(csrc/attn_gemm.cu) or raises; on CPU tensors it runs the plain version
below, which repeats the kernels' arithmetic with torch ops (the twin of
the reference's ``attn_reference`` and its two-stage oracle).  The fused
form of operands of at most 8 bits runs the cluster kernel of
csrc/attn_cluster.cuh (``fused_route``), cut by ``attn_cluster_plan``:
a block holds every q head of one kv head over a tile of query rows, and
a thread-block cluster splits the tile's kv blocks.  The oracle's two
stages run the same kernel's other modes (``materialized_route``): the
scores mode is its Phase A with a store (the kv blocks spread over the
grid), the PV mode its Phases B and C after a load of the stored scores,
so the two forms differ only in the score tensor's round trip.  The
template of csrc/attn_gemm.cu (``*_wide``) takes the log path's 9..12-bit
operands, and its oracle pair stays callable at 8 bits as the cluster
kernel's independent witness (``_attn_materialized_forced(...,
route="template")``).  The
scales are per-(batch, q-head) for Q and per-(batch, kv-head) for K/V
(``attn_scales``), so GQA head expansion and per-head tier composition
are exact.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import torch

from .approx_matmul import check_subs, check_table
from .build import (INT, PTR, SMEM_BYTES, CudaKernel, on_cuda, query,
                    require, stream_of)
from .ref import k_chunk, log_product, nibble_sum, quantize_tile

NEG_INF = -1e30          # finite stand-in for -inf: exp() underflows to 0
_EPS_L = 1e-30           # normalizer floor for fully masked rows

ATTN_PATHS = ("mxu", "lut", "nibble", "log")
_PATH_ID = {p: i for i, p in enumerate(ATTN_PATHS)}

# query rows per block of the template kernels (bq is free on Hopper: the
# result of a row does not depend on the rows beside it); the launch
# uses min(ATTN_BQ, Sq)
ATTN_BQ = 32

# the template's entries: q, k, v, the scales, the positions, the table,
# out and scores, then 14 ints and the stream
_ARGS = [PTR] * 12 + [INT] * 14 + [PTR]
# the cluster kernel's entries, one a mode: the same tensors, then 17 ints
# (its plan bq, splits, per, rk among them) and the stream
_CLUSTER_ARGS = [PTR] * 12 + [INT] * 17 + [PTR]
_FUSED = CudaKernel("attn_gemm", "attn_fused", _CLUSTER_ARGS)
_SCORES = CudaKernel("attn_gemm", "attn_scores", _CLUSTER_ARGS)
_PV = CudaKernel("attn_gemm", "attn_pv", _CLUSTER_ARGS)
_FUSED_WIDE = CudaKernel("attn_gemm", "attn_fused_wide", _ARGS)
_SCORES_WIDE = CudaKernel("attn_gemm", "attn_scores_wide", _ARGS)
_PV_WIDE = CudaKernel("attn_gemm", "attn_pv_wide", _ARGS)

# the kernels of this module by wrapper name (chip_smoke.py reads and
# resets their launch counts): the cluster kernel's three modes, the fused
# form and the oracle's two stages (`attn_materialized`), up to 8 bits;
# the template's three (`*_wide`) for the log path's 9..12-bit operands
# (fused_route, materialized_route), on no served path, its oracle pair
# also at 8 bits where chip_smoke.py or a test forces it as the cluster
# kernel's independent witness
KERNELS = {"attn_fused": _FUSED, "attn_scores": _SCORES, "attn_pv": _PV,
           "attn_fused_wide": _FUSED_WIDE, "attn_scores_wide": _SCORES_WIDE,
           "attn_pv_wide": _PV_WIDE}
_CLUSTER_KERNELS = {"fused": _FUSED, "scores": _SCORES, "pv": _PV}

# the widest operands the cluster kernel stages (csrc/attn_cluster.cuh
# AC_MAX_BITS: a log operand as signed bytes)
CLUSTER_MAX_BITS = 8


def _sm_scale(head_dim: int) -> float:
    """The single home of the softmax scale."""
    return 1.0 / math.sqrt(head_dim)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 tensor on `like`'s device: every constant of the
    float arithmetic is a device tensor (on CUDA, PyTorch turns a
    division by a host scalar into a reciprocal multiply)."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# batch-generic integer dots: a (..., M, K), b (..., K, N) int32 ->
# int32 (..., M, N).  Integer sums are exact, so any slicing of K gives
# the same result; K is sliced to bound the live (..., M, ks, N)
# temporaries.
# ---------------------------------------------------------------------------


def _k_step(a: torch.Tensor, b: torch.Tensor) -> int:
    rows = a.numel() // a.shape[-1]
    return k_chunk(rows, a.shape[-1], b.shape[-1])


def _dot_mxu(a, b):
    """Exact integer dot.  The reference sums in f32, exact iff every
    partial sum is f32-representable (qmax^2 * K < 2^24, the planner's
    bit-safety gate); f64 is exact under that gate on both devices."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def _dot_lut(table, a, b, bits):
    """Full-LUT gather: each scalar pair indexes the 2^{2b} table."""
    half = 1 << (bits - 1)
    n = 1 << bits
    ia = (a + half).to(torch.int64)
    ib = (b + half).to(torch.int64)
    kk = a.shape[-1]
    step = _k_step(a, b)
    acc = None
    for s in range(0, kk, step):
        idx = ia[..., :, s:s + step, None] * n + ib[..., None, s:s + step, :]
        part = table[idx].sum(dim=-2, dtype=torch.int32)
        acc = part if acc is None else acc + part
    return acc


def _dot_nibble(table, a, b, bits):
    """Nibble sub-LUT gather: sign-magnitude half-word decomposition."""
    return nibble_sum(table, a, b, bits)


def _dot_log(a, b, bits, compensated):
    """Log-domain (Mitchell / Log-our) product-sum, no table."""
    kk = a.shape[-1]
    step = _k_step(a, b)
    acc = None
    for s in range(0, kk, step):
        prods = log_product(a[..., :, s:s + step, None],
                            b[..., None, s:s + step, :], bits, compensated)
        part = prods.sum(dim=-2, dtype=torch.int32)
        acc = part if acc is None else acc + part
    return acc


def _int_dot(a, b, table, *, path, bits, compensated):
    if path == "mxu":
        return _dot_mxu(a, b)
    if path == "lut":
        return _dot_lut(table, a, b, bits)
    if path == "nibble":
        return _dot_nibble(table, a, b, bits)
    if path == "log":
        return _dot_log(a, b, bits, compensated)
    raise ValueError(f"unknown attention datapath {path!r}; "
                     f"expected one of {ATTN_PATHS}")


# ---------------------------------------------------------------------------
# masking (the kernels' per-tile form is csrc/attn_gemm.cu's `valid`)
# ---------------------------------------------------------------------------


def _mask4(qp, kp, kv, causal, window):
    """(B, Sq) x (B, Skv) positions -> (B, 1, Sq, Skv) bool."""
    m = kv[:, None, None, :] != 0
    if causal:
        m = m & (kp[:, None, None, :] <= qp[:, None, :, None])
    if window is not None:
        m = m & (kp[:, None, None, :] > qp[:, None, :, None] - window)
    return m


# ---------------------------------------------------------------------------
# the score and online-softmax steps: the plain versions run THESE
# expressions, in this order, as the kernels' device functions do
# ---------------------------------------------------------------------------


def _score_step(q, k, sq_s, sk_s, mask, table, *, path, bits, compensated,
                sm_scale):
    """Quantize q/k, integer QK^T, dequantize + softmax scale, mask."""
    qm = (1 << (bits - 1)) - 1
    qi = quantize_tile(q, sq_s, qm)
    ki = quantize_tile(k, sk_s, qm)
    qk = _int_dot(qi, ki.transpose(-1, -2), table, path=path, bits=bits,
                  compensated=compensated)
    s = qk.to(torch.float32) * ((sq_s * sk_s) * _f32(sm_scale, q))
    return torch.where(mask, s, _f32(NEG_INF, q))


def _online_step(s, mask, v, sv_s, m_prev, l_prev, acc_prev, table, *,
                 path, bits, compensated):
    """One online-softmax update against a masked score tile."""
    qm = (1 << (bits - 1)) - 1
    qmf = _f32(qm, s)
    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    corr = torch.exp(m_prev - m_new)
    # mask the PROBABILITY tile: on a fully masked row s == m_new ==
    # NEG_INF and exp(0) = 1 would be wrong
    p = torch.where(mask, torch.exp(s - m_new), _f32(0.0, s))
    l_new = l_prev * corr + p.sum(dim=-1, keepdim=True)
    pq = torch.round(p * qmf).to(torch.int32)
    vi = quantize_tile(v, sv_s, qm)
    pv = _int_dot(pq, vi, table, path=path, bits=bits,
                  compensated=compensated)
    acc_new = acc_prev * corr + pv.to(torch.float32) * (sv_s / qmf)
    return m_new, l_new, acc_new


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; chip_smoke.py also runs them on the card)
# ---------------------------------------------------------------------------


def _kv_side(k, v, sk_s, sv_s, kpos, kval, group, bk):
    """K/V widened to f32 and repeated to the q heads (their scales too,
    as (B, H, 1, 1)), the kv axis zero-padded to a bk multiple; padded
    keys are invalid."""
    skv = k.shape[2]
    skvp = -(-skv // bk) * bk
    pad = skvp - skv

    def rows(t):
        t = t.to(torch.float32).repeat_interleave(group, dim=1)
        return torch.nn.functional.pad(t, (0, 0, 0, pad))

    def scale(t):
        return t.to(torch.float32).repeat_interleave(group, dim=1)[
            :, :, None, None]

    kp = torch.nn.functional.pad(kpos.to(torch.int32), (0, pad))
    kv = torch.nn.functional.pad(kval.to(torch.int32), (0, pad))
    return rows(k), rows(v), scale(sk_s), scale(sv_s), kp, kv, skvp


def _pv_loop(scores_at, v, svb, qp, kp, kv, table, *, path, bits,
             causal, window, compensated, bk, skvp, shape):
    b, h, sq, d = shape
    dev = v.device
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    for s0 in range(0, skvp, bk):
        mask = _mask4(qp, kp[:, s0:s0 + bk], kv[:, s0:s0 + bk], causal,
                      window)
        m, l, acc = _online_step(scores_at(s0, mask), mask,
                                 v[:, :, s0:s0 + bk], svb, m, l, acc, table,
                                 path=path, bits=bits,
                                 compensated=compensated)
    return acc / torch.clamp_min(l, _EPS_L)


def attn_reference(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval,
                   table=None, *, path, bits=8, causal=True, window=None,
                   compensated=True, block=(32, 128)):
    """The plain version of the fused kernel: the kv loop tiles by the
    same ``bk`` through the same score and online steps (the twin of the
    reference's ``attn_reference``)."""
    bk = block[1]
    group = q.shape[1] // k.shape[1]
    kf, vf, skb, svb, kp, kv, skvp = _kv_side(k, v, sk_s, sv_s, kpos, kval,
                                              group, bk)
    qf = q.to(torch.float32)
    sqb = sq_s.to(torch.float32)[:, :, None, None]
    qp = qpos.to(torch.int32)
    sm = _sm_scale(q.shape[-1])

    def scores_at(s0, mask):
        return _score_step(qf, kf[:, :, s0:s0 + bk], sqb, skb, mask, table,
                           path=path, bits=bits, compensated=compensated,
                           sm_scale=sm)

    return _pv_loop(scores_at, vf, svb, qp, kp, kv, table, path=path,
                    bits=bits, causal=causal, window=window,
                    compensated=compensated, bk=bk, skvp=skvp,
                    shape=q.shape)


def attn_scores_plain(q, k, sq_s, sk_s, qpos, kpos, kval, table=None, *,
                      path, bits=8, causal=True, window=None,
                      compensated=True, block=(32, 128)):
    """Stage one of the oracle: the masked f32 (B, H, Sq, Skvp) scores,
    Skvp the kv length padded to a ``bk`` multiple (padded keys hold
    NEG_INF)."""
    bk = block[1]
    group = q.shape[1] // k.shape[1]
    kf, _, skb, _, kp, kv, skvp = _kv_side(k, k, sk_s, sk_s, kpos, kval,
                                           group, bk)
    qf = q.to(torch.float32)
    sqb = sq_s.to(torch.float32)[:, :, None, None]
    qp = qpos.to(torch.int32)
    sm = _sm_scale(q.shape[-1])
    tiles = []
    for s0 in range(0, skvp, bk):
        mask = _mask4(qp, kp[:, s0:s0 + bk], kv[:, s0:s0 + bk], causal,
                      window)
        tiles.append(_score_step(qf, kf[:, :, s0:s0 + bk], sqb, skb, mask,
                                 table, path=path, bits=bits,
                                 compensated=compensated, sm_scale=sm))
    return torch.cat(tiles, dim=-1)


def attn_pv_plain(scores, v, sv_s, qpos, kpos, kval, table=None, *,
                  path, bits=8, causal=True, window=None, compensated=True,
                  block=(32, 128)):
    """Stage two of the oracle: the online softmax and PV over the stored
    scores.  The mask is recomputed from the positions, not read from the
    NEG_INF scores (on a fully masked row they cannot tell "masked" from
    "valid but tiny")."""
    bk = block[1]
    b, h, sq, _ = scores.shape
    shape = (b, h, sq, v.shape[-1])
    _, vf, _, svb, kp, kv, skvp = _kv_side(v, v, sv_s, sv_s, kpos, kval,
                                           h // v.shape[1], bk)
    qp = qpos.to(torch.int32)
    return _pv_loop(lambda s0, mask: scores[..., s0:s0 + bk], vf, svb, qp,
                    kp, kv, table, path=path, bits=bits, causal=causal,
                    window=window, compensated=compensated, bk=bk,
                    skvp=skvp, shape=shape)


def attn_float(q, k, v, qpos, kpos, kval, *, causal=True, window=None):
    """Plain f32 masked softmax attention: the function the straight-
    through backward differentiates."""
    group = q.shape[1] // k.shape[1]
    qf = q.to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(group, dim=1)
    vf = v.to(torch.float32).repeat_interleave(group, dim=1)
    mask = _mask4(qpos.to(torch.int32), kpos.to(torch.int32),
                  kval.to(torch.int32), causal, window)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * _sm_scale(q.shape[-1])
    s = torch.where(mask, s, _f32(NEG_INF, s))
    p = torch.where(mask, torch.softmax(s, dim=-1), _f32(0.0, s))
    return torch.einsum("bhqk,bhkd->bhqd", p, vf)


def attn_scales(q, k, v, bits):
    """Per-(batch, head) quantization scales: q (B, H, Sq, D) -> (B, H);
    k/v (B, KH, Skv, D) -> (B, KH).  max|x| over the head's rows and
    lanes, floored at 1e-8, over qmax (divided by a device tensor)."""
    qm = (1 << (bits - 1)) - 1

    def one(x):
        m = torch.abs(x.to(torch.float32)).amax(dim=(2, 3))
        return torch.clamp_min(m, 1e-8) / torch.full_like(m, qm)

    return one(q), one(k), one(v)


# ---------------------------------------------------------------------------
# the CUDA kernels' shared-memory budget: the total of csrc/attn_gemm.cu's
# layout(), which the planner reads here; every launch passes it to the
# kernel, which refuses a total that differs from its own
# ---------------------------------------------------------------------------


def _al(n: int) -> int:
    return (n + 15) // 16 * 16


def _table_bytes(path: str, bits: int) -> int:
    if path == "lut":
        return (1 << (2 * bits)) * 2            # int16 full table
    if path == "nibble":
        return 4 * (1 << bits) * 4              # four int32 sub-tables
    return 0


def attn_smem_bytes(path: str, bits: int, bq: int, bk: int, d: int) -> int:
    """Dynamic shared memory of one block: the table, the f32
    accumulator and score tile, the row statistics, the kv positions,
    the int16 probability tile, and the quantized q/k/v tiles (int8, or
    int16 for the log path, which admits up to 12-bit operands)."""
    qt = 2 if path == "log" else 1
    return (_al(_table_bytes(path, bits)) + _al(4 * bq * d) + _al(4 * bq * bk)
            + 3 * _al(4 * bq) + 2 * _al(4 * bk) + _al(4 * bq)
            + _al(2 * bq * bk) + _al(qt * bq * d) + 2 * _al(qt * bk * d))


# ---------------------------------------------------------------------------
# the cluster kernel (csrc/attn_cluster.cuh): its route, its shared-memory
# model (ac_geometry's total) and its launch plan
# ---------------------------------------------------------------------------

_AC_STAGES = 4                 # the K/V ring's stages (AC_STAGES)
MAX_SPLITS = 8                 # the portable cluster size (AC_MAX_SPLITS)
# the scores mode spreads a tile's kv blocks over the grid, not a cluster
MAX_SCORE_SPLITS = 64          # (AC_MAX_SCORE_SPLITS)
# what one launch of the cluster kernel computes (csrc AC_FUSED,
# AC_SCORES, AC_PV): attn_fused; the oracle's scores (Phase A, stored);
# its PV (Phase A a load of the stored scores, then Phases B and C)
CLUSTER_MODES = ("fused", "scores", "pv")
_MODE_ID = {m: i for i, m in enumerate(CLUSTER_MODES)}
RING_KEYS = (64, 32, 16, 8, 4)  # keys a ring tile (the K/V ring's tiles)
QUERY_ROWS = (1, 2, 4, 8, 16, 32, 64)   # bq candidates
# The quantization of a kv block's K and V (2 bk D IEEE divisions) in
# rows' worth of its products (2 bk D a row): the plan's cost of a kv
# block is R + this, R = group bq.  About 20 instructions a division
# against a product's: a LUT gather and two adds, a log_our dp4a and
# compare, half a mitchell dp4a, a quarter of an mxu one, nibble's four
# gathers and split.
_QUANT_ROWS = {"lut": 6, "log_our": 6, "log": 24, "mxu": 48, "nibble": 2}
# A ring tile's wait (rk keys of K or V in flight from L2; about 2,000 SM
# clocks whatever rk, measured in the kernel at qwen3's prefill on an
# H100) in rows' worth of a kv block's products (about 2,200 clocks a LUT
# row, 800 a mitchell row)
_TILE_ROWS = {"lut": 1, "log_our": 1, "log": 2, "mxu": 4, "nibble": 0.5}


def fused_route(path: str, bits: int) -> str:
    """The kernel a fused attention of `bits`-bit operands launches on the
    card: "cluster" (csrc/attn_cluster.cuh) up to CLUSTER_MAX_BITS,
    "template" (csrc/attn_gemm.cu, entry attn_fused_wide) for the log
    path's 9..12-bit operands.  Every shape takes its bits' route."""
    max_bits = 12 if path == "log" else 8
    require(path in ATTN_PATHS and 2 <= bits <= max_bits,
            f"the {path} path takes 2..{max_bits}-bit operands, got {bits}")
    return "cluster" if bits <= CLUSTER_MAX_BITS else "template"


def materialized_route(path: str, bits: int) -> str:
    """The kernels the oracle's two stages (`attn_scores`, `attn_pv`) of
    `bits`-bit operands launch on the card: "cluster" (the cluster
    kernel's scores and PV modes) up to CLUSTER_MAX_BITS, "template" (the
    template's attn_scores_wide and attn_pv_wide) for the log path's
    9..12-bit operands.  It is fused_route's answer, so a call's fused
    and materialized forms run one design and differ only in the score
    tensor's round trip through device memory."""
    return fused_route(path, bits)


def _route_of(route: Optional[str], path: str, bits: int,
              force: Optional[dict] = None) -> str:
    """The oracle's route: materialized_route's, or a forced one
    ("template" at any bits: the cluster kernel's independent witness;
    "cluster" up to CLUSTER_MAX_BITS).  Only the cluster kernel takes a
    forced plan."""
    which = materialized_route(path, bits)
    if route is not None:
        require(route in ("cluster", "template"),
                f"route {route!r}: expected 'cluster' or 'template'")
        require(route == "template" or which == "cluster",
                f"the cluster kernel takes at most {CLUSTER_MAX_BITS}-bit "
                f"operands, got {bits}")
        which = route
    require(not force or which == "cluster",
            "only the cluster kernel takes a forced plan")
    return which


def _apw(path: str, compensated: bool) -> int:
    """Operands a staged A word holds (csrc ac_apw)."""
    if path == "lut":
        return 1
    if path == "log":
        return 1 if compensated else 2
    return 4


def _bpw(path: str, compensated: bool) -> int:
    """Operands a staged B word holds (csrc ac_bpw)."""
    if path == "log":
        return 1 if compensated else 2
    return 4


def padded_block(bk: int) -> int:
    """The kv block as the cluster kernel stages it: bk padded to 16
    (keys past bk are masked, their operands zero)."""
    return -(-bk // 16) * 16


@functools.lru_cache(maxsize=4096)
def attn_cluster_smem(path: str, bits: int, group: int, bq: int, per: int,
                      bk: int, d: int, rk: int, compensated: bool = False,
                      mode: str = "fused") -> int:
    """Dynamic shared memory of one block of the cluster kernel in `mode`
    (the total of csrc/attn_cluster.cuh's ac_geometry, which refuses any
    other): the table, the K/V ring, the staged K / V^T tile, the staged
    q rows (then pq's), per kv block of the range its score tile (then
    its pvf), row maxima, corr, sum p and prefix maxima, the accumulator,
    the row state, the liveness and the positions.  A region the mode
    does not use takes no bytes: "scores" has no V side, no softmax state
    and one block's stage for its score tiles; "pv" no K side and no q."""
    require(mode in CLUSTER_MODES, f"unknown cluster kernel mode {mode!r}")
    qk, pv = mode != "pv", mode != "scores"
    r, c = group * bq, per
    kpq, bkp = -(-d // 16) * 16, padded_block(bk)
    apw, bpw = _apw(path, compensated), _bpw(path, compensated)
    rsq, rsp = (kpq // bpw // 4) | 1, (bkp // bpw // 4) | 1
    drs = -(-d // 4) * 4 + 4
    btq, btp = (bkp * rsq * 16 if qk else 0), (d * rsp * 16 if pv else 0)
    aq, ap = (kpq // apw if qk else 0), (bkp // apw if pv else 0)
    cr = c * r * 4 if pv else 0               # a float a row a kv block
    return (_al(_table_bytes(path, bits))
            + _al(_AC_STAGES * rk * drs * 4)
            + _al(max(btq, btp)) + _al(r * max(aq, ap) * 4)
            + _al(c * r * max(bkp, d) * 4 if pv else r * bkp * 4)
            + _al(r * d * 4 if pv else 0)
            + 5 * _al(cr) + 2 * _al(r * 4 if pv else 0)
            + _al(r * 4 if qk else 0)
            + _al(c * 4 if pv else 0) + _al(c * 4) + _al((c + 1) * 4)
            + 2 * _al(c * bkp * 4) + _al(bq * 4))


class AttnClusterPlan(NamedTuple):
    """One launch of the cluster kernel: `bq` query rows a tile, the kv
    blocks in `splits` ranges of `per` blocks (as `chunks` of splits x
    per where one range does not fit), `rk` keys a ring tile, `smem`
    bytes a block; `tiles` clusters in `waves` of the device's
    capacity (the scores mode: `tiles` x `splits` lone blocks)."""
    bq: int
    splits: int
    per: int
    rk: int
    smem: int
    tiles: int
    waves: int
    chunks: int


def _blocks_a_tile(nk: int, bk: int, sq: int, skv: int, bq: int,
                   n_split: int, per: int, causal: bool) -> float:
    """The kv blocks a query tile's slowest rank computes, summed over the
    chunks and averaged over the tiles: a causal mask with the queries at
    the end of the keys leaves a tile the blocks up to its last query's,
    a prefix, of which rank 0 of each chunk holds the most."""
    span, n_qt = n_split * per, -(-sq // bq)

    def blocks(live):            # over the chunks, rank 0's share of live
        full, rest = divmod(live, span)
        return full * per + min(per, rest)

    if not causal:
        return float(blocks(nk))
    return sum(blocks(min(nk, (skv - sq + min(sq, (t + 1) * bq) - 1) // bk
                          + 1)) for t in range(n_qt)) / n_qt


def attn_cluster_plan(b: int, h: int, kh: int, sq: int, skv: int, d: int,
                      path: str, bits: int,
                      capacity: Callable[[int, int], int], *, bk: int,
                      compensated: bool = False, causal: bool = False,
                      splits: Optional[int] = None, bq: Optional[int] = None,
                      rk: Optional[int] = None,
                      mode: str = "fused") -> AttnClusterPlan:
    """How one call of the cluster kernel in `mode` is cut.

    ``capacity(smem, splits)`` is the number of clusters of `splits`
    blocks of `smem` bytes the device holds at once (0: none fits).  For
    each query tile bq of QUERY_ROWS (up to sq) and each split of the
    nk = ceil(skv / bk) kv blocks into `splits` contiguous ranges of
    `per` blocks with no range empty (at most MAX_SPLITS, a cluster; the
    scores mode, which combines nothing, MAX_SCORE_SPLITS lone blocks,
    whose capacity is asked at splits 1), the range runs in one chunk
    where its blocks fit a block's shared memory (else in the most that
    fit), with any ring tile of RING_KEYS that fits; ``splits``, ``bq``
    and ``rk``, where given, force theirs.  The plan minimizes waves x the
    kv blocks of a tile's slowest rank (`_blocks_a_tile`: a causal mask
    kills the blocks past a tile's queries) x (R + _QUANT_ROWS + 2 bk /
    rk _TILE_ROWS), R = group bq the rows of a block: a kv block's
    products, its quantization and the waits of its K and V ring tiles
    (a mode of one dot has half of each, in rows of half the products);
    ties go to fewer splits, then to the larger query tile, then to the
    larger ring tile."""
    require(mode in CLUSTER_MODES, f"unknown cluster kernel mode {mode!r}")
    lone = mode == "scores"              # no cluster: blocks on the grid
    most = MAX_SCORE_SPLITS if lone else MAX_SPLITS
    group = h // kh
    nk = -(-skv // bk)
    bkp = padded_block(bk)
    label = "log_our" if path == "log" and compensated else path
    quant = _QUANT_ROWS[label]
    if splits is not None:
        require(1 <= splits <= most and splits <= nk,
                f"{splits} splits of {nk} kv blocks leave a range empty "
                f"or pass {most}")
        per = -(-nk // splits)
        if (splits - 1) * per >= nk:     # chunks of fewer blocks a range
            per = (nk - 1) // (splits - 1)
        cuts = [(splits, per)]
    else:
        cuts = sorted({(-(-nk // -(-nk // w)), -(-nk // w))
                       for w in range(1, min(most, nk) + 1)})
    best = None
    query_rows = [bq] if bq else sorted({min(c, sq) for c in QUERY_ROWS})
    ring_keys = (rk,) if rk else RING_KEYS
    for bq in query_rows:
        rows = group * bq
        tiles = b * kh * -(-sq // bq)

        def smem(per, rk, bq=bq):
            return attn_cluster_smem(path, bits, group, bq, per, bk, d, rk,
                                     compensated, mode)

        if smem(1, 4) > SMEM_BYTES:
            continue
        for n_split, per in cuts:
            lo, hi = 1, per              # the most blocks a chunk that fit
            while lo < hi:
                mid = (lo + hi + 1) // 2
                lo, hi = (mid, hi) if smem(mid, 4) <= SMEM_BYTES else (
                    lo, mid - 1)
            chunks = -(-nk // (n_split * lo))
            blocks = _blocks_a_tile(nk, bk, sq, skv, bq, n_split, lo, causal)
            for rk in ring_keys:
                nbytes = smem(lo, rk)
                if bkp % rk or nbytes > SMEM_BYTES:
                    continue
                held = capacity(nbytes, 1 if lone else n_split)
                if held <= 0:
                    continue
                waves = -(-tiles * (n_split if lone else 1) // held)
                cost = waves * blocks * (
                    rows + quant + 2 * (bkp // rk) * _TILE_ROWS[label])
                key = (cost, n_split, -bq, -rk)
                if best is None or key < best[0]:
                    best = (key, AttnClusterPlan(bq, n_split, lo, rk, nbytes,
                                                 tiles, waves, chunks))
    if best is None:
        raise ValueError(f"no block of the attention cluster kernel fits "
                         f"({path}, {bits} bits, bk {bk}, head dim {d}, "
                         f"{mode})")
    return best[1]


@functools.lru_cache(maxsize=None)
def _capacity(device: int, path: str, compensated: bool, mode: str,
              smem: int, splits: int) -> int:
    """csrc attn_cluster_capacity on CUDA device `device`; cached."""
    with torch.cuda.device(device):
        return query("attn_gemm", "attn_cluster_capacity", _PATH_ID[path],
                     int(compensated), _MODE_ID[mode], smem, splits)


@functools.lru_cache(maxsize=1024)
def _device_plan(device: int, dims: tuple, path: str, bits: int, bk: int,
                 compensated: bool, causal: bool, force: tuple,
                 mode: str = "fused"):
    return attn_cluster_plan(*dims, path, bits, functools.partial(
        _capacity, device, path, compensated, mode), bk=bk,
        compensated=compensated, causal=causal, mode=mode, **dict(force))


def device_plan(q, k, path: str, bits: int, bk: int,
                compensated: bool = False, causal: bool = False,
                force: Optional[dict] = None,
                mode: str = "fused") -> AttnClusterPlan:
    """The cluster kernel's plan in `mode` for q (B, H, Sq, D), k (B, KH,
    Skv, D) (or tensors of their shapes) on their CUDA device (cached by
    shape); `force` holds attn_cluster_plan's forced splits / bq / rk, if
    any."""
    b, h, sq, d = q.shape
    dev = q.device.index if q.device.index is not None else 0
    comp = bool(compensated) and path == "log"
    return _device_plan(dev, (b, h, k.shape[1], sq, k.shape[2], d), path,
                        bits, int(bk), comp, bool(causal),
                        tuple(sorted((force or {}).items())), mode)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval, table, path,
           block):
    require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
            f"q (B,H,Sq,D), k/v (B,KH,Skv,D) expected, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    require(k.shape[0] == b and k.shape[3] == d and kh > 0 and h % kh == 0,
            f"GQA needs H % KH == 0 and matching B, D: {tuple(q.shape)} vs "
            f"{tuple(k.shape)}")
    require(path in ATTN_PATHS, f"unknown attention datapath {path!r}")
    require(tuple(sq_s.shape) == (b, h) and tuple(sk_s.shape) == (b, kh)
            and tuple(sv_s.shape) == (b, kh),
            "scales must be (B,H), (B,KH), (B,KH)")
    require(tuple(qpos.shape) == (b, sq) and tuple(kpos.shape) == (b, skv)
            and tuple(kval.shape) == (b, skv),
            "qpos (B,Sq), kpos/kval (B,Skv) expected")
    require(block[1] >= 1, f"bad block {block}")
    if path in ("lut", "nibble"):
        require(table is not None, f"the {path} path needs its table")


def _dev(*tensors) -> bool:
    """on_cuda over the operands that are present."""
    return on_cuda(*(t for t in tensors if t is not None))


def _f32c(t):
    return t.to(torch.float32).contiguous()


def _i32c(t):
    return t.to(torch.int32).contiguous()


def _launch(kern, dims, *, q=None, k=None, v=None, sq_s=None, sk_s=None,
            sv_s=None, qpos, kpos, kval, table, out=None, scores=None,
            path, bits, causal, window, compensated, block):
    """Check what the kernel takes and launch it on the current stream.
    `dims` is (B, H, KH, Sq, Skv, D); the operands a stage does not read
    are None.  The shared-memory total goes with the launch, and the
    kernel refuses it (CUDA error 1, invalid value) unless its own
    layout gives the same."""
    b, h, kh, sq, skv, d = dims
    bk = int(block[1])
    bq = min(ATTN_BQ, sq)
    max_bits = 12 if path == "log" else 8
    require(2 <= bits <= max_bits,
            f"the {path} path takes 2..{max_bits}-bit operands, got {bits}")
    if path == "lut":
        check_table(table, bits)
    elif path == "nibble":
        check_subs(table, bits)
    smem = attn_smem_bytes(path, bits, bq, bk, d)
    require(smem <= SMEM_BYTES,
            f"block ({bq}, {bk}) at head dim {d} needs {smem} bytes of "
            f"shared memory > {SMEM_BYTES}")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    tab = table if path in ("lut", "nibble") else None
    kern(ptr(q), ptr(k), ptr(v), ptr(sq_s), ptr(sk_s), ptr(sv_s), ptr(qpos),
         ptr(kpos), ptr(kval), ptr(tab), ptr(out), ptr(scores), b, h, kh, sq,
         skv, d, bq, bk, bits, _PATH_ID[path], int(compensated), int(causal),
         0 if window is None else int(window), smem, stream_of(kpos))


def _launch_cluster(mode, dims, *, q=None, k=None, v=None, sq_s=None,
                    sk_s=None, sv_s=None, qpos, kpos, kval, table, out=None,
                    scores=None, path, bits, causal, window, compensated,
                    block, force=None):
    """One planned launch of the cluster kernel in `mode` on the current
    stream (the operands the mode does not read are None); the shared-
    memory total goes with it, and the kernel refuses (CUDA error 1,
    invalid value) a plan or a total that is not its own."""
    if path == "lut":
        check_table(table, bits)
    elif path == "nibble":
        check_subs(table, bits)
    b, h, kh, sq, skv, d = dims
    bk = int(block[1])
    comp = bool(compensated) and path == "log"
    dev = kpos.device.index if kpos.device.index is not None else 0
    plan = _device_plan(dev, dims, path, bits, bk, comp, bool(causal),
                        tuple(sorted((force or {}).items())), mode)
    smem = attn_cluster_smem(path, bits, h // kh, plan.bq, plan.per, bk, d,
                             plan.rk, comp, mode)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    tab = table if path in ("lut", "nibble") else None
    _CLUSTER_KERNELS[mode](
        ptr(q), ptr(k), ptr(v), ptr(sq_s), ptr(sk_s), ptr(sv_s), ptr(qpos),
        ptr(kpos), ptr(kval), ptr(tab), ptr(out), ptr(scores), b, h, kh, sq,
        skv, d, bk, bits, _PATH_ID[path], int(comp), int(causal),
        0 if window is None else int(window), plan.bq, plan.splits,
        plan.per, plan.rk, smem, stream_of(kpos))


def attn_fused(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval, table=None, *,
               path, bits=8, causal=True, window=None, compensated=True,
               block=(32, 128)):
    """One-pass flash attention through the approximate datapath.

    q (B, H, Sq, D); k/v (B, KH, Skv, D) with H % KH == 0; sq_s (B, H),
    sk_s/sv_s (B, KH) scales (``attn_scales``); qpos (B, Sq), kpos/kval
    (B, Skv).  Returns f32 (B, H, Sq, D).  ``block[1]`` is the kv tile of
    the online softmax (part of the numerics); the table is the int16
    full table (lut) or the int32 sub-tables (nibble).  On the card the
    operands' bits pick the kernel (``fused_route``)."""
    return _attn_fused_forced(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval,
                              table, None, path=path, bits=bits,
                              causal=causal, window=window,
                              compensated=compensated, block=block)


def _attn_fused_forced(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval, table,
                       force, **kw):
    """``attn_fused`` with the cluster kernel's plan forced where `force`
    (a dict of attn_cluster_plan's splits / bq / rk) gives it: the tests,
    chip_smoke.py and launch/cluster_sweep.py; the result is the same
    bit for bit."""
    _check(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval, table, kw["path"],
           kw["block"])
    if not _dev(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval, table):
        return attn_reference(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval,
                              table, **kw)
    b, h, sq, d = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    ts = dict(q=_f32c(q), k=_f32c(k), v=_f32c(v), sq_s=_f32c(sq_s),
              sk_s=_f32c(sk_s), sv_s=_f32c(sv_s), qpos=_i32c(qpos),
              kpos=_i32c(kpos), kval=_i32c(kval), table=table, out=out)
    dims = (b, h, k.shape[1], sq, k.shape[2], d)
    if fused_route(kw["path"], kw["bits"]) == "cluster":
        _launch_cluster("fused", dims, **ts, **kw, force=force)
    else:
        require(not force, "only the cluster kernel takes a forced plan")
        _launch(_FUSED_WIDE, dims, **ts, **kw)
    return out


def attn_scores(q, k, sq_s, sk_s, qpos, kpos, kval, table=None, *, path,
                bits=8, causal=True, window=None, compensated=True,
                block=(32, 128)):
    """Stage one of the oracle: the masked f32 (B, H, Sq, Skvp) scores,
    Skvp the kv length rounded up to ``block[1]`` (padded keys hold
    NEG_INF).  On the card the operands' bits pick the kernel
    (``materialized_route``)."""
    return _attn_scores_forced(q, k, sq_s, sk_s, qpos, kpos, kval, table,
                               path=path, bits=bits, causal=causal,
                               window=window, compensated=compensated,
                               block=block)


def _attn_scores_forced(q, k, sq_s, sk_s, qpos, kpos, kval, table=None, *,
                        route=None, force=None, path, bits=8, causal=True,
                        window=None, compensated=True, block=(32, 128)):
    """``attn_scores`` on a forced `route` ("template": the template's
    attn_scores_wide at any bits, the cluster kernel's independent
    witness; "cluster"; None: materialized_route's) with the cluster
    kernel's plan forced where `force` gives it: the tests and
    chip_smoke.py."""
    kw = dict(path=path, bits=bits, causal=causal, window=window,
              compensated=compensated, block=block)
    _check(q, k, k, sq_s, sk_s, sk_s, qpos, kpos, kval, table, path, block)
    which = _route_of(route, path, bits, force)
    if not _dev(q, k, sq_s, sk_s, qpos, kpos, kval, table):
        return attn_scores_plain(q, k, sq_s, sk_s, qpos, kpos, kval, table,
                                 **kw)
    b, h, sq, d = q.shape
    bk = int(block[1])
    skvp = -(-k.shape[2] // bk) * bk
    scores = torch.empty((b, h, sq, skvp), dtype=torch.float32,
                         device=q.device)
    ts = dict(q=_f32c(q), k=_f32c(k), sq_s=_f32c(sq_s), sk_s=_f32c(sk_s),
              qpos=_i32c(qpos), kpos=_i32c(kpos), kval=_i32c(kval),
              table=table, scores=scores)
    dims = (b, h, k.shape[1], sq, k.shape[2], d)
    if which == "cluster":
        _launch_cluster("scores", dims, **ts, **kw, force=force)
    else:
        _launch(_SCORES_WIDE, dims, **ts, **kw)
    return scores


def attn_pv(scores, v, sv_s, qpos, kpos, kval, table=None, *, path, bits=8,
            causal=True, window=None, compensated=True, block=(32, 128)):
    """Stage two of the oracle: the online softmax and PV over the stored
    scores (B, H, Sq, Skvp), as `attn_scores` wrote them (a masked entry
    NEG_INF: a kv block with no admitted pair in a query tile is skipped
    unread on the card); v (B, KH, Skv, D).  Returns f32 (B, H, Sq, D).
    On the card the operands' bits pick the kernel
    (``materialized_route``)."""
    return _attn_pv_forced(scores, v, sv_s, qpos, kpos, kval, table,
                           path=path, bits=bits, causal=causal,
                           window=window, compensated=compensated,
                           block=block)


def _attn_pv_forced(scores, v, sv_s, qpos, kpos, kval, table=None, *,
                    route=None, force=None, path, bits=8, causal=True,
                    window=None, compensated=True, block=(32, 128)):
    """``attn_pv`` on a forced `route` and plan, as
    `_attn_scores_forced`."""
    kw = dict(path=path, bits=bits, causal=causal, window=window,
              compensated=compensated, block=block)
    b, h, sq, skvp = scores.shape
    kh, skv, d = v.shape[1], v.shape[2], v.shape[3]
    bk = int(block[1])
    require(skvp == -(-skv // bk) * bk and v.shape[0] == b and h % kh == 0,
            f"scores {tuple(scores.shape)} do not match v {tuple(v.shape)} "
            f"at bk {bk}")
    require(tuple(sv_s.shape) == (b, kh) and tuple(qpos.shape) == (b, sq)
            and tuple(kpos.shape) == (b, skv)
            and tuple(kval.shape) == (b, skv),
            "sv_s (B,KH), qpos (B,Sq), kpos/kval (B,Skv) expected")
    require(path in ATTN_PATHS, f"unknown attention datapath {path!r}")
    which = _route_of(route, path, bits, force)
    if not _dev(scores, v, sv_s, qpos, kpos, kval, table):
        return attn_pv_plain(scores, v, sv_s, qpos, kpos, kval, table, **kw)
    out = torch.empty((b, h, sq, d), dtype=torch.float32,
                      device=scores.device)
    ts = dict(v=_f32c(v), sv_s=_f32c(sv_s), qpos=_i32c(qpos),
              kpos=_i32c(kpos), kval=_i32c(kval), table=table, out=out,
              scores=_f32c(scores))
    dims = (b, h, kh, sq, skv, d)
    if which == "cluster":
        _launch_cluster("pv", dims, **ts, **kw, force=force)
    else:
        _launch(_PV_WIDE, dims, **ts, **kw)
    return out


def attn_materialized(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval,
                      table=None, *, path, bits=8, causal=True, window=None,
                      compensated=True, block=(32, 128)):
    """The oracle: identical math, with the masked (B, H, Sq, Skvp)
    score tensor through device memory between two kernels
    (`attn_scores`, `attn_pv`).  Bitwise equal to ``attn_fused`` on one
    device."""
    return _attn_materialized_forced(q, k, v, sq_s, sk_s, sv_s, qpos, kpos,
                                     kval, table, path=path, bits=bits,
                                     causal=causal, window=window,
                                     compensated=compensated, block=block)


def _attn_materialized_forced(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval,
                              table=None, *, route=None, force=None,
                              path, bits=8, causal=True, window=None,
                              compensated=True, block=(32, 128)):
    """``attn_materialized`` with both stages on a forced `route` and plan
    (`_attn_scores_forced`, `_attn_pv_forced`)."""
    kw = dict(path=path, bits=bits, causal=causal, window=window,
              compensated=compensated, block=block, route=route, force=force)
    _check(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval, table, path, block)
    scores = _attn_scores_forced(q, k, sq_s, sk_s, qpos, kpos, kval, table,
                                 **kw)
    return _attn_pv_forced(scores, v, sv_s, qpos, kpos, kval, table, **kw)


__all__ = [
    "ATTN_PATHS",
    "AttnClusterPlan",
    "NEG_INF",
    "attn_cluster_plan",
    "attn_cluster_smem",
    "attn_float",
    "attn_fused",
    "attn_materialized",
    "attn_pv",
    "attn_reference",
    "attn_scales",
    "attn_scores",
    "fused_route",
    "materialized_route",
]
