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
  * ``attn_materialized`` — the oracle: two kernels sharing the same
    device functions, with the masked (B, H, Sq, Skvp) score tensor
    written to device memory between them.  Integer sums are exact and
    every float expression runs in the same code and order, so fused ==
    materialized bit for bit.

Masking is unified as in the reference: qpos (B, Sq), kpos and kval
(B, Skv) int32, and ``kval != 0 & (causal -> kpos <= qpos) & (window ->
kpos > qpos - window)``; the probability tile is masked too, so a fully
masked row gives 0, not a resurrected exp(0).

On CUDA tensors each entry point launches its kernels
(csrc/attn_gemm.cu) or raises; on CPU tensors it runs the plain version
below, which repeats the kernels' arithmetic with torch ops (the twin of
the reference's ``attn_reference`` and its two-stage oracle).  The
scales are per-(batch, q-head) for Q and per-(batch, kv-head) for K/V
(``attn_scales``), so GQA head expansion and per-head tier composition
are exact.
"""

from __future__ import annotations

import math

import torch

from .approx_matmul import check_subs, check_table
from .build import (INT, PTR, SMEM_BYTES, CudaKernel, on_cuda, require,
                    stream_of)
from .ref import k_chunk, log_product, nibble_sum, quantize_tile

NEG_INF = -1e30          # finite stand-in for -inf: exp() underflows to 0
_EPS_L = 1e-30           # normalizer floor for fully masked rows

ATTN_PATHS = ("mxu", "lut", "nibble", "log")
_PATH_ID = {p: i for i, p in enumerate(ATTN_PATHS)}

# query rows per block of the CUDA kernels (bq is free on Hopper: the
# result of a row does not depend on the rows beside it); the launch
# uses min(ATTN_BQ, Sq)
ATTN_BQ = 32

_ARGS = [PTR] * 12 + [INT] * 14 + [PTR]
_FUSED = CudaKernel("attn_gemm", "attn_fused", _ARGS)
_SCORES = CudaKernel("attn_gemm", "attn_scores", _ARGS)
_PV = CudaKernel("attn_gemm", "attn_pv", _ARGS)

# the kernels of this module by wrapper name (chip_smoke.py reads and
# resets their launch counts); the oracle `attn_materialized` is two
KERNELS = {"attn_fused": _FUSED, "attn_scores": _SCORES, "attn_pv": _PV}


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


def attn_fused(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval, table=None, *,
               path, bits=8, causal=True, window=None, compensated=True,
               block=(32, 128)):
    """One-pass flash attention through the approximate datapath.

    q (B, H, Sq, D); k/v (B, KH, Skv, D) with H % KH == 0; sq_s (B, H),
    sk_s/sv_s (B, KH) scales (``attn_scales``); qpos (B, Sq), kpos/kval
    (B, Skv).  Returns f32 (B, H, Sq, D).  ``block[1]`` is the kv tile of
    the online softmax (part of the numerics); the table is the int16
    full table (lut) or the int32 sub-tables (nibble)."""
    _check(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval, table, path, block)
    kw = dict(path=path, bits=bits, causal=causal, window=window,
              compensated=compensated, block=block)
    if not _dev(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval, table):
        return attn_reference(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval,
                              table, **kw)
    b, h, sq, d = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch(_FUSED, (b, h, k.shape[1], sq, k.shape[2], d), q=_f32c(q),
            k=_f32c(k), v=_f32c(v), sq_s=_f32c(sq_s), sk_s=_f32c(sk_s),
            sv_s=_f32c(sv_s), qpos=_i32c(qpos), kpos=_i32c(kpos),
            kval=_i32c(kval), table=table, out=out, **kw)
    return out


def attn_scores(q, k, sq_s, sk_s, qpos, kpos, kval, table=None, *, path,
                bits=8, causal=True, window=None, compensated=True,
                block=(32, 128)):
    """Stage one of the oracle: the masked f32 (B, H, Sq, Skvp) scores,
    Skvp the kv length rounded up to ``block[1]`` (padded keys hold
    NEG_INF)."""
    _check(q, k, k, sq_s, sk_s, sk_s, qpos, kpos, kval, table, path, block)
    kw = dict(path=path, bits=bits, causal=causal, window=window,
              compensated=compensated, block=block)
    if not _dev(q, k, sq_s, sk_s, qpos, kpos, kval, table):
        return attn_scores_plain(q, k, sq_s, sk_s, qpos, kpos, kval, table,
                                 **kw)
    b, h, sq, d = q.shape
    bk = int(block[1])
    skvp = -(-k.shape[2] // bk) * bk
    scores = torch.empty((b, h, sq, skvp), dtype=torch.float32,
                         device=q.device)
    _launch(_SCORES, (b, h, k.shape[1], sq, k.shape[2], d), q=_f32c(q),
            k=_f32c(k), sq_s=_f32c(sq_s), sk_s=_f32c(sk_s),
            qpos=_i32c(qpos), kpos=_i32c(kpos), kval=_i32c(kval),
            table=table, scores=scores, **kw)
    return scores


def attn_pv(scores, v, sv_s, qpos, kpos, kval, table=None, *, path, bits=8,
            causal=True, window=None, compensated=True, block=(32, 128)):
    """Stage two of the oracle: the online softmax and PV over the stored
    scores (B, H, Sq, Skvp); v (B, KH, Skv, D).  Returns f32
    (B, H, Sq, D)."""
    b, h, sq, skvp = scores.shape
    kh, skv, d = v.shape[1], v.shape[2], v.shape[3]
    bk = int(block[1])
    require(skvp == -(-skv // bk) * bk and v.shape[0] == b and h % kh == 0,
            f"scores {tuple(scores.shape)} do not match v {tuple(v.shape)} "
            f"at bk {bk}")
    kw = dict(path=path, bits=bits, causal=causal, window=window,
              compensated=compensated, block=block)
    if not _dev(scores, v, sv_s, qpos, kpos, kval, table):
        return attn_pv_plain(scores, v, sv_s, qpos, kpos, kval, table, **kw)
    out = torch.empty((b, h, sq, d), dtype=torch.float32,
                      device=scores.device)
    _launch(_PV, (b, h, kh, sq, skv, d), v=_f32c(v), sv_s=_f32c(sv_s),
            qpos=_i32c(qpos), kpos=_i32c(kpos), kval=_i32c(kval),
            table=table, out=out, scores=_f32c(scores), **kw)
    return out


def attn_materialized(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval,
                      table=None, *, path, bits=8, causal=True, window=None,
                      compensated=True, block=(32, 128)):
    """The oracle: identical math, with the masked (B, H, Sq, Skvp)
    score tensor through device memory between two kernels
    (`attn_scores`, `attn_pv`).  Bitwise equal to ``attn_fused`` on one
    device."""
    _check(q, k, v, sq_s, sk_s, sv_s, qpos, kpos, kval, table, path, block)
    kw = dict(path=path, bits=bits, causal=causal, window=window,
              compensated=compensated, block=block)
    scores = attn_scores(q, k, sq_s, sk_s, qpos, kpos, kval, table, **kw)
    return attn_pv(scores, v, sv_s, qpos, kpos, kval, table, **kw)


__all__ = [
    "ATTN_PATHS",
    "NEG_INF",
    "attn_float",
    "attn_fused",
    "attn_materialized",
    "attn_pv",
    "attn_reference",
    "attn_scales",
    "attn_scores",
]
