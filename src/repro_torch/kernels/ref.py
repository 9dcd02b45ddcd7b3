"""Plain PyTorch oracles for the GEMM kernels.

`lut_matmul_ref`, `nibble_matmul_ref` and `mitchell_matmul_ref` are the
bit-for-bit semantics the CUDA kernels (and their plain versions) must
match, and `quantize_tile`, `gather_full`, `gather_nibble`,
`log_product` and `taps` are plain twins of the reference kernel bodies'
arithmetic (`_quantize_tile`, `_gather_full`, `_gather_nibble`,
`_log_product` and the conv kernels' `_taps` in the JAX package).
Integer sums wrap at 32 bits, like the reference's int32 sums.

The surrogate GEMM's pieces: `int_dot` (D, the exact integer dot),
`square_dot` (SQ = A^2 @ B^2, computed exactly and rounded once to f32),
`sq_halves` / `sq_from_halves` (the kernels' split of each square into
two s8 halves, and SQ from the four sums over them) and
`surrogate_epilogue` (the fused kernel's flush, op for op);
`cim_gemm_ref` is the reference's f32 oracle of the whole.

The sLSTM recurrence: `slstm_gates` is one step's stabilized
exponential gating on the pre-activations (the reference's
``_slstm_cell`` after its recurrent matvec, op for op), and
`slstm_scan_ref` the whole scan from a given state.
"""

from __future__ import annotations

import numpy as np
import torch

# bound on the live (M, k_chunk, N) index/product temporaries of a
# gather or log-domain sum, in elements
_LIVE_ELEMS = 1 << 24


def k_chunk(m: int, k: int, n: int) -> int:
    """K slice keeping an (m, slice, n) temporary under _LIVE_ELEMS."""
    return max(1, min(k, _LIVE_ELEMS // max(m * n, 1)))


def quantize_tile(v: torch.Tensor, scale: torch.Tensor,
                  qmax: int) -> torch.Tensor:
    """round(v / scale) half-to-even, clipped to [-qmax, qmax], int32."""
    q = torch.round(v / scale)
    return torch.clamp(q, -qmax, qmax).to(torch.int32)


def gather_full(lut: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
                n: int) -> torch.Tensor:
    """sum_k LUT[ia[:, k] * n + ib[k, :]] as int32 (M, N); ia/ib are the
    offset (nonnegative) operand indices, sliced along K to bound the
    live index tensor."""
    m, k = ia.shape
    nn = ib.shape[1]
    ia = ia.to(torch.int64)
    ib = ib.to(torch.int64)
    acc = torch.zeros((m, nn), dtype=torch.int32, device=ia.device)
    step = k_chunk(m, k, nn)
    for s in range(0, k, step):
        idx = ia[:, s:s + step, None] * n + ib[None, s:s + step, :]
        acc += lut[idx].sum(dim=1, dtype=torch.int32)
    return acc


def gather_nibble(subs: torch.Tensor, am: torch.Tensor, bm: torch.Tensor,
                  sa: torch.Tensor, sb: torch.Tensor, h: int) -> torch.Tensor:
    """sum_k sa*sb*(S_hh[ah,bh] + S_hl[ah,bl] + S_lh[al,bh] + S_ll[al,bl])
    as int32 (..., M, N): the nibble-decomposed signed product sum over
    the raveled sub-tables ``subs`` = [S_hh, S_hl, S_lh, S_ll], on
    magnitudes am (..., M, K) / bm (..., K, N) split into h-bit halves,
    with the signs sa / sb restored; sliced along K to bound the live
    index tensors."""
    hb = 1 << h
    sz = hb * hb
    am, bm = am.to(torch.int64), bm.to(torch.int64)
    ah, al = am >> h, am & (hb - 1)
    bh, bl = bm >> h, bm & (hb - 1)
    k = am.shape[-1]
    acc = torch.zeros(am.shape[:-1] + bm.shape[-1:], dtype=torch.int32,
                      device=am.device)
    step = k_chunk(am.numel() // max(k, 1), k, bm.shape[-1])
    for s in range(0, k, step):
        e = s + step
        a_hi, a_lo = ah[..., :, s:e, None], al[..., :, s:e, None]
        b_hi, b_lo = bh[..., None, s:e, :], bl[..., None, s:e, :]
        mag = (subs[a_hi * hb + b_hi] + subs[sz + a_hi * hb + b_lo]
               + subs[2 * sz + a_lo * hb + b_hi]
               + subs[3 * sz + a_lo * hb + b_lo])
        prods = sa[..., :, s:e, None] * sb[..., None, s:e, :] * mag
        acc += prods.sum(dim=-2, dtype=torch.int32)
    return acc


def nibble_sum(subs: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               bits: int) -> torch.Tensor:
    """`gather_nibble` of signed integer operands, magnitudes saturated at
    qmax (|-2^{b-1}| -> qmax, as the signed table's sign-magnitude
    wrapper and the reference's ``_nibble_int_kernel``)."""
    qmax = (1 << (bits - 1)) - 1
    a, b = a.to(torch.int32), b.to(torch.int32)
    return gather_nibble(subs, torch.clamp(torch.abs(a), max=qmax),
                         torch.clamp(torch.abs(b), max=qmax), torch.sign(a),
                         torch.sign(b), bits // 2)


def taps(xp: torch.Tensor, kh: int, kw: int, oh: int, ow: int, stride: int):
    """The implicit-GEMM A operands of a padded plane xp (B, Hp, Wp, C):
    for each kernel tap (ki, kj), tap-major, its index and the shifted
    (B*oh*ow, C) window."""
    c = xp.shape[-1]
    m = xp.shape[0] * oh * ow
    for ki in range(kh):
        for kj in range(kw):
            a = xp[:, ki:ki + (oh - 1) * stride + 1:stride,
                   kj:kj + (ow - 1) * stride + 1:stride, :]
            yield ki * kw + kj, a.reshape(m, c)


def leading_one(x: torch.Tensor, bits: int) -> torch.Tensor:
    """floor(log2(x)) capped at bits-1 (0 for x <= 0), as the
    reference's predicated loop."""
    k = torch.zeros_like(x)
    for i in range(1, bits):
        k = torch.where((x >> i) > 0, torch.full_like(x, i), k)
    return k


def log_product(a: torch.Tensor, b: torch.Tensor, bits: int,
                compensated: bool) -> torch.Tensor:
    """Signed log-domain product of int32 tensors (sign-magnitude), the
    reference's `_log_product` line for line."""
    sa = torch.sign(a)
    sb = torch.sign(b)
    x = torch.abs(a)
    y = torch.abs(b)
    k1 = leading_one(x, bits)
    k2 = leading_one(y, bits)
    one = torch.ones_like(x)
    q1 = x - (one << k1)
    q2 = y - (one << k2)
    ap = (one << (k1 + k2)) + (q1 << k2) + (q2 << k1)
    if compensated:
        q_big = torch.maximum(q1, q2)
        q_small = torch.minimum(q1, q2)
        m = leading_one(q_big, bits)
        round_up = (q_big << 1) >= (one << m) * 3
        shift = m + round_up.to(m.dtype)
        comp = torch.where(q_big > 0, q_small << shift, torch.zeros_like(x))
        p = ((one << (k1 + k2)) | comp) + (q1 << k2) + (q2 << k1)
    else:
        p = ap
    p = torch.where((x == 0) | (y == 0), torch.zeros_like(p), p)
    return sa * sb * p


def log_sum(a: torch.Tensor, b: torch.Tensor, bits: int,
            compensated: bool) -> torch.Tensor:
    """sum_k log_product(a[:, k], b[k, :]) as int32 (M, N), sliced along K
    to bound the live (M, slice, N) product tensor."""
    m, k = a.shape
    n = b.shape[1]
    a = a.to(torch.int32)
    b = b.to(torch.int32)
    acc = torch.zeros((m, n), dtype=torch.int32, device=a.device)
    step = k_chunk(m, k, n)
    for s in range(0, k, step):
        prods = log_product(a[:, s:s + step, None], b[None, s:s + step, :],
                            bits, compensated)
        acc += prods.sum(dim=1, dtype=torch.int32)
    return acc


def lut_matmul_ref(xq: torch.Tensor, wq: torch.Tensor, lut_flat: torch.Tensor,
                   bits: int = 8) -> torch.Tensor:
    """Bit-exact signed LUT GEMM: out[m,n] = sum_k LUT[xq[m,k], wq[k,n]].

    xq: (M, K) integers in [-2^{b-1}, 2^{b-1}); wq: (K, N); lut_flat:
    (2^{2b},) signed-product table (core.luts.signed_product_lut).
    Returns int32 (M, N)."""
    half = 1 << (bits - 1)
    return gather_full(lut_flat, xq.to(torch.int64) + half,
                       wq.to(torch.int64) + half, 1 << bits)


def nibble_matmul_ref(xq: torch.Tensor, wq: torch.Tensor, subs: torch.Tensor,
                      bits: int = 8) -> torch.Tensor:
    """Bit-exact signed GEMM over the four nibble sub-tables (raveled
    core.luts.nibble_sub_luts), equal to `lut_matmul_ref` over the full
    table for a decomposable spec.  Returns int32 (M, N)."""
    return nibble_sum(subs, xq, wq, bits)


def mitchell_matmul_ref(xq: torch.Tensor, wq: torch.Tensor, bits: int = 8,
                        compensated: bool = True) -> torch.Tensor:
    """Log-domain GEMM oracle (mitchell, or the paper's log_our when
    `compensated`).  Returns int32 (M, N)."""
    return log_sum(xq, wq, bits, compensated)


# ---------------------------------------------------------------------------
# The surrogate GEMM (kernels/cim_gemm.py)
# ---------------------------------------------------------------------------


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact integer dot of integer-valued tensors (..., M, K) @ (K, N)
    as int32, wrapping at 32 bits as the kernels' sums do.  Computed in
    float64, where every partial sum of int8 products is an integer below
    2^53 (K < 2^38) and so exact in any order, on the CPU and on the card
    alike."""
    d = a.to(torch.float64) @ b.to(torch.float64)
    return d.to(torch.int64).to(torch.int32)


def square_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SQ = A^2 @ B^2 of integer-valued tensors, exact in float64 (each
    term is at most 127^4 < 2^28, so K < 2^25 keeps every sum exact) and
    rounded once to f32.  The kernel sums in f32, so it lies within
    (K - 1) 2^-24 relative of this (the error bound of a sum of positive
    terms, one rounding a step) plus this value's own half ulp."""
    af = a.to(torch.float64)
    bf = b.to(torch.float64)
    return ((af * af) @ (bf * bf)).to(torch.float32)


def sq_halves(q: torch.Tensor):
    """The two non-negative halves of each square, q^2 = 128 h + l with
    h = q^2 >> 7 and l = q^2 & 127 (|q| <= 127: each at most 126 or 127,
    a valid s8), int32: the operands of the kernels' exact SQ."""
    sq = q.to(torch.int32) * q.to(torch.int32)
    return sq >> 7, sq & 127


def sq_from_halves(halves: torch.Tensor) -> torch.Tensor:
    """SQ from its four int32 sums of squared halves (HH, HL, LH, LL on
    the first dim): 2^14 HH + 2^7 (HL + LH) + LL in 64 bits, exact, then
    rounded once to f32, the value `square_dot` gives."""
    hh, hl, lh, ll = (h.to(torch.int64) for h in halves)
    return ((hh << 14) + ((hl + lh) << 7) + ll).to(torch.float32)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """`v` rounded once to f32, as a 0-dim tensor on `like`'s device."""
    return torch.tensor(np.float32(v), device=like.device)


def surrogate_epilogue(d: torch.Tensor, sq, sx: torch.Tensor,
                       sw: torch.Tensor, eps, mu: float, c0: float, c1: float,
                       k: int) -> torch.Tensor:
    """The fused surrogate kernel's flush, in its order of roundings:

        s   = sx * sw
        out = (f32(1 + mu) * f32(D)) * s
        var = f32(c0 * K) * (s * s)          c0 * K formed in double first
        var = var + (f32(c1) * SQ) * (s * s)  only with SQ
        out = out + sqrt(max(var, 0)) * eps   only with eps

    d: int32 (M, N); sq: f32 (M, N) or None; sx: one f32; sw: (N,) f32;
    eps: f32 (M, N) or None.  Every step is one f32 operation, so this
    equals the kernel bit for bit given the same D and SQ."""
    scale = sx.reshape(()).to(torch.float32) * sw.reshape(1, -1).to(
        torch.float32)
    out = (_f32(1.0 + mu, d) * d.to(torch.float32)) * scale
    if eps is None:
        return out
    s2 = scale * scale
    var = _f32(c0 * k, d) * s2
    if sq is not None:
        var = var + (_f32(c1, d) * sq) * s2
    return out + torch.sqrt(torch.clamp_min(var, 0.0)) * eps


def cim_gemm_ref(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                 sw: torch.Tensor, eps: torch.Tensor, mu: float, c0: float,
                 c1: float) -> torch.Tensor:
    """The reference's surrogate CiM GEMM oracle (real units), in f32.

    xq (M,K) int8, wq (K,N) int8, sx scalar, sw (N,), eps (M,N) f32:
    out = (1+mu) * D + sqrt(c0*K*s2 + c1*SQ) * eps, with D and SQ the int
    dot and squared dot dequantized by s2 = (sx*sw)^2 (D and SQ as f32
    dots, so within f32 rounding of the kernels)."""
    xf = xq.to(torch.float32)
    wf = wq.to(torch.float32)
    d = xf @ wf
    sq = (xf * xf) @ (wf * wf)
    scale = sx * sw.reshape(1, -1)
    s2 = scale * scale
    var = c0 * xq.shape[-1] * s2 + c1 * sq * s2
    return ((1.0 + mu) * d * scale
            + torch.sqrt(torch.clamp_min(var, 0.0)) * eps)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``log_sigmoid``: ``-softplus(-x)``, with softplus written as
    ``max(-x, 0) + log1p(exp(-|x|))`` (its ``logaddexp(-x, 0)``)."""
    return -(torch.clamp_min(-x, 0.0) + torch.log1p(torch.exp(-x.abs())))


def slstm_gates(pre: torch.Tensor, c, n, m, dh: int):
    """One sLSTM step from the pre-activations ``pre`` (..., 4*dh), gate
    blocks [z | i | f | o] each dh wide, and the state (c, n, m) (...,
    dh): returns the new (c, n, h, m)."""
    z = torch.tanh(pre[..., :dh])
    li = pre[..., dh:2 * dh]
    lf = log_sigmoid(pre[..., 2 * dh:3 * dh])
    o = torch.sigmoid(pre[..., 3 * dh:])
    m_new = torch.maximum(lf + m, li)
    iw = torch.exp(li - m_new)
    fw = torch.exp(lf + m - m_new)
    c = fw * c + iw * z
    n = fw * n + iw
    h = o * c / torch.clamp_min(n, 1e-6)
    return c, n, h, m_new


def slstm_scan_ref(u: torch.Tensor, r: torch.Tensor, bias: torch.Tensor,
                   n_heads: int, state=None):
    """The sLSTM recurrence, step by step (the plain version of the
    fused kernel, and the reference's ``slstm_scan_ref`` with a state).

    u (B, T, 4d) f32 input pre-activations, head-major and gate-major
    within a head; r (nh, dh, 4dh) f32; bias (nh, 4dh) f32; state
    (c, n, h, m), each (B, nh, dh) f32, zeros by default.  Returns h
    (B, T, nh, dh) and the final state."""
    b, t, d4 = u.shape
    dh = d4 // 4 // n_heads
    ut = u.reshape(b, t, n_heads, 4 * dh)
    if state is None:
        state = tuple(torch.zeros((b, n_heads, dh), dtype=torch.float32,
                                  device=u.device) for _ in range(4))
    c, n, h, m = state
    hs = []
    for i in range(t):
        rec = torch.einsum("bkd,kdf->bkf", h, r)
        pre = ut[:, i] + rec + bias[None]
        c, n, h, m = slstm_gates(pre, c, n, m, dh)
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h, m)
