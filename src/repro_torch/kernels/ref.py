"""Plain PyTorch oracles for the GEMM kernels.

`lut_matmul_ref` and `mitchell_matmul_ref` are the bit-for-bit semantics
the CUDA kernels (and their plain versions) must match, and
`quantize_tile`, `gather_full` and `log_product` are plain twins of the
reference kernel bodies' arithmetic (`_quantize_tile`, `_gather_full`,
`_log_product` in the JAX package).  Integer sums wrap at 32 bits, like
the reference's int32 sums.
"""

from __future__ import annotations

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


def mitchell_matmul_ref(xq: torch.Tensor, wq: torch.Tensor, bits: int = 8,
                        compensated: bool = True) -> torch.Tensor:
    """Log-domain GEMM oracle (mitchell, or the paper's log_our when
    `compensated`).  Returns int32 (M, N)."""
    return log_sum(xq, wq, bits, compensated)
