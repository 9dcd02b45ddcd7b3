"""The fused surrogate CiM GEMM: CUDA kernels for Hopper and their plain
versions.

The calibrated surrogate (the compiler's default mode) needs two sums
over the same quantized operands, D = A @ B (exact, int32) and
SQ = A^2 @ B^2 (f32, only when noise is drawn and c1 > 0), and flushes

    out = (1 + mu) * D * s + sqrt(max(c0 * K * s^2 + c1 * SQ * s^2, 0)) * eps

with s = sx * sw (ref.surrogate_epilogue spells out the order of the
roundings).  Two entry points, as in the JAX package, and the partial
form the mesh path's row-parallel layers run:

  * ``cim_gemm_core`` — int8 operands -> (D int32, SQ f32), the oracle
    surface (SQ zeros without ``need_sq``; ops.surrogate_gemm puts the
    epilogue on it in plain torch);
  * ``cim_gemm_fused`` — f32 or bf16 operands (bf16 widened on load),
    the per-tensor ``sx`` / per-column ``sw`` quantization on load and
    the whole epilogue in one kernel; ``eps`` is None for the
    deterministic term;
  * ``cim_gemm_partial`` — the fused kernel with its flush off: f32 or
    bf16 operands quantized on load against the caller's GLOBAL ``sx``
    and ``sw``, out the exact int32 sums, D and, with ``need_sq``, the
    four sums of SQ's squared halves (HH, HL, LH, LL), stacked (1 or 5,
    M, N).  A rank of the mesh adds them over the weight's K shards
    (exact in any order), then `partial_flush` forms SQ once and runs the
    epilogue, so the row-parallel result is one device's bit for bit.

On CUDA tensors each launches csrc/surrogate_gemm.cu or raises; on CPU
tensors it runs its plain version.  ``cim_gemm_fused`` is the split-K
cluster kernel of csrc/surrogate_cluster.cuh, cut by
``approx_matmul.cluster_plan`` (row tiles FUSED_ROWS): D and SQ on the
int8 tensor cores, SQ exact (each square split into two s8 halves,
h = q^2 >> 7 and l = q^2 & 127, four sums combined in 64 bits and
rounded once), so its output equals the plain version bit for bit with
and without noise; SQ needs K < SQ_MAX_K (``check_sq_k``).
``cim_gemm_core`` without SQ runs on the int8 tensor cores
(csrc/int8_mma.cuh), which split K across the blocks of a cluster as the
shape and the card's SM count ask; with SQ it is the oracle on the tiled
template, D bitwise and SQ (an f32 sum in K order) within (K - 1) 2^-24
relative of the exact value.
"""

from __future__ import annotations

import numpy as np
import torch

from .approx_matmul import _FLOATS, ClusterPlan, _shapes, fused_plan
from .build import FLT, INT, PTR, CudaKernel, on_cuda, require, stream_of
from .ref import (int_dot, quantize_tile, sq_from_halves, sq_halves,
                  square_dot, surrogate_epilogue)

_CORE = CudaKernel("surrogate_gemm", "cim_gemm_core",
                   [PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR])
# the fused form takes its variant and launch plan (rows, splits,
# k_split) before the stream
_FUSED = CudaKernel("surrogate_gemm", "cim_gemm_fused",
                    [PTR, INT, PTR, INT, PTR, PTR, PTR, PTR, INT, INT, INT,
                     INT, FLT, FLT, FLT, INT, INT, INT, INT, PTR])

# the partial form takes need_sq and the plan before the stream
_PARTIAL = CudaKernel("surrogate_gemm", "cim_gemm_partial",
                      [PTR, INT, PTR, INT, PTR, PTR, PTR, INT, INT, INT,
                       INT, INT, INT, INT, INT, PTR])

KERNELS = {"cim_gemm_core": _CORE, "cim_gemm_fused": _FUSED,
           "cim_gemm_partial": _PARTIAL}

# the fused kernel's row tiles: one or four m16 groups of the int8 tensor
# cores (M <= 16 runs one group with masked rows)
FUSED_ROWS = (16, 64)
# SQ's four int32 sums of squared halves are each at most 127^2 K, so
# they stay below 2^31 for K < SQ_MAX_K
SQ_MAX_K = (1 << 31) // (127 * 127)
# the fused kernel's variants (csrc/surrogate_cluster.cuh SG_*)
SERVED, NOISE, NOISE_SQ = 0, 1, 2


def stochastic(eps, c0: float, c1: float) -> bool:
    """Does the call draw noise?  Only with eps and a nonzero variance
    law, as the reference's ``stochastic`` flag."""
    return eps is not None and (c0 > 0.0 or c1 > 0.0)


def variant(eps, c0: float, c1: float) -> int:
    """The fused kernel's variant: SERVED without noise, NOISE with noise
    and c1 = 0 (no SQ), NOISE_SQ with noise and c1 > 0, as the plain
    version decides whether to form SQ."""
    if not stochastic(eps, c0, c1):
        return SERVED
    return NOISE_SQ if c1 > 0.0 else NOISE


def check_sq_k(k: int) -> None:
    """SQ's int32 sums hold K < SQ_MAX_K contraction terms; refuse more."""
    require(k < SQ_MAX_K, f"the surrogate kernel sums SQ exactly only for "
            f"K < {SQ_MAX_K}, got K = {k}")


def fused_launch_plan(x, w, var: int) -> ClusterPlan:
    """The launch plan of one cim_gemm_fused call of variant `var` on x's
    device (cluster_plan over FUSED_ROWS, cut by the device's cluster
    capacity for this variant and these operand types)."""
    return fused_plan(_FUSED, x, w, var, row_tiles=FUSED_ROWS)


def partial_launch_plan(x, w, need_sq: bool) -> ClusterPlan:
    """The launch plan of one cim_gemm_partial call, with or without SQ's
    sums, on x's device (as `fused_launch_plan`)."""
    return fused_plan(_PARTIAL, x, w, int(need_sq), row_tiles=FUSED_ROWS)


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; chip_smoke.py also runs them on the card)
# ---------------------------------------------------------------------------


def cim_gemm_core_plain(xq, wq, need_sq: bool = True):
    d = int_dot(xq, wq)
    sq = (square_dot(xq, wq) if need_sq
          else torch.zeros(d.shape, dtype=torch.float32, device=d.device))
    return d, sq


def cim_gemm_fused_plain(x, w, sx, sw, eps, mu: float, c0: float, c1: float,
                         bits: int = 8) -> torch.Tensor:
    qmax = (1 << (bits - 1)) - 1
    sx = sx.reshape(()).to(torch.float32)
    sw = sw.reshape(1, -1).to(torch.float32)
    a = quantize_tile(x.to(torch.float32), sx, qmax)
    b = quantize_tile(w.to(torch.float32), sw, qmax)
    var = variant(eps, c0, c1)
    sq = square_dot(a, b) if var == NOISE_SQ else None
    return surrogate_epilogue(int_dot(a, b), sq, sx, sw,
                              None if var == SERVED else eps, mu, c0, c1,
                              x.shape[-1])


def cim_gemm_partial_plain(x, w, sx, sw, need_sq: bool,
                           bits: int = 8) -> torch.Tensor:
    """The partial's sums: int_dot of the quantized operands, and with
    `need_sq` the int_dot of each pair of squared halves."""
    qmax = (1 << (bits - 1)) - 1
    a = quantize_tile(x.to(torch.float32), sx.reshape(()).to(torch.float32),
                      qmax)
    b = quantize_tile(w.to(torch.float32),
                      sw.reshape(1, -1).to(torch.float32), qmax)
    d = int_dot(a, b)
    if not need_sq:
        return d[None]
    (ah, al), (bh, bl) = sq_halves(a), sq_halves(b)
    return torch.stack([d, int_dot(ah, bh), int_dot(ah, bl),
                        int_dot(al, bh), int_dot(al, bl)])


def partial_flush(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                  eps, mu: float, c0: float, c1: float,
                  k: int) -> torch.Tensor:
    """The fused kernel's flush over `cim_gemm_partial`'s sums, added up
    over the shards: SQ formed once from the halves' sums (with five
    planes), then ref.surrogate_epilogue with the GLOBAL contraction
    length `k`; eps None for the deterministic term."""
    sq = sq_from_halves(acc[1:]) if acc.shape[0] == 5 else None
    return surrogate_epilogue(acc[0], sq, sx, sw, eps, mu, c0, c1, k)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def cim_gemm_core(xq: torch.Tensor, wq: torch.Tensor, need_sq: bool = True):
    """(D, SQ) over int8 xq (M,K), wq (K,N): D = xq @ wq int32 (exact,
    wrapping at 32 bits) and SQ = xq^2 @ wq^2 f32 (zeros without
    `need_sq`)."""
    m, k, n = _shapes(xq, wq)
    if not on_cuda(xq, wq):
        return cim_gemm_core_plain(xq, wq, need_sq)
    require(xq.dtype == torch.int8 and wq.dtype == torch.int8,
            f"int8 operands expected, got {xq.dtype}, {wq.dtype}")
    require(xq.is_contiguous() and wq.is_contiguous(),
            "operands must be contiguous")
    d = torch.empty((m, n), dtype=torch.int32, device=xq.device)
    sq = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    _CORE(xq.data_ptr(), wq.data_ptr(), d.data_ptr(), sq.data_ptr(), m, k, n,
          int(need_sq), stream_of(xq))
    return d, sq


def cim_gemm_fused(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                   sw: torch.Tensor, eps, mu: float, c0: float, c1: float,
                   bits: int = 8) -> torch.Tensor:
    """Fused-quantization surrogate GEMM: f32/bf16 x (M,K), w (K,N) and
    an optional f32 eps (M,N) -> f32 (M,N).  ``sx`` one f32 element,
    ``sw`` N f32, on the operands' device; mu, c0, c1 the calibrated
    surrogate's coefficients.  Bit-identical to
    ``cim_gemm_fused_plain``: without noise (eps None, or c0 = c1 = 0)
    quantize -> D -> ``(f32(1+mu) * D) * (sx * sw)``, with it the noise
    term over the exact SQ."""
    m, k, n = _shapes(x, w)
    noisy = stochastic(eps, c0, c1)
    if noisy:
        require(tuple(eps.shape) == (m, n),
                f"eps must be ({m}, {n}), got {tuple(eps.shape)}")
    if not on_cuda(x, w, sx, sw, *((eps,) if noisy else ())):
        return cim_gemm_fused_plain(x, w, sx, sw, eps, mu, c0, c1, bits)
    require(x.dtype in _FLOATS and w.dtype in _FLOATS,
            f"f32/bf16 operands expected, got {x.dtype}, {w.dtype}")
    require(x.is_contiguous() and w.is_contiguous(),
            "operands must be contiguous")
    require(sx.dtype == torch.float32 and sx.numel() == 1,
            "sx must be one f32 element")
    require(sw.dtype == torch.float32 and sw.numel() == n
            and sw.is_contiguous(), f"sw must be {n} contiguous f32")
    require(2 <= bits <= 8, f"the surrogate kernel takes 2..8-bit operands, "
            f"got {bits}")
    if noisy:
        require(eps.dtype == torch.float32 and eps.is_contiguous(),
                "eps must be contiguous f32")
    var = variant(eps, c0, c1)
    if var == NOISE_SQ:
        check_sq_k(k)
    plan = fused_launch_plan(x, w, var)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _FUSED(x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
           int(w.dtype == torch.bfloat16), sx.data_ptr(), sw.data_ptr(),
           eps.data_ptr() if noisy else None, out.data_ptr(), m, k, n, bits,
           float(np.float32(1.0 + mu)), float(np.float32(c0 * k)),
           float(np.float32(c1)), var, plan.rows, plan.splits, plan.k_split,
           stream_of(x))
    return out


def cim_gemm_partial(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                     sw: torch.Tensor, need_sq: bool,
                     bits: int = 8) -> torch.Tensor:
    """The fused surrogate GEMM with its flush off (the mesh path's
    row-parallel layers): f32/bf16 x (M,K), w (K,N) quantized against the
    global ``sx`` (one f32) and ``sw`` (N f32) -> int32 (1, M, N) D, or
    with `need_sq` (5, M, N): D, HH, HL, LH, LL.  Bit-identical to
    ``cim_gemm_partial_plain``; SQ's sums need K < SQ_MAX_K (the caller
    checks the global K: a shard's sums must add up below 2^31 too)."""
    m, k, n = _shapes(x, w)
    if not on_cuda(x, w, sx, sw):
        return cim_gemm_partial_plain(x, w, sx, sw, need_sq, bits)
    require(x.dtype in _FLOATS and w.dtype in _FLOATS,
            f"f32/bf16 operands expected, got {x.dtype}, {w.dtype}")
    require(x.is_contiguous() and w.is_contiguous(),
            "operands must be contiguous")
    require(sx.dtype == torch.float32 and sx.numel() == 1,
            "sx must be one f32 element")
    require(sw.dtype == torch.float32 and sw.numel() == n
            and sw.is_contiguous(), f"sw must be {n} contiguous f32")
    require(2 <= bits <= 8, f"the surrogate kernel takes 2..8-bit operands, "
            f"got {bits}")
    if need_sq:
        check_sq_k(k)
    plan = partial_launch_plan(x, w, need_sq)
    out = torch.empty((5 if need_sq else 1, m, n), dtype=torch.int32,
                      device=x.device)
    _PARTIAL(x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
             int(w.dtype == torch.bfloat16), sx.data_ptr(), sw.data_ptr(),
             out.data_ptr(), m, k, n, bits, int(need_sq), plan.rows,
             plan.splits, plan.k_split, stream_of(x))
    return out
