"""Log-domain (Mitchell / Log-our) GEMMs: CUDA kernels for Hopper and
their plain versions.

Each scalar product is computed arithmetically — leading-one detection,
operand decomposition, shifts and the paper's adder-free OR-merged
compensation (Eq. 3) — instead of gathered.  Two entry points, as in
the JAX package:

  * ``mitchell_matmul``       — int8 operands -> int32 (oracle surface);
  * ``mitchell_matmul_fused`` — f32/bf16 operands -> f32, quantization on
    load and the ``(acc * sx) * sw`` epilogue inside one kernel;
  * ``mitchell_matmul_partial`` — the fused form with the epilogue off:
    quantization against caller-supplied (global) scales, the raw int32
    sum out (the mesh path's shard-local form over a slice of K).

On CUDA tensors each launches its kernel (csrc/log_gemm.cu) or raises;
on CPU tensors it runs the plain version (kernels/ref.py).  Sums
wrap at 32 bits (16-bit operands can overflow int32, as in the
reference).  Every form of operands of at most 8 bits runs the split-K
cluster kernel (csrc/cluster_gemm.cuh), wider ones the tiled template
(csrc/cim_gemm.cuh): ``fused_route`` says which.
"""

from __future__ import annotations

import torch

from .approx_matmul import _check_fused, _shapes, epilogue, launch_cluster
from .build import INT, PTR, CudaKernel, on_cuda, require, stream_of
from .ref import log_sum, mitchell_matmul_ref, quantize_tile

_INT_ARGS = [PTR, PTR, PTR, INT, INT, INT, INT, INT]
# the cluster kernel also takes its launch plan: rows, splits, k_split
_INT = CudaKernel("log_gemm", "log_gemm_int8_cluster",
                  _INT_ARGS + [INT, INT, INT, PTR])
_INT_WIDE = CudaKernel("log_gemm", "log_gemm_int8_wide", _INT_ARGS + [PTR])
_QUANT_ARGS = [PTR, INT, PTR, INT, PTR, PTR, PTR, INT, INT, INT, INT, INT]
# the cluster kernel also takes its launch plan: rows, splits, k_split
_FUSED = CudaKernel("log_gemm", "log_gemm_fused",
                    _QUANT_ARGS + [INT, INT, INT, PTR])
_FUSED_WIDE = CudaKernel("log_gemm", "log_gemm_fused_wide",
                         _QUANT_ARGS + [PTR])
_PARTIAL = CudaKernel("log_gemm", "log_gemm_partial",
                      _QUANT_ARGS + [INT, INT, INT, PTR])
_PARTIAL_WIDE = CudaKernel("log_gemm", "log_gemm_partial_wide",
                           _QUANT_ARGS + [PTR])

# the *_wide kernels: the other side of fused_route (9..16-bit operands),
# on no served path
KERNELS = {"mitchell_matmul": _INT, "mitchell_matmul_wide": _INT_WIDE,
           "mitchell_matmul_fused": _FUSED,
           "mitchell_matmul_fused_wide": _FUSED_WIDE,
           "mitchell_matmul_partial": _PARTIAL,
           "mitchell_matmul_partial_wide": _PARTIAL_WIDE}

# the widest operands the cluster kernel stages (a log operand as signed
# bytes: |q| <= 127, 2^k <= 64)
CLUSTER_MAX_BITS = 8


def _check_bits(bits: int) -> None:
    require(2 <= bits <= 16, f"the log kernel takes 2..16-bit operands, got {bits}")


def fused_route(bits: int) -> str:
    """The kernel a log GEMM (int, fused or partial) of `bits`-bit
    operands launches on the card: "cluster" (csrc/cluster_gemm.cuh) up
    to CLUSTER_MAX_BITS, "tiled" (csrc/cim_gemm.cuh) for wider operands,
    up to 16 bits.  Every shape takes its bits' route."""
    _check_bits(bits)
    return "cluster" if bits <= CLUSTER_MAX_BITS else "tiled"


def mitchell_matmul_partial_plain(x, w, sx, sw, bits: int = 8,
                                  compensated: bool = True) -> torch.Tensor:
    qmax = (1 << (bits - 1)) - 1
    a = quantize_tile(x.to(torch.float32), sx.reshape(()).float(), qmax)
    b = quantize_tile(w.to(torch.float32), sw.reshape(1, -1).float(), qmax)
    return log_sum(a, b, bits, compensated)


def mitchell_matmul_fused_plain(x, w, sx, sw, bits: int = 8,
                                compensated: bool = True) -> torch.Tensor:
    return epilogue(mitchell_matmul_partial_plain(x, w, sx, sw, bits,
                                                  compensated), sx, sw)


def _check_log_our_domain(t: torch.Tensor, bits: int) -> None:
    """log_our on the cluster kernel below 8 bits: operands of magnitude
    below 2^bits.  Past it the capped leading one leaves q >= 2^k, and the
    reference's OR (2^(k1+k2) | comp) can meet a carry that the kernel's
    sum of the two does not (csrc/cluster_gemm.cuh, log_our); every
    quantized operand, and every int8 at 8 bits, lies inside it."""
    if bits >= 8 or t.numel() == 0:
        return
    lim = 1 << bits
    require(-lim < int(t.min()) and int(t.max()) < lim,
            f"{bits}-bit log_our operands must lie in ({-lim}, {lim}) on "
            "the card")


def mitchell_matmul(xq: torch.Tensor, wq: torch.Tensor, bits: int = 8,
                    compensated: bool = True) -> torch.Tensor:
    """Signed log-domain GEMM: int8 xq (M,K), wq (K,N) -> int32 (M,N).

    On the card log_our (`compensated`) below 8 bits takes operands of
    magnitude below 2^bits (`_check_log_our_domain`); mitchell takes
    every int8."""
    m, k, n = _shapes(xq, wq)
    if not on_cuda(xq, wq):
        return mitchell_matmul_ref(xq, wq, bits, compensated)
    require(xq.dtype == torch.int8 and wq.dtype == torch.int8,
            f"int8 operands expected, got {xq.dtype}, {wq.dtype}")
    require(xq.is_contiguous() and wq.is_contiguous(),
            "operands must be contiguous")
    if fused_route(bits) == "tiled":
        out = torch.empty((m, n), dtype=torch.int32, device=xq.device)
        _INT_WIDE(xq.data_ptr(), wq.data_ptr(), out.data_ptr(), m, k, n,
                  bits, int(compensated), stream_of(xq))
        return out
    if compensated:
        _check_log_our_domain(xq, bits)
        _check_log_our_domain(wq, bits)
    return launch_cluster(_INT, xq, wq, None, None, None, m, k, n, bits,
                          int(compensated), out_dtype=torch.int32)


def mitchell_matmul_fused(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                          sw: torch.Tensor, bits: int = 8,
                          compensated: bool = True) -> torch.Tensor:
    """Fused-quantization log-domain GEMM: f32/bf16 x (M,K), w (K,N) ->
    f32 (M,N); ``sx`` one f32 element, ``sw`` N f32, on the operands'
    device.  Bit-identical to quantize -> ``mitchell_matmul`` ->
    ``(acc * sx) * sw``."""
    m, k, n = _shapes(x, w)
    if not on_cuda(x, w, sx, sw):
        return mitchell_matmul_fused_plain(x, w, sx, sw, bits, compensated)
    if fused_route(bits) == "tiled":
        return _launch(_FUSED_WIDE, x, w, sx, sw, m, k, n, bits, compensated,
                       torch.float32)
    _check_fused(x, w, sx, sw, n)
    return launch_cluster(_FUSED, x, w, None, sx, sw, m, k, n, bits,
                          int(compensated))


def mitchell_matmul_partial(x: torch.Tensor, w: torch.Tensor,
                            sx: torch.Tensor, sw: torch.Tensor,
                            bits: int = 8,
                            compensated: bool = True) -> torch.Tensor:
    """Shard-local log-domain GEMM over a slice of K: f32/bf16 x
    (M, K_shard), w (K_shard, N) -> the raw int32 (M, N) sum, quantized on
    load against the supplied global scales; the caller sums the shards'
    partials and applies the epilogue.  Bit-identical to quantize ->
    ``mitchell_matmul``."""
    m, k, n = _shapes(x, w)
    if not on_cuda(x, w, sx, sw):
        return mitchell_matmul_partial_plain(x, w, sx, sw, bits, compensated)
    if fused_route(bits) == "tiled":
        return _launch(_PARTIAL_WIDE, x, w, sx, sw, m, k, n, bits,
                       compensated, torch.int32)
    _check_fused(x, w, sx, sw, n)
    return launch_cluster(_PARTIAL, x, w, None, sx, sw, m, k, n, bits,
                          int(compensated), out_dtype=torch.int32)


def _launch(kern: CudaKernel, x, w, sx, sw, m, k, n, bits, compensated,
            out_dtype):
    _check_fused(x, w, sx, sw, n)
    _check_bits(bits)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    kern(x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
         int(w.dtype == torch.bfloat16), sx.data_ptr(), sw.data_ptr(),
         out.data_ptr(), m, k, n, bits, int(compensated), stream_of(x))
    return out
