"""Log-domain (Mitchell / Log-our) GEMMs: CUDA kernels for Hopper and
their plain versions.

Each scalar product is computed arithmetically — leading-one detection,
operand decomposition, shifts and the paper's adder-free OR-merged
compensation (Eq. 3) — instead of gathered.  Two entry points, as in
the JAX package:

  * ``mitchell_matmul``       — int8 operands -> int32 (oracle surface);
  * ``mitchell_matmul_fused`` — f32/bf16 operands -> f32, quantization on
    load and the ``(acc * sx) * sw`` epilogue inside one kernel.

On CUDA tensors each launches its kernel (csrc/log_gemm.cu) or raises;
on CPU tensors it runs the plain version (kernels/ref.py).  Sums
wrap at 32 bits (16-bit operands can overflow int32, as in the
reference).
"""

from __future__ import annotations

import torch

from .approx_matmul import _FLOATS, _shapes
from .build import INT, PTR, CudaKernel, on_cuda, require, stream_of
from .ref import log_sum, mitchell_matmul_ref, quantize_tile

_INT = CudaKernel("log_gemm", "log_gemm_int8",
                  [PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR])
_FUSED = CudaKernel("log_gemm", "log_gemm_fused",
                    [PTR, INT, PTR, INT, PTR, PTR, PTR, INT, INT, INT, INT,
                     INT, PTR])

KERNELS = {"mitchell_matmul": _INT, "mitchell_matmul_fused": _FUSED}


def _check_bits(bits: int) -> None:
    require(2 <= bits <= 16, f"the log kernel takes 2..16-bit operands, got {bits}")


def mitchell_matmul_fused_plain(x, w, sx, sw, bits: int = 8,
                                compensated: bool = True) -> torch.Tensor:
    qmax = (1 << (bits - 1)) - 1
    sx = sx.reshape(()).to(torch.float32)
    sw = sw.reshape(1, -1).to(torch.float32)
    a = quantize_tile(x.to(torch.float32), sx, qmax)
    b = quantize_tile(w.to(torch.float32), sw, qmax)
    acc = log_sum(a, b, bits, compensated)
    return (acc.to(torch.float32) * sx) * sw


def mitchell_matmul(xq: torch.Tensor, wq: torch.Tensor, bits: int = 8,
                    compensated: bool = True) -> torch.Tensor:
    """Signed log-domain GEMM: int8 xq (M,K), wq (K,N) -> int32 (M,N)."""
    m, k, n = _shapes(xq, wq)
    if not on_cuda(xq, wq):
        return mitchell_matmul_ref(xq, wq, bits, compensated)
    require(xq.dtype == torch.int8 and wq.dtype == torch.int8,
            f"int8 operands expected, got {xq.dtype}, {wq.dtype}")
    require(xq.is_contiguous() and wq.is_contiguous(),
            "operands must be contiguous")
    _check_bits(bits)
    out = torch.empty((m, n), dtype=torch.int32, device=xq.device)
    _INT(xq.data_ptr(), wq.data_ptr(), out.data_ptr(), m, k, n, bits,
         int(compensated), stream_of(xq))
    return out


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
    require(x.dtype in _FLOATS and w.dtype in _FLOATS,
            f"f32/bf16 operands expected, got {x.dtype}, {w.dtype}")
    require(x.is_contiguous() and w.is_contiguous(),
            "operands must be contiguous")
    require(sx.dtype == torch.float32 and sx.numel() == 1,
            "sx must be one f32 element")
    require(sw.dtype == torch.float32 and sw.numel() == n
            and sw.is_contiguous(), f"sw must be {n} contiguous f32")
    _check_bits(bits)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _FUSED(x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
           int(w.dtype == torch.bfloat16), sx.data_ptr(), sw.data_ptr(),
           out.data_ptr(), m, k, n, bits, int(compensated), stream_of(x))
    return out
