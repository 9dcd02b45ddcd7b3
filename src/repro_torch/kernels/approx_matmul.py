"""Full-LUT gather GEMMs: CUDA kernels for Hopper and their plain versions.

The compiled CiM macro *is* a product LUT (core/luts.py); these
functions execute it.  Two entry points, as in the JAX package:

  * ``lut_matmul``       — int8 operands -> int32 (the oracle surface);
  * ``lut_matmul_fused`` — float operands (f32 or bf16) -> f32, with the
    per-tensor ``sx`` / per-column ``sw`` quantization on load and the
    ``(acc * sx) * sw`` epilogue inside one kernel.

On CUDA tensors each launches its kernel (csrc/lut_gemm.cu) or raises;
on CPU tensors it runs the plain PyTorch version beside it, which
repeats the kernel's arithmetic (kernels/ref.py).  The table is the
int16 signed-product table of kernels/ops.py (the 8-bit table fits
shared memory only as int16; every entry is checked to fit).
"""

from __future__ import annotations

import torch

from .build import INT, PTR, CudaKernel, on_cuda, require, stream_of
from .ref import gather_full, lut_matmul_ref, quantize_tile

_INT = CudaKernel("lut_gemm", "lut_gemm_int8",
                  [PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR])
_FUSED = CudaKernel("lut_gemm", "lut_gemm_fused",
                    [PTR, INT, PTR, INT, PTR, PTR, PTR, PTR, INT, INT, INT,
                     INT, PTR])

# the kernels of this module by wrapper name (chip_smoke.py reads and
# resets their launch counts)
KERNELS = {"lut_matmul": _INT, "lut_matmul_fused": _FUSED}

_FLOATS = (torch.float32, torch.bfloat16)


def _shapes(x: torch.Tensor, w: torch.Tensor):
    require(x.dim() == 2 and w.dim() == 2,
            f"2-D operands expected, got {tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    k2, n = w.shape
    require(k == k2, f"contraction mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    return m, k, n


def _check_table(lut: torch.Tensor, bits: int) -> None:
    require(2 <= bits <= 8, f"the LUT kernel takes 2..8-bit operands, got {bits}")
    require(lut.dtype == torch.int16 and lut.is_contiguous()
            and lut.numel() == 1 << (2 * bits),
            f"table must be {1 << (2 * bits)} contiguous int16 entries")
    require(lut.data_ptr() % 16 == 0, "table must be 16-byte aligned")


def _check_range(t: torch.Tensor, bits: int) -> None:
    """Operands index the table, so they must lie in [-2^{b-1}, 2^{b-1})
    (always so for int8 at 8 bits, which needs no reduction)."""
    if (t.dtype == torch.int8 and bits == 8) or t.numel() == 0:
        return
    half = 1 << (bits - 1)
    require(-half <= int(t.min()) and int(t.max()) < half,
            f"{bits}-bit operands must lie in [{-half}, {half})")


# ---------------------------------------------------------------------------
# plain version of the fused form (the int form's is ref.lut_matmul_ref);
# CPU tensors, and chip_smoke.py also runs them on the card
# ---------------------------------------------------------------------------


def lut_matmul_fused_plain(x, w, lut_flat, sx, sw,
                           bits: int = 8) -> torch.Tensor:
    half = 1 << (bits - 1)
    sx = sx.reshape(()).to(torch.float32)
    sw = sw.reshape(1, -1).to(torch.float32)
    ia = quantize_tile(x.to(torch.float32), sx, half - 1) + half
    ib = quantize_tile(w.to(torch.float32), sw, half - 1) + half
    acc = gather_full(lut_flat, ia, ib, 1 << bits)
    return (acc.to(torch.float32) * sx) * sw


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def lut_matmul(xq: torch.Tensor, wq: torch.Tensor, lut_flat: torch.Tensor,
               bits: int = 8) -> torch.Tensor:
    """Bit-exact signed LUT GEMM: int8 xq (M,K), wq (K,N) -> int32 (M,N).

    Operands must lie in [-2^{b-1}, 2^{b-1}) (checked: outside it the
    kernel would read past its table); -2^{b-1} indexes the table's
    saturating row exactly as ``ref.lut_matmul_ref`` does."""
    m, k, n = _shapes(xq, wq)
    cuda = on_cuda(xq, wq, lut_flat)
    _check_range(xq, bits)
    _check_range(wq, bits)
    if not cuda:
        return lut_matmul_ref(xq, wq, lut_flat, bits)
    require(xq.dtype == torch.int8 and wq.dtype == torch.int8,
            f"int8 operands expected, got {xq.dtype}, {wq.dtype}")
    require(xq.is_contiguous() and wq.is_contiguous(),
            "operands must be contiguous")
    _check_table(lut_flat, bits)
    out = torch.empty((m, n), dtype=torch.int32, device=xq.device)
    _INT(xq.data_ptr(), wq.data_ptr(), lut_flat.data_ptr(), out.data_ptr(),
         m, k, n, bits, stream_of(xq))
    return out


def lut_matmul_fused(x: torch.Tensor, w: torch.Tensor, lut_flat: torch.Tensor,
                     sx: torch.Tensor, sw: torch.Tensor,
                     bits: int = 8) -> torch.Tensor:
    """Fused-quantization LUT GEMM: f32/bf16 x (M,K), w (K,N) -> f32 (M,N).

    ``sx`` is the per-tensor scale (one element), ``sw`` the per-column
    scale (N elements); both f32 on the operands' device.  Bit-identical
    to quantize -> ``lut_matmul`` -> ``(acc * sx) * sw``."""
    m, k, n = _shapes(x, w)
    if not on_cuda(x, w, lut_flat, sx, sw):
        return lut_matmul_fused_plain(x, w, lut_flat, sx, sw, bits)
    require(x.dtype in _FLOATS and w.dtype in _FLOATS,
            f"f32/bf16 operands expected, got {x.dtype}, {w.dtype}")
    require(x.is_contiguous() and w.is_contiguous(),
            "operands must be contiguous")
    require(sx.dtype == torch.float32 and sx.numel() == 1,
            "sx must be one f32 element")
    require(sw.dtype == torch.float32 and sw.numel() == n
            and sw.is_contiguous(), f"sw must be {n} contiguous f32")
    _check_table(lut_flat, bits)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _FUSED(x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
           int(w.dtype == torch.bfloat16), lut_flat.data_ptr(), sx.data_ptr(),
           sw.data_ptr(), out.data_ptr(), m, k, n, bits, stream_of(x))
    return out
