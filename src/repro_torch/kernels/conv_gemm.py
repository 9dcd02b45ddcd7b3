"""Implicit-GEMM CiM convolution: CUDA kernels for Hopper and their plain
versions.

A (kh, kw, stride) convolution under kh//2, kw//2 zero padding (SAME at
stride 1) is a GEMM with

    M = B*OH*OW   (batch-major output pixels)
    K = kh*kw*C   (tap-major, then channel: the im2col column order)
    N = C_out

Three fused-quantization entry points, as in the JAX package (f32 x
(B, H, W, C) and f32 w3 (kh*kw, C, N) in, f32 (B, OH, OW, N) out, the
per-tensor ``sx`` / per-out-channel ``sw`` quantization on load and the
``(acc * sx) * sw`` epilogue inside one kernel):

  * ``conv_lut_fused`` — the full signed-product table, or the nibble
    sub-tables (``nibble=True``);
  * ``conv_log_fused`` — the Mitchell / Log-our log-domain product;
  * ``conv_mxu_fused`` — the exact product (exact mode) on the int8
    tensor cores, summed exactly in int32 where the reference summed the
    dequantized products in f32 per tap: the two differ by f32 rounding
    only.

and the mesh path's two partial forms, the LUT and log forms with the
epilogue off (``conv_lut_partial`` with ``nibble=``, ``conv_log_partial``):
an image and tap stack over a slice of the input channels, quantized
against caller-supplied (global) scales, the raw int32 (B, OH, OW, N)
sum out; the caller sums the shards' partials and applies the epilogue.

The LUT and log integer cores are bit-identical to im2col + the GEMM
kernels.  On CUDA tensors each launches csrc/conv_gemm.cu or raises; the
kernel gathers the patch matrix from the image by index arithmetic, so
neither a padded plane nor an im2col tensor is held anywhere.  On CPU
tensors each runs its plain version below (pad, then per tap: quantize
the shifted window and the weight tap, and add its gather, log or exact
integer sum), bit-identical to the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core.approx_gemm import conv_out_hw

from .approx_matmul import check_table, check_subs
from .build import INT, PTR, CudaKernel, on_cuda, require, stream_of
from .ref import (gather_full, int_dot, log_sum, nibble_sum, quantize_tile,
                  taps)

_LUT = CudaKernel("conv_gemm", "conv_lut_fused",
                  [PTR] * 6 + [INT] * 11 + [PTR])
_LOG = CudaKernel("conv_gemm", "conv_log_fused",
                  [PTR] * 5 + [INT] * 11 + [PTR])
_MXU = CudaKernel("conv_gemm", "conv_mxu_fused",
                  [PTR] * 5 + [INT] * 10 + [PTR])
_LUT_PARTIAL = CudaKernel("conv_gemm", "conv_lut_partial",
                          [PTR] * 6 + [INT] * 11 + [PTR])
_LOG_PARTIAL = CudaKernel("conv_gemm", "conv_log_partial",
                          [PTR] * 5 + [INT] * 11 + [PTR])

KERNELS = {"conv_lut_fused": _LUT, "conv_log_fused": _LOG,
           "conv_mxu_fused": _MXU, "conv_lut_partial": _LUT_PARTIAL,
           "conv_log_partial": _LOG_PARTIAL}

# output pixels x channel chunk x out-channels per block: BM, BK, BN of
# csrc/cim_gemm.cuh, fixed at compile time, and the outputs each thread
# accumulates per K step (its RPT)
TILE = (16, 32, 64)
ROWS_PER_THREAD = 4
# the exact core's tensor-core block (csrc/int8_mma.cuh): the int8 halo
# bytes, the weight tile's K bytes a group and its output channels
MXU_HALO, MXU_KCAP, MXU_BN = 16384, 576, 64
# the most taps it takes: one output pixel's halo, a 4-channel word a
# tap, must fit the int8 halo (plan_conv sends larger kernels to
# conv_im2col)
MXU_MAX_TAPS = MXU_HALO // 4


def _al(n: int) -> int:
    return (n + 15) // 16 * 16


def gemm_smem_bytes(core: str, bits: int) -> int:
    """Dynamic shared memory of one block of a conv kernel for `core`
    ("lut", "nibble", "log" or "mxu").  For cim_gemm.cuh's kernel: the
    table, then the staged A (BM x BK) and B (BK x BN) tiles (the full
    table's int32 row offsets and int16 column indices; int4 nibble
    offsets or log decompositions).  For the exact core, int8_mma.cuh's
    tensor-core kernel: the int8 input halo, the int8 K-major weight tile
    (MXU_BN rows of MXU_KCAP bytes, each padded by 16) and one int offset
    a k word, 54,848 bytes whatever the geometry and the width (the
    kernel takes channels in chunks and taps in groups to fit it)."""
    if core == "mxu":
        return MXU_HALO + MXU_BN * (MXU_KCAP + 16) + MXU_KCAP
    bm, bk, bn = TILE
    if core == "lut":
        return _al((1 << (2 * bits)) * 2) + _al(4 * bm * bk) + 2 * bk * bn
    if core == "nibble":
        return _al(16 << bits) + _al(16 * bm * bk) + 16 * bk * bn
    if core == "log":
        return _al(16 * bm * bk) + 16 * bk * bn
    raise ValueError(f"unknown core {core!r}")


def _geometry(x, w3, kh: int, kw: int, stride: int):
    require(kh % 2 == 1 and kw % 2 == 1,
            f"even conv kernels ({kh}x{kw}) need asymmetric padding, which "
            "the symmetric kh//2 scheme cannot express")
    require(stride >= 1, f"stride must be >= 1, got {stride}")
    require(x.dim() == 4 and w3.dim() == 3,
            f"x (B,H,W,C) and w3 (kh*kw,C,N) expected, got "
            f"{tuple(x.shape)}, {tuple(w3.shape)}")
    b, h, w, c = x.shape
    require(tuple(w3.shape[:2]) == (kh * kw, c),
            f"w3 {tuple(w3.shape)} does not match {kh}x{kw} taps over {c} "
            "channels")
    return b, h, w, c, w3.shape[2]


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; chip_smoke.py also runs them on the card)
# ---------------------------------------------------------------------------


def _conv_plain(x, w3, sx, sw, bits, kh, kw, stride, tap_sum,
                epilogue: bool = True):
    b, h, w, c, n = _geometry(x, w3, kh, kw, stride)
    oh, ow = conv_out_hw(h, w, kh, kw, stride)
    qmax = (1 << (bits - 1)) - 1
    sx = sx.reshape(()).to(torch.float32)
    sw = sw.reshape(1, -1).to(torch.float32)
    xp = torch.nn.functional.pad(x.to(torch.float32),
                                 (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    acc = torch.zeros((b * oh * ow, n), dtype=torch.int32, device=x.device)
    for t, a2 in taps(xp, kh, kw, oh, ow, stride):
        aq = quantize_tile(a2, sx, qmax)
        bq = quantize_tile(w3[t].to(torch.float32), sw, qmax)
        acc += tap_sum(aq, bq)
    if not epilogue:
        return acc.reshape(b, oh, ow, n)
    return ((acc.to(torch.float32) * sx) * sw).reshape(b, oh, ow, n)


def _lut_tap_sum(table, bits: int, nibble: bool):
    half = 1 << (bits - 1)
    if nibble:
        def tap_sum(aq, bq):
            return nibble_sum(table, aq, bq, bits)
    else:
        def tap_sum(aq, bq):
            return gather_full(table, aq + half, bq + half, 1 << bits)
    return tap_sum


def conv_lut_fused_plain(x, w3, table, sx, sw, bits: int = 8, kh: int = 3,
                         kw: int = 3, stride: int = 1,
                         nibble: bool = False) -> torch.Tensor:
    return _conv_plain(x, w3, sx, sw, bits, kh, kw, stride,
                       _lut_tap_sum(table, bits, nibble))


def conv_lut_partial_plain(x, w3, table, sx, sw, bits: int = 8, kh: int = 3,
                           kw: int = 3, stride: int = 1,
                           nibble: bool = False) -> torch.Tensor:
    return _conv_plain(x, w3, sx, sw, bits, kh, kw, stride,
                       _lut_tap_sum(table, bits, nibble), epilogue=False)


def conv_mxu_fused_plain(x, w3, sx, sw, bits: int = 8, kh: int = 3,
                         kw: int = 3, stride: int = 1) -> torch.Tensor:
    return _conv_plain(x, w3, sx, sw, bits, kh, kw, stride, int_dot)


def conv_log_fused_plain(x, w3, sx, sw, bits: int = 8,
                         compensated: bool = True, kh: int = 3, kw: int = 3,
                         stride: int = 1) -> torch.Tensor:
    def tap_sum(aq, bq):
        return log_sum(aq, bq, bits, compensated)
    return _conv_plain(x, w3, sx, sw, bits, kh, kw, stride, tap_sum)


def conv_log_partial_plain(x, w3, sx, sw, bits: int = 8,
                           compensated: bool = True, kh: int = 3,
                           kw: int = 3, stride: int = 1) -> torch.Tensor:
    def tap_sum(aq, bq):
        return log_sum(aq, bq, bits, compensated)
    return _conv_plain(x, w3, sx, sw, bits, kh, kw, stride, tap_sum,
                       epilogue=False)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_operands(x, w3, sx, sw, n: int) -> None:
    require(x.dtype == torch.float32 and w3.dtype == torch.float32,
            f"f32 operands expected, got {x.dtype}, {w3.dtype}")
    require(x.is_contiguous() and w3.is_contiguous(),
            "operands must be contiguous")
    require(sx.dtype == torch.float32 and sx.numel() == 1,
            "sx must be one f32 element")
    require(sw.dtype == torch.float32 and sw.numel() == n
            and sw.is_contiguous(), f"sw must be {n} contiguous f32")


def _launch_lut(kern: CudaKernel, x, w3, table, sx, sw, bits, kh, kw,
                stride, nibble, out_dtype):
    b, h, w, c, n = _geometry(x, w3, kh, kw, stride)
    _check_operands(x, w3, sx, sw, n)
    if nibble:
        check_subs(table, bits)
    else:
        check_table(table, bits)
    oh, ow = conv_out_hw(h, w, kh, kw, stride)
    out = torch.empty((b, oh, ow, n), dtype=out_dtype, device=x.device)
    kern(x.data_ptr(), w3.data_ptr(), table.data_ptr(), sx.data_ptr(),
         sw.data_ptr(), out.data_ptr(), b, h, w, c, n, kh, kw, stride, bits,
         int(nibble), gemm_smem_bytes("nibble" if nibble else "lut", bits),
         stream_of(x))
    return out


def conv_lut_fused(x: torch.Tensor, w3: torch.Tensor, table: torch.Tensor,
                   sx: torch.Tensor, sw: torch.Tensor, bits: int = 8,
                   kh: int = 3, kw: int = 3, stride: int = 1,
                   nibble: bool = False) -> torch.Tensor:
    """LUT-family implicit-GEMM conv: f32 x (B,H,W,C), w3 (kh*kw,C,N) ->
    f32 (B,OH,OW,N).  ``table`` is the int16 full signed-product table
    (``nibble=False``) or the raveled int32 nibble sub-tables
    (``nibble=True``); ``sx`` one f32 element, ``sw`` N f32.
    Bit-identical integer core to im2col + ``lut_matmul`` /
    ``nibble_lut_matmul``."""
    _geometry(x, w3, kh, kw, stride)
    if not on_cuda(x, w3, table, sx, sw):
        return conv_lut_fused_plain(x, w3, table, sx, sw, bits, kh, kw,
                                    stride, nibble)
    return _launch_lut(_LUT, x, w3, table, sx, sw, bits, kh, kw, stride,
                       nibble, torch.float32)


def conv_lut_partial(x: torch.Tensor, w3: torch.Tensor, table: torch.Tensor,
                     sx: torch.Tensor, sw: torch.Tensor, bits: int = 8,
                     kh: int = 3, kw: int = 3, stride: int = 1,
                     nibble: bool = False) -> torch.Tensor:
    """Shard-local LUT-family conv over a slice of the input channels:
    f32 x (B,H,W,C_shard), w3 (kh*kw,C_shard,N) -> the raw int32
    (B,OH,OW,N) sum, quantized on load against the supplied global
    scales; tables as ``conv_lut_fused``.  The caller sums the shards'
    partials and applies the epilogue."""
    _geometry(x, w3, kh, kw, stride)
    if not on_cuda(x, w3, table, sx, sw):
        return conv_lut_partial_plain(x, w3, table, sx, sw, bits, kh, kw,
                                      stride, nibble)
    return _launch_lut(_LUT_PARTIAL, x, w3, table, sx, sw, bits, kh, kw,
                       stride, nibble, torch.int32)


def _launch_log(kern: CudaKernel, x, w3, sx, sw, bits, compensated, kh, kw,
                stride, out_dtype):
    b, h, w, c, n = _geometry(x, w3, kh, kw, stride)
    _check_operands(x, w3, sx, sw, n)
    require(2 <= bits <= 16,
            f"the log kernel takes 2..16-bit operands, got {bits}")
    oh, ow = conv_out_hw(h, w, kh, kw, stride)
    out = torch.empty((b, oh, ow, n), dtype=out_dtype, device=x.device)
    kern(x.data_ptr(), w3.data_ptr(), sx.data_ptr(), sw.data_ptr(),
         out.data_ptr(), b, h, w, c, n, kh, kw, stride, bits,
         int(compensated), gemm_smem_bytes("log", bits), stream_of(x))
    return out


def conv_log_fused(x: torch.Tensor, w3: torch.Tensor, sx: torch.Tensor,
                   sw: torch.Tensor, bits: int = 8, compensated: bool = True,
                   kh: int = 3, kw: int = 3, stride: int = 1) -> torch.Tensor:
    """Log-family implicit-GEMM conv (mitchell, or log_our when
    `compensated`): shapes and scales as ``conv_lut_fused``.
    Bit-identical integer core to im2col + ``mitchell_matmul``."""
    _geometry(x, w3, kh, kw, stride)
    if not on_cuda(x, w3, sx, sw):
        return conv_log_fused_plain(x, w3, sx, sw, bits, compensated, kh, kw,
                                    stride)
    return _launch_log(_LOG, x, w3, sx, sw, bits, compensated, kh, kw,
                       stride, torch.float32)


def conv_log_partial(x: torch.Tensor, w3: torch.Tensor, sx: torch.Tensor,
                     sw: torch.Tensor, bits: int = 8,
                     compensated: bool = True, kh: int = 3, kw: int = 3,
                     stride: int = 1) -> torch.Tensor:
    """Shard-local log-family conv over a slice of the input channels:
    shapes as ``conv_lut_partial``, the raw int32 sum out."""
    _geometry(x, w3, kh, kw, stride)
    if not on_cuda(x, w3, sx, sw):
        return conv_log_partial_plain(x, w3, sx, sw, bits, compensated, kh,
                                      kw, stride)
    return _launch_log(_LOG_PARTIAL, x, w3, sx, sw, bits, compensated, kh,
                       kw, stride, torch.int32)


def conv_mxu_fused(x: torch.Tensor, w3: torch.Tensor, sx: torch.Tensor,
                   sw: torch.Tensor, bits: int = 8, kh: int = 3, kw: int = 3,
                   stride: int = 1) -> torch.Tensor:
    """Exact-family implicit-GEMM conv (exact mode): shapes and scales as
    ``conv_lut_fused``; the exact integer products summed in int32, then
    ``(acc * sx) * sw``."""
    b, h, w, c, n = _geometry(x, w3, kh, kw, stride)
    if not on_cuda(x, w3, sx, sw):
        return conv_mxu_fused_plain(x, w3, sx, sw, bits, kh, kw, stride)
    _check_operands(x, w3, sx, sw, n)
    require(2 <= bits <= 8,
            f"the exact conv kernel takes 2..8-bit operands, got {bits}")
    require(kh * kw <= MXU_MAX_TAPS,
            f"the exact conv kernel takes at most {MXU_MAX_TAPS} taps (one "
            f"pixel's halo), got {kh}x{kw}")
    oh, ow = conv_out_hw(h, w, kh, kw, stride)
    out = torch.empty((b, oh, ow, n), dtype=torch.float32, device=x.device)
    _MXU(x.data_ptr(), w3.data_ptr(), sx.data_ptr(), sw.data_ptr(),
         out.data_ptr(), b, h, w, c, n, kh, kw, stride, bits,
         gemm_smem_bytes("mxu", bits), stream_of(x))
    return out
