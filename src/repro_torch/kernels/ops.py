"""Public per-kernel entry points for the GEMM half of the kernel layer.

Routing across kernels lives in the registry (core/approx_gemm.py);
these wrappers resolve a multiplier spec to its product table, compute
the quantization scales as plain torch reductions outside the kernel
(``sx = max|x| / qmax`` per tensor, ``sw = max|w[:, n]| / qmax`` per
column, as the reference's ``_scales``), and call the kernel wrappers of
approx_matmul.py / mitchell_gemm.py, which pick the CUDA kernel or the
plain version by the operands' device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.luts import signed_product_lut
from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.core.quantization import quant_scale

from .approx_matmul import lut_matmul, lut_matmul_fused
from .mitchell_gemm import mitchell_matmul, mitchell_matmul_fused


@functools.lru_cache(maxsize=16)
def _lut16_np(family: str, bits: int, compressor: str, n_approx) -> np.ndarray:
    """The flat signed product table narrowed to int16.

    At 8 bits the int32 table (256 KiB) does not fit a Hopper block's
    shared memory; int16 (128 KiB) does.  Every entry is checked to fit,
    and a table that does not raises here, on the host, before any
    kernel sees it."""
    spec = MultiplierSpec(family, bits, True, compressor, n_approx)
    table = signed_product_lut(spec).ravel()
    lo, hi = int(table.min()), int(table.max())
    if lo < np.iinfo(np.int16).min or hi > np.iinfo(np.int16).max:
        raise ValueError(
            f"{spec.short_name()}: product table range [{lo}, {hi}] does "
            "not fit int16, the shared-memory form of the LUT kernel")
    return table.astype(np.int16)


@functools.lru_cache(maxsize=32)
def _lut_on(key, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_lut16_np(*key)).to(device)


def lut_table(spec: MultiplierSpec, device) -> torch.Tensor:
    """The spec's int16 signed-product table on `device` (cached)."""
    key = (spec.family, spec.bits, spec.compressor, spec.n_approx_cols)
    return _lut_on(key, torch.device(device))


def _scales(x: torch.Tensor, w: torch.Tensor, bits: int):
    """(sx, sw): per-tensor f32 scalar and per-column f32 (N,) scales of
    the f32-widened operands.  The column max of a bf16 weight is taken
    in bf16 and widened after (exact), so the weight is never copied."""
    sx = quant_scale(x.to(torch.float32), bits)
    colmax = w.abs().amax(dim=0, keepdim=True).to(torch.float32)   # (1, N)
    sw = quant_scale(colmax, bits, axis=0).reshape(-1)
    return sx, sw


def approx_matmul_bit_exact(xq, wq, spec: MultiplierSpec) -> torch.Tensor:
    """Bit-exact LUT GEMM for any LUT-representable multiplier (int8 in,
    int32 out)."""
    return lut_matmul(xq, wq, lut_table(spec, xq.device), bits=spec.bits)


def approx_matmul_fused(x, w, spec: MultiplierSpec) -> torch.Tensor:
    """Fused-quantization full-LUT GEMM: float in -> f32 out, one pass."""
    sx, sw = _scales(x, w, spec.bits)
    return lut_matmul_fused(x, w, lut_table(spec, x.device), sx, sw,
                            bits=spec.bits)


def log_matmul(xq, wq, bits: int = 8, compensated: bool = True):
    """Arithmetic log-domain GEMM (mitchell / log_our), int8 in."""
    return mitchell_matmul(xq, wq, bits=bits, compensated=compensated)


def log_matmul_fused(x, w, bits: int = 8, compensated: bool = True):
    """Fused-quantization log-domain GEMM: float in -> f32 out."""
    sx, sw = _scales(x, w, bits)
    return mitchell_matmul_fused(x, w, sx, sw, bits=bits,
                                 compensated=compensated)
