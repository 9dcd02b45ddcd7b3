"""Public per-kernel entry points of the kernel layer (GEMM and CiM
attention).

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
from typing import Optional

import numpy as np
import torch

from repro_torch.core.autotune import heuristic_attn_block
from repro_torch.core.luts import nibble_sub_luts, signed_product_lut
from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.core.quantization import quant_scale

from .approx_matmul import lut_matmul, lut_matmul_fused
from .attn_gemm import (attn_fused, attn_materialized, attn_reference,
                        attn_scales)
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


# ---------------------------------------------------------------------------
# Flash-style CiM attention (kernels/attn_gemm.py).
#
# All three wrappers share one signature: q (B, H, Sq, D) and k/v
# (B, KH, Skv, D) float operands in the head-major kernel layout, qpos
# (B, Sq) / kpos, kval (B, Skv) int32 position/validity operands, and a
# `path` selecting the inner-dot datapath.  The per-(batch, head) scales
# are computed here (attn_gemm.attn_scales), outside the kernels, as in
# the reference; `block` defaults to the reference's heuristic block.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _subs_np(family: str, bits: int, compressor: str, n_approx) -> np.ndarray:
    spec = MultiplierSpec(family, bits, True, compressor, n_approx)
    subs = nibble_sub_luts(spec)
    if subs is None:
        raise ValueError(
            f"{spec.short_name()} is not nibble-decomposable; route to the "
            "full-LUT kernel")
    return subs.ravel()


@functools.lru_cache(maxsize=32)
def _subs_on(key, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_subs_np(*key)).to(device)


def _attn_table(path: str, spec: Optional[MultiplierSpec], device):
    """The path's table on `device`: the int16 full table (lut), the
    int32 sub-tables (nibble), or None."""
    if path in ("lut", "nibble"):
        if spec is None:
            raise ValueError(f"attention path {path!r} needs a "
                             "MultiplierSpec to build its table")
        if path == "lut":
            return lut_table(spec, device)
        key = (spec.family, spec.bits, spec.compressor, spec.n_approx_cols)
        return _subs_on(key, torch.device(device))
    return None


def _attn_args(q, k, v, path, spec, bits, block, kernel=None):
    bits = spec.bits if spec is not None else bits
    if block is None:
        block = heuristic_attn_block(kernel or f"pallas_attn_{path}",
                                     q.shape[2], k.shape[2])
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    sq_s, sk_s, sv_s = attn_scales(qf, kf, vf, bits)
    return (qf, kf, vf, sq_s, sk_s, sv_s, _attn_table(path, spec, q.device),
            bits, tuple(block))


def cim_attn_fused(q, k, v, qpos, kpos, kval, *, path: str,
                   spec: Optional[MultiplierSpec] = None, bits: int = 8,
                   causal: bool = True, window: Optional[int] = None,
                   compensated: bool = True, block=None):
    """One-pass flash attention through the approximate datapath (the
    CUDA kernel on CUDA tensors, its plain version on CPU tensors)."""
    qf, kf, vf, sq_s, sk_s, sv_s, tab, bits, block = _attn_args(
        q, k, v, path, spec, bits, block)
    return attn_fused(qf, kf, vf, sq_s, sk_s, sv_s, qpos, kpos, kval, tab,
                      path=path, bits=bits, causal=causal, window=window,
                      compensated=compensated, block=block)


def cim_attn_materialized(q, k, v, qpos, kpos, kval, *, path: str,
                          spec: Optional[MultiplierSpec] = None,
                          bits: int = 8, causal: bool = True,
                          window: Optional[int] = None,
                          compensated: bool = True, block=None):
    """The bit-exact materialized oracle: same math, the masked score
    tensor through device memory."""
    qf, kf, vf, sq_s, sk_s, sv_s, tab, bits, block = _attn_args(
        q, k, v, path, spec, bits, block)
    return attn_materialized(qf, kf, vf, sq_s, sk_s, sv_s, qpos, kpos,
                             kval, tab, path=path, bits=bits, causal=causal,
                             window=window, compensated=compensated,
                             block=block)


def cim_attn_reference(q, k, v, qpos, kpos, kval, *, path: str,
                       spec: Optional[MultiplierSpec] = None,
                       bits: int = 8, causal: bool = True,
                       window: Optional[int] = None,
                       compensated: bool = True, block=None):
    """The plain version on any device (the ``torch_attn`` runner for
    bit_exact, the twin of the reference's ``attn_xla``)."""
    qf, kf, vf, sq_s, sk_s, sv_s, tab, bits, block = _attn_args(
        q, k, v, path, spec, bits, block, kernel="attn_xla")
    return attn_reference(qf, kf, vf, sq_s, sk_s, sv_s, qpos, kpos, kval,
                          tab, path=path, bits=bits, causal=causal,
                          window=window, compensated=compensated,
                          block=block)
