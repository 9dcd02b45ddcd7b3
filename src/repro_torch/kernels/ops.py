"""Public per-kernel entry points of the kernel layer (GEMM, surrogate
GEMM, implicit-GEMM conv and CiM attention).

Routing across kernels lives in the registry (core/approx_gemm.py);
these wrappers resolve a multiplier spec to its product table (the int16
full table, the int32 nibble sub-tables, or, faulted, the uint16 table of
magnitude products), compute the quantization
scales as plain torch reductions outside the kernel (``sx = max|x| /
qmax`` per tensor, ``sw = max|w[:, n]| / qmax`` per column, as the
reference's ``_scales``), and call the kernel wrappers of
approx_matmul.py / mitchell_gemm.py / cim_gemm.py / conv_gemm.py /
attn_gemm.py, which pick the CUDA kernel or the plain version by the
operands' device.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.core.autotune import heuristic_attn_block
from repro_torch.core.luts import nibble_sub_luts, signed_product_lut
from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.core.quantization import quant_scale

from .approx_matmul import (lut_matmul, lut_matmul_fused, lut_matmul_mag,
                            lut_matmul_partial, mag_entries,
                            nibble_lut_matmul, nibble_lut_matmul_fused,
                            nibble_lut_matmul_partial)
from .attn_gemm import (attn_fused, attn_materialized, attn_reference,
                        attn_scales)
from .cim_gemm import cim_gemm_core, cim_gemm_fused, stochastic
from .conv_gemm import (conv_log_fused, conv_log_partial, conv_lut_fused,
                        conv_lut_partial, conv_mxu_fused)
from .mitchell_gemm import (mitchell_matmul, mitchell_matmul_fused,
                            mitchell_matmul_partial)
from .ref import surrogate_epilogue


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


@functools.lru_cache(maxsize=16)
def _mag_np(key, fault) -> np.ndarray:
    """The magnitude table of `lut_matmul_mag` (faulted with `fault`,
    clean for None), uint16, zero-padded to `mag_entries`.  Every entry
    is checked to fit, on the host, before any kernel sees it."""
    tab = faults.magnitude_table(key, fault)
    lo, hi = int(tab.min()), int(tab.max())
    if lo < 0 or hi > np.iinfo(np.uint16).max:
        raise ValueError(
            f"{key}: magnitude table range [{lo}, {hi}] does not fit "
            "uint16, the shared-memory form of the magnitude-table kernel")
    out = np.zeros(mag_entries(key[1]), np.uint16)
    out[:tab.size] = tab
    return out


@functools.lru_cache(maxsize=32)
def _mag_on(key, fault, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_mag_np(key, fault)).to(device)


def magnitude_lut(spec: MultiplierSpec, fault, device) -> torch.Tensor:
    """The spec's uint16 magnitude table on `device` (cached), faulted
    with `fault` (a core.faults.FaultConfig), clean for None."""
    key = (spec.family, spec.bits, spec.compressor, spec.n_approx_cols)
    return _mag_on(key, fault, torch.device(device))


@functools.lru_cache(maxsize=32)
def _faulted_lut_on(key, fault, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(faults.faulted_signed_lut_flat(key, fault)).to(
        device)


def faulted_lut_table(spec: MultiplierSpec, fault, device) -> torch.Tensor:
    """The spec's faulted signed-product table, int32, on `device`
    (cached): the table of the plain gather oracle (bit_exact)."""
    key = (spec.family, spec.bits, spec.compressor, spec.n_approx_cols)
    return _faulted_lut_on(key, fault, torch.device(device))


@functools.lru_cache(maxsize=16)
def _subs_np(family: str, bits: int, compressor: str, n_approx) -> np.ndarray:
    """The four nibble sub-tables, raveled, as int32: the one storage form
    of every nibble kernel (GEMM, conv, attention).  Four entries add up
    to one product, so the largest four must sum below 2^31; a table
    that does not raises here, on the host."""
    spec = MultiplierSpec(family, bits, True, compressor, n_approx)
    subs = nibble_sub_luts(spec)
    if subs is None:
        raise ValueError(
            f"{spec.short_name()} is not nibble-decomposable; route to the "
            "full-LUT kernel")
    worst = int(subs.astype(np.int64).reshape(4, -1).max(axis=1).sum())
    if int(subs.min()) < 0 or worst > np.iinfo(np.int32).max:
        raise ValueError(
            f"{spec.short_name()}: nibble sub-tables are negative or sum "
            f"past int32 ({worst})")
    return subs.astype(np.int32).ravel()


@functools.lru_cache(maxsize=32)
def _subs_on(key, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_subs_np(*key)).to(device)


def nibble_table(spec: MultiplierSpec, device) -> torch.Tensor:
    """The spec's raveled int32 nibble sub-tables on `device` (cached);
    raises ValueError for a spec that is not nibble-decomposable."""
    key = (spec.family, spec.bits, spec.compressor, spec.n_approx_cols)
    return _subs_on(key, torch.device(device))


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


def approx_matmul_faulted(xq, wq, spec: MultiplierSpec,
                          fault) -> torch.Tensor:
    """Bit-exact LUT GEMM over the spec's faulted table (int8 in, int32
    out): the magnitude-table kernel."""
    return lut_matmul_mag(xq, wq, magnitude_lut(spec, fault, xq.device),
                          bits=spec.bits)


def approx_matmul_fused(x, w, spec: MultiplierSpec) -> torch.Tensor:
    """Fused-quantization full-LUT GEMM: float in -> f32 out, one pass."""
    sx, sw = _scales(x, w, spec.bits)
    return lut_matmul_fused(x, w, lut_table(spec, x.device), sx, sw,
                            bits=spec.bits)


def nibble_matmul_bit_exact(xq, wq, spec: MultiplierSpec) -> torch.Tensor:
    """Bit-exact nibble-decomposed GEMM (int8 in, int32 out); the spec
    must be decomposable (routing guarantees it)."""
    return nibble_lut_matmul(xq, wq, nibble_table(spec, xq.device),
                             bits=spec.bits)


def nibble_matmul_fused(x, w, spec: MultiplierSpec) -> torch.Tensor:
    """Fused-quantization nibble GEMM: float in -> f32 out, one pass."""
    sx, sw = _scales(x, w, spec.bits)
    return nibble_lut_matmul_fused(x, w, nibble_table(spec, x.device), sx,
                                   sw, bits=spec.bits)


def log_matmul(xq, wq, bits: int = 8, compensated: bool = True):
    """Arithmetic log-domain GEMM (mitchell / log_our), int8 in."""
    return mitchell_matmul(xq, wq, bits=bits, compensated=compensated)


def log_matmul_fused(x, w, bits: int = 8, compensated: bool = True):
    """Fused-quantization log-domain GEMM: float in -> f32 out."""
    sx, sw = _scales(x, w, bits)
    return mitchell_matmul_fused(x, w, sx, sw, bits=bits,
                                 compensated=compensated)


# ---------------------------------------------------------------------------
# Shard-local (deferred-epilogue) wrappers: the tensor-parallel entry
# points of the mesh path (core/approx_gemm.py's MeshPlan).  All take the
# *global* quantization scales explicitly (a shard sees only a slice of K
# or N, so scales taken locally would diverge from the single-device
# oracle) and return the raw int32 accumulator.
# ---------------------------------------------------------------------------


def lut_partial_acc(x, w, spec: MultiplierSpec, sx, sw) -> torch.Tensor:
    """Shard-local full-LUT GEMM: float in + global scales -> int32."""
    return lut_matmul_partial(x, w, lut_table(spec, x.device), sx, sw,
                              bits=spec.bits)


def nibble_partial_acc(x, w, spec: MultiplierSpec, sx, sw) -> torch.Tensor:
    """Shard-local nibble GEMM: float in + global scales -> int32."""
    return nibble_lut_matmul_partial(x, w, nibble_table(spec, x.device), sx,
                                     sw, bits=spec.bits)


def log_partial_acc(x, w, sx, sw, bits: int = 8,
                    compensated: bool = True) -> torch.Tensor:
    """Shard-local log-domain GEMM: float in + global scales -> int32."""
    return mitchell_matmul_partial(x, w, sx, sw, bits=bits,
                                   compensated=compensated)


# The output-sharded layout's fused forms with caller-supplied global
# scales: no collective separates quantization from the epilogue, so the
# (acc * sx) * sw flush stays inside the kernel (a shard sees only its
# columns, so `sw` arrives as the shard's slice).


def lut_fused_scaled(x, w, spec: MultiplierSpec, sx, sw) -> torch.Tensor:
    """Fused full-LUT GEMM with caller-supplied global scales."""
    return lut_matmul_fused(x, w, lut_table(spec, x.device), sx, sw,
                            bits=spec.bits)


def nibble_fused_scaled(x, w, spec: MultiplierSpec, sx, sw) -> torch.Tensor:
    """Fused nibble GEMM with caller-supplied global scales."""
    return nibble_lut_matmul_fused(x, w, nibble_table(spec, x.device), sx,
                                   sw, bits=spec.bits)


def log_fused_scaled(x, w, sx, sw, bits: int = 8,
                     compensated: bool = True) -> torch.Tensor:
    """Fused log-domain GEMM with caller-supplied global scales."""
    return mitchell_matmul_fused(x, w, sx, sw, bits=bits,
                                 compensated=compensated)


def surrogate_gemm(xq, wq, sx, sw, eps, mu: float, c0: float,
                   c1: float) -> torch.Tensor:
    """The surrogate GEMM in real units over int8 operands (the int-in
    oracle surface): `cim_gemm_core` (SQ only when noise is drawn and
    c1 > 0), then the epilogue in plain torch (ref.surrogate_epilogue)."""
    noisy = stochastic(eps, c0, c1)
    need_sq = noisy and c1 > 0.0
    d, sq = cim_gemm_core(xq, wq, need_sq=need_sq)
    return surrogate_epilogue(d, sq if need_sq else None, sx, sw,
                              eps if noisy else None, mu, c0, c1,
                              xq.shape[-1])


def surrogate_gemm_fused(x, w, eps, mu: float, c0: float, c1: float,
                         bits: int = 8) -> torch.Tensor:
    """The fused surrogate GEMM: float in -> f32 out, quantization and the
    whole epilogue (bias, and the noise term when `eps` is given) in one
    kernel.  The production path of surrogate mode on the card."""
    sx, sw = _scales(x, w, bits)
    return cim_gemm_fused(x, w, sx, sw, eps, mu, c0, c1, bits=bits)


# ---------------------------------------------------------------------------
# Implicit-GEMM conv (kernels/conv_gemm.py): x (B, H, W, C) float, w2
# (kh*kw*C, N) float with tap-major rows (the im2col column order) ->
# f32 (B, OH, OW, N).  Scales as the GEMMs': per tensor over x, per
# column of w2.
# ---------------------------------------------------------------------------


def _conv_operands(x, w2, bits, kh, kw):
    c, n = x.shape[-1], w2.shape[-1]
    xf = x.to(torch.float32).contiguous()
    wf = w2.to(torch.float32).contiguous()
    sx, sw = _scales(xf, wf, bits)
    return xf, wf.reshape(kh * kw, c, n), sx, sw


def conv2d_mxu_fused(x, w2, bits: int = 8, kh: int = 3, kw: int = 3,
                     stride: int = 1) -> torch.Tensor:
    """Exact-family fused-quantization implicit-GEMM conv (exact mode):
    the exact integer products, scaled once."""
    xf, w3, sx, sw = _conv_operands(x, w2, bits, kh, kw)
    return conv_mxu_fused(xf, w3, sx, sw, bits=bits, kh=kh, kw=kw,
                          stride=stride)


def conv2d_lut_fused(x, w2, spec: MultiplierSpec, kh: int = 3, kw: int = 3,
                     stride: int = 1) -> torch.Tensor:
    """Full-LUT fused-quantization implicit-GEMM conv (any LUT family);
    bit-identical integer core to im2col + ``lut_matmul``."""
    xf, w3, sx, sw = _conv_operands(x, w2, spec.bits, kh, kw)
    return conv_lut_fused(xf, w3, lut_table(spec, x.device), sx, sw,
                          bits=spec.bits, kh=kh, kw=kw, stride=stride)


def conv2d_nibble_fused(x, w2, spec: MultiplierSpec, kh: int = 3,
                        kw: int = 3, stride: int = 1) -> torch.Tensor:
    """Nibble sub-LUT fused-quantization implicit-GEMM conv (the spec
    must be decomposable; routing guarantees it)."""
    xf, w3, sx, sw = _conv_operands(x, w2, spec.bits, kh, kw)
    return conv_lut_fused(xf, w3, nibble_table(spec, x.device), sx, sw,
                          bits=spec.bits, kh=kh, kw=kw, stride=stride,
                          nibble=True)


def conv2d_log_fused(x, w2, bits: int = 8, compensated: bool = True,
                     kh: int = 3, kw: int = 3, stride: int = 1):
    """Log-domain fused-quantization implicit-GEMM conv (mitchell /
    log_our); bit-identical integer core to im2col + ``mitchell_matmul``."""
    xf, w3, sx, sw = _conv_operands(x, w2, bits, kh, kw)
    return conv_log_fused(xf, w3, sx, sw, bits=bits,
                          compensated=compensated, kh=kh, kw=kw,
                          stride=stride)


# The mesh path's conv forms: f32 x (B, H, W, C_shard) and the tap stack
# w3 (kh*kw, C_shard, N_shard) with the caller's global scales; the
# partials return the raw int32 (B, OH, OW, N) sum over their channels,
# the scaled forms (the output-sharded layout) f32 through the epilogue.


def _conv_table(spec: MultiplierSpec, nibble: bool, device):
    return nibble_table(spec, device) if nibble else lut_table(spec, device)


def conv2d_lut_partial(x, w3, spec: MultiplierSpec, sx, sw, kh: int = 3,
                       kw: int = 3, stride: int = 1,
                       nibble: bool = False) -> torch.Tensor:
    """Shard-local LUT/nibble conv over a slice of C -> int32."""
    return conv_lut_partial(x, w3, _conv_table(spec, nibble, x.device), sx,
                            sw, bits=spec.bits, kh=kh, kw=kw, stride=stride,
                            nibble=nibble)


def conv2d_log_partial(x, w3, sx, sw, bits: int = 8,
                       compensated: bool = True, kh: int = 3, kw: int = 3,
                       stride: int = 1) -> torch.Tensor:
    """Shard-local log-family conv over a slice of C -> int32."""
    return conv_log_partial(x, w3, sx, sw, bits=bits,
                            compensated=compensated, kh=kh, kw=kw,
                            stride=stride)


def conv2d_lut_fused_scaled(x, w3, spec: MultiplierSpec, sx, sw,
                            kh: int = 3, kw: int = 3, stride: int = 1,
                            nibble: bool = False) -> torch.Tensor:
    """Fused LUT/nibble conv with caller-supplied global scales."""
    return conv_lut_fused(x, w3, _conv_table(spec, nibble, x.device), sx,
                          sw, bits=spec.bits, kh=kh, kw=kw, stride=stride,
                          nibble=nibble)


def conv2d_log_fused_scaled(x, w3, sx, sw, bits: int = 8,
                            compensated: bool = True, kh: int = 3,
                            kw: int = 3, stride: int = 1) -> torch.Tensor:
    """Fused log-family conv with caller-supplied global scales."""
    return conv_log_fused(x, w3, sx, sw, bits=bits, compensated=compensated,
                          kh=kh, kw=kw, stride=stride)


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

def _attn_table(path: str, spec: Optional[MultiplierSpec], device):
    """The path's table on `device`: the int16 full table (lut), the
    int32 sub-tables (nibble), or None."""
    if path in ("lut", "nibble"):
        if spec is None:
            raise ValueError(f"attention path {path!r} needs a "
                             "MultiplierSpec to build its table")
        if path == "lut":
            return lut_table(spec, device)
        return nibble_table(spec, device)
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
