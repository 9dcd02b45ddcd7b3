"""Symmetric integer quantization for the CiM datapath (torch).

The DCiM macro stores weights as n-bit words and streams n-bit
activations; we model that with symmetric per-channel weight / per-tensor
activation quantization.  `fake_quant` carries a straight-through
estimator so approximate-aware (QAT-style) training works.

Rounding is round-half-to-even (`torch.round`), the division is IEEE,
and dtypes follow the JAX reference: a bf16 tensor divided by an f32
scale computes in f32 (torch would keep bf16 for a 0-dim f32 scale, so
the promotion is spelled out).
"""

from __future__ import annotations

import torch


def qmax(bits: int, signed: bool = True) -> int:
    return (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1


def quant_scale(x: torch.Tensor, bits: int, axis=None,
                eps: float = 1e-8) -> torch.Tensor:
    """Symmetric scale so that x/scale fits in [-qmax, qmax]: a 0-dim
    tensor for axis=None, else keepdims along `axis` (x's dtype)."""
    if axis is None:
        m = x.abs().amax()
    else:
        m = x.abs().amax(dim=axis, keepdim=True)
    return scale_from_max(m, bits, eps)


def scale_from_max(m: torch.Tensor, bits: int,
                   eps: float = 1e-8) -> torch.Tensor:
    """The scale of `quant_scale` from the max |x| `m` already taken (the
    mesh path takes it over the shards, then scales as one device)."""
    # divide by a tensor, not a Python number: on CUDA, PyTorch turns a
    # division by a host scalar into a multiply by its reciprocal, which
    # is not the IEEE quotient the reference (and the CPU) computes
    return torch.clamp_min(m, eps) / torch.full_like(m, qmax(bits))


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    dt = torch.promote_types(x.dtype, scale.dtype)
    q = torch.round(x.to(dt) / scale.to(dt))
    q = torch.clamp(q, -qmax(bits), qmax(bits))
    return q.to(torch.int8 if bits <= 8 else torch.int32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


class _STERound(torch.autograd.Function):
    """round() forward, identity backward (straight-through)."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient (QAT).

    The scale is cast to x's dtype so a bf16 activation stream stays bf16
    end-to-end, as in the reference."""
    scale = quant_scale(x.detach(), bits, axis=axis).to(x.dtype)
    q = torch.clamp(_STERound.apply(x / scale), -qmax(bits), qmax(bits))
    return q * scale
