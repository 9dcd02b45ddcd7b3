"""Small ResNet-style CNN for the paper's Table IV experiment.

Convolutions execute against a compiled CiM macro two ways: the hot path
(`fused=True`, bit_exact/hardware modes) routes through
`core.approx_gemm.cim_conv2d` — the implicit-GEMM kernels, which gather
the kh*kw patches inside the kernel, so the im2col tensor never exists —
while `_im2col + cim_linear` remains the materialized oracle surface:
the bit-exact reference the implicit kernels are held to, the
`fused=False` baseline, and the execution path of the other modes
(off / exact / surrogate, where QAT fake-quant gradients and the
per-name allocation live in `cim_linear`).  This is the paper's
ResNet-18 / ILSVRC evaluation scaled down to a network trained on
synthetic images.

Parameters are a dict of f32 tensors: "c1".."c5" (kh*kw*C_in, C_out)
conv weights with tap-major rows, "fc" (4*width, n_classes) and the
bias "b".
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.approx_gemm import ConvParams, cim_conv2d, im2col_nhwc

from .common import CiMContext, CiMParams, cim_linear, param

# conv2d modes that run the implicit-GEMM frontend.  "exact" stays on the
# materialized cim_linear path on purpose: that is the QAT
# configuration, whose fake-quant backward is part of its training
# semantics; cim_conv2d's pure-STE float-conv VJP is not a drop-in for it.
_IMPLICIT_MODES = ("bit_exact", "hardware")

OFF = CiMContext(CiMParams())


def _im2col(x, kh: int, kw: int, stride: int = 1):
    """x: (B, H, W, C) -> (B, OH, OW, kh*kw*C); kh//2 zero padding (SAME
    for stride 1), odd kernels only (ConvParams validates)."""
    return im2col_nhwc(x, ConvParams(kh, kw, stride))


def conv2d(w, x, ctx: CiMContext, name: str, kh: int = 3, kw: int = 3,
           stride: int = 1, fused: bool = True):
    """(kh, kw, stride) conv through the CiM execution engine.

    `fused=True` (default) dispatches the integer modes (bit_exact /
    hardware) to `cim_conv2d` (implicit-GEMM kernels, bit-identical to
    the materialized path); `fused=False` forces the im2col +
    `cim_linear` oracle/baseline path, which the off/exact/surrogate
    modes always take."""
    p = ctx.p
    if fused and p.mode in _IMPLICIT_MODES and p.selects(name):
        out = cim_conv2d(x, w, p.gemm_params(), kh=kh, kw=kw, stride=stride)
        return out.to(x.dtype)
    cols = _im2col(x, kh, kw, stride)
    b, oh, ow, k = cols.shape
    y = cim_linear(cols.reshape(b * oh * ow, k), w, ctx, name)
    return y.reshape(b, oh, ow, -1)


def init_cnn(gen: torch.Generator, n_classes: int = 10, width: int = 16,
             device="cpu") -> Dict[str, torch.Tensor]:
    """Seeded f32 weights, N(0, s^2) per layer, drawn in the order c1..c5,
    fc from `gen` (on its own device, then moved to `device`); the bias
    starts at zero."""
    w1, w2, w3 = width, 2 * width, 4 * width

    def mk(i, o, s):
        return param(gen, (i, o), gen.device, torch.float32,
                     scale=s).to(device)

    return {
        "c1": mk(9 * 3, w1, 0.15),
        "c2": mk(9 * w1, w1, 0.08),       # residual block
        "c3": mk(9 * w1, w2, 0.08),
        "c4": mk(9 * w2, w2, 0.05),       # residual block
        "c5": mk(9 * w2, w3, 0.05),
        "fc": mk(w3, n_classes, 0.1),
        "b": param(gen, (n_classes,), device, torch.float32, init="zeros"),
    }


def _max_pool(h):
    """2x2 max pool, stride 2, VALID, on (B, H, W, C)."""
    return F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def cnn_forward(params, x, ctx: Optional[CiMContext] = None,
                fused: bool = True):
    """x: (B, H, W, 3) float in [0,1]. Returns logits (B, n_classes).
    `fused` is every conv's `conv2d` flag (False: the im2col oracle)."""
    ctx = ctx or OFF

    def conv(name, h):
        return conv2d(params[name], h, ctx, name, fused=fused)

    h = F.relu(conv("c1", x))
    h = h + F.relu(conv("c2", h))
    h = _max_pool(h)
    h = F.relu(conv("c3", h))
    h = h + F.relu(conv("c4", h))
    h = _max_pool(h)
    h = F.relu(conv("c5", h))
    h = h.mean(dim=(1, 2))
    return cim_linear(h, params["fc"], ctx, "fc") + params["b"]


def cnn_loss(params, batch, ctx: Optional[CiMContext] = None):
    """(mean cross-entropy, accuracy) of one {"x", "y"} batch."""
    logits = cnn_forward(params, batch["x"], ctx)
    lp = F.log_softmax(logits, dim=-1)
    nll = -lp.gather(-1, batch["y"].long()[:, None]).mean()
    acc = (logits.argmax(-1) == batch["y"]).to(torch.float32).mean()
    return nll, acc
