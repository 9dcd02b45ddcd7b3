"""Shared building blocks: parameter init, norms, RoPE, MLPs, and the
CiM-aware linear layer (the paper's technique as an execution mode of
every matmul in the model).

Parameters are plain nested dicts of tensors.  Weights are 2-D (K, N):
the JAX package's head-shaped attention weights arrive flattened
(models/bridge.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.approx_gemm import GemmParams, model_matmul
from repro_torch.core.compiler import CiMConfig, compile_macro

# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def param(gen: torch.Generator, shape, device, dtype=torch.bfloat16,
          scale: float = 0.02, init: str = "normal") -> torch.Tensor:
    """One weight: N(0, scale^2) drawn in f32 from `gen`, then cast (or
    ones / zeros)."""
    if init == "normal":
        v = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * scale
    elif init == "zeros":
        v = torch.zeros(shape, device=device, dtype=torch.float32)
    elif init == "ones":
        v = torch.ones(shape, device=device, dtype=torch.float32)
    else:
        raise ValueError(init)
    return v.to(dtype)


# ---------------------------------------------------------------------------
# Normalization / activations
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def layer_norm(x, w, b, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w + b


def apply_norm(params, x, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params["bias"])


def init_norm(d: int, kind: str, device):
    p = {"scale": torch.ones(d, dtype=torch.bfloat16, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros(d, dtype=torch.bfloat16, device=device)
    return p


# ---------------------------------------------------------------------------
# RoPE (fractional; chatglm's 2d-rope == fraction 0.5, stablelm 0.25)
# ---------------------------------------------------------------------------


def rope_tables(positions, head_dim: int, fraction: float, theta: float):
    rot = int(head_dim * fraction)
    rot -= rot % 2
    if rot == 0:
        return None
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * freqs   # (..., S, rot/2)
    return torch.cos(ang), torch.sin(ang), rot


def apply_rope(x, tables):
    """x: (B, S, H, D); tables from rope_tables (positions (B, S))."""
    if tables is None:
        return x
    cos, sin, rot = tables
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# CiM-aware linear
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CiMParams:
    """Static CiM execution parameters, from a compiled macro: the
    routing inputs (family/mode/bits), the calibrated surrogate
    coefficients and the per-module allocation filter.  Execution is the
    dispatch engine's (core/approx_gemm.py)."""

    mode: str = "off"            # off | one of core.approx_gemm.MODES
    bits: int = 8
    family: str = "exact"        # exact | appro42 | mitchell | log_our
    mu: float = 0.0
    c0: float = 0.0
    c1: float = 0.0
    compressor: str = "yang1"
    n_approx_cols: Optional[int] = None
    apply_to: tuple = ()         # name prefixes; () = every matmul

    @classmethod
    def from_config(cls, cim: Optional[CiMConfig]) -> "CiMParams":
        if cim is None:
            return cls()
        s = compile_macro(cim).surrogate
        return cls(mode=cim.mode, bits=cim.bits, family=cim.family,
                   mu=s.mu_rel, c0=s.c0_abs, c1=s.c1_rel,
                   compressor=cim.compressor,
                   n_approx_cols=cim.n_approx_cols,
                   apply_to=tuple(cim.apply_to))

    def gemm_params(self) -> GemmParams:
        return GemmParams(family=self.family, bits=self.bits,
                          mode=self.mode, mu=self.mu, c0=self.c0,
                          c1=self.c1, compressor=self.compressor,
                          n_approx_cols=self.n_approx_cols)

    def selects(self, name: str) -> bool:
        """Does the approximate family apply to this matmul?  Unselected
        matmuls run the exact int8 macro instead."""
        return not self.apply_to or any(name.startswith(p)
                                        for p in self.apply_to)

    def routing(self, name: str) -> Tuple[GemmParams, bool]:
        """(gemm params, apply) for one named matmul."""
        return self.gemm_params(), self.selects(name)


@dataclasses.dataclass
class CiMContext:
    """Per-call CiM context.  The reference also threads a surrogate
    noise key here; noise is a later slice of the port."""

    p: CiMParams


def cim_linear(x, w: torch.Tensor, ctx: CiMContext, name: str = "",
               bias: Optional[torch.Tensor] = None):
    """y = approx(x @ w) per the CiM context.

    x: (..., K); w: (K, N).  Which kernel runs this matmul for the
    context's (family, mode, bits) and the operands' device is the
    dispatch engine's choice (core/approx_gemm.model_matmul)."""
    assert w.dim() == 2, "cim_linear expects 2-D weights (flatten heads)"
    p = ctx.p
    if p.mode == "off":
        out = x @ w
    else:
        gp, apply = p.routing(name)
        out = model_matmul(x, w, gp, apply=apply)
    if bias is not None:
        out = out + bias
    return out


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(gen, d_model: int, d_ff: int, act: str, device,
             dtype=torch.bfloat16):
    # draw order wi, wg, wo (the reference splits one key three ways)
    p = {"wi": param(gen, (d_model, d_ff), device, dtype)}
    if act == "swiglu":
        p["wg"] = param(gen, (d_model, d_ff), device, dtype)
    p["wo"] = param(gen, (d_ff, d_model), device, dtype)
    return p


def apply_mlp(params, x, act: str, ctx: CiMContext):
    if act == "swiglu":
        h = F.silu(cim_linear(x, params["wi"], ctx, "mlp_wi"))
        g = cim_linear(x, params["wg"], ctx, "mlp_wg")
        h = h * g
    else:
        h = F.gelu(cim_linear(x, params["wi"], ctx, "mlp_wi"),
                   approximate="tanh")
    return cim_linear(h, params["wo"], ctx, "mlp_wo")
