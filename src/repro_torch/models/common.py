"""Shared building blocks: parameter init, norms, RoPE, MLPs, and the
CiM-aware linear layer (the paper's technique as an execution mode of
every matmul in the model).

Parameters are plain nested dicts of tensors.  Weights are 2-D (K, N):
the JAX package's head-shaped attention weights arrive flattened
(models/bridge.py).

Under an ambient mesh (launch.mesh: ``with mesh:``) every rank holds its
shards of the weights and of the activation rows, and `cim_linear` runs
each matmul tensor-parallel: the integer modes through the dispatch
engine's mesh path (one shard-local kernel, global scales, an exact
int32 sum for a contraction-sharded weight), `surrogate` through
`approx_gemm.surrogate_shard_matmul` (the fused surrogate kernel on a
shard that holds the whole contraction, its epilogue-off partial, an
exact int32 sum and one flush on a contraction-sharded one: one device's
result bit for bit, noise included), and the float modes by hand
(`_float_tp`: global fake-quant scales, per row with per-token scales,
a local float product, an f32 sum for a contraction-sharded weight:
allclose to one device, not bitwise; `surrogate_fast` is that product
times its mean shift, plus its rank-1 noise).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.approx_gemm import (MESH_MODES, GemmParams,
                                          NoiseKey, _draws_noise, mean_shift,
                                          mesh_float_plan, model_matmul,
                                          row_block_mm, shard_noise,
                                          surrogate_shard_matmul,
                                          surrogate_variance)
from repro_torch.core.compiler import CiMConfig, compile_macro
from repro_torch.core.error_model import SurrogateModel
from repro_torch.core.faults import FaultConfig
from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.core.quantization import qmax, scale_from_max
from repro_torch.launch.mesh import ambient_mesh
from repro_torch.parallel.sharding import P, axes_of, spec_entry

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


# `row_mean_square` sums each row's squares as 16 contiguous groups of
# d/16, then the 16 partial sums.  PyTorch's CUDA reduction gives each
# output as many threads as its block has room for beside the outputs it
# holds, so one wide sum over 2 rows splits each row over other threads
# than over 4.  With at least 16 outputs (every row has 16 groups) the
# first sum gets min(d/16, 32) threads an output (to a power of two),
# and the second 16, at any row count: neither order depends on the
# number of rows.
_GROUPS = 16


def row_mean_square(x32: torch.Tensor) -> torch.Tensor:
    """mean(x^2) over the last dim (keepdim), summed in an order that
    depends on the width only, not on the number of rows: a data rank of
    the mesh norms 2 of the pool's 4 rows, and one wide torch.mean picks
    its CUDA block shape by the row count, so its f32 sum (and now and
    then the bf16 norm) would differ from the unsharded pool's.  Two
    sums, where torch.mean is one."""
    v = x32 * x32
    d = v.shape[-1]
    pad = -d % _GROUPS
    if pad:
        v = F.pad(v, (0, pad))
    s = v.unflatten(-1, (_GROUPS, -1)).sum(dim=-1)
    return s.sum(dim=-1, keepdim=True) / d


def rms_norm(x, w, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    var = row_mean_square(x32)
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
    coefficients and the per-module allocation (the `apply_to` filter or
    the `alloc` table).  Execution is the dispatch engine's
    (core/approx_gemm.py)."""

    mode: str = "off"            # off | one of core.approx_gemm.MODES
    bits: int = 8
    family: str = "exact"        # exact | appro42 | mitchell | log_our
    mu: float = 0.0
    c0: float = 0.0
    c1: float = 0.0
    compressor: str = "yang1"
    n_approx_cols: Optional[int] = None
    apply_to: tuple = ()         # name prefixes; () = every matmul
    per_token: bool = False      # per-row activation scales (serving/spec.py)
    attn: bool = False           # fused CiM attention (models/attention.py)
    attn_heads: Optional[tuple] = None   # per-q-head family allocation
    fault: Optional[FaultConfig] = None  # as-fabricated defects (core/faults.py)
    # heterogeneous per-module allocation (CiMConfig.alloc): compiled
    # (prefix, GemmParams, apply) entries, longest prefix first; each
    # module pins its own frozen GemmParams, so each has its own plans
    alloc: Optional[tuple] = None

    @classmethod
    def from_config(cls, cim: Optional[CiMConfig]) -> "CiMParams":
        if cim is None:
            return cls()
        s = compile_macro(cim).surrogate
        alloc = None
        if cim.alloc:
            entries = []
            for prefix, family, compressor, ncols in cim.alloc:
                spec = MultiplierSpec(family, cim.bits, cim.signed,
                                      compressor, ncols)
                sur = (SurrogateModel.exact(spec) if family == "exact"
                       else SurrogateModel.fit(spec))
                gp = GemmParams.from_spec(spec, sur, cim.mode)
                if cim.per_token:
                    gp = dataclasses.replace(gp, per_token=True)
                entries.append((prefix, gp, family != "exact"))
            # longest prefix wins: sort once, match first
            entries.sort(key=lambda e: len(e[0]), reverse=True)
            alloc = tuple(entries)
        return cls(mode=cim.mode, bits=cim.bits, family=cim.family,
                   mu=s.mu_rel, c0=s.c0_abs, c1=s.c1_rel,
                   compressor=cim.compressor,
                   n_approx_cols=cim.n_approx_cols,
                   apply_to=tuple(cim.apply_to),
                   per_token=bool(cim.per_token), attn=bool(cim.attn),
                   attn_heads=(tuple(cim.attn_heads)
                               if cim.attn_heads is not None else None),
                   fault=cim.fault, alloc=alloc)

    def gemm_params(self) -> GemmParams:
        return GemmParams(family=self.family, bits=self.bits,
                          mode=self.mode, mu=self.mu, c0=self.c0,
                          c1=self.c1, compressor=self.compressor,
                          n_approx_cols=self.n_approx_cols,
                          per_token=self.per_token, fault=self.fault)

    def selects(self, name: str) -> bool:
        """Does the approximate family apply to this matmul?  Unselected
        matmuls run the exact int8 macro instead."""
        return not self.apply_to or any(name.startswith(p)
                                        for p in self.apply_to)

    def routing(self, name: str) -> Tuple[GemmParams, bool]:
        """(gemm params, apply) for one named matmul.  With an `alloc`
        table the longest matching prefix picks the module's multiplier
        ("exact" entries and unmatched names run the exact int8 macro,
        apply=False); otherwise the homogeneous (family, apply_to)
        routing applies."""
        if self.alloc is not None:
            for prefix, gp, apply in self.alloc:
                if name.startswith(prefix):
                    return gp, apply
            return self.gemm_params(), False
        return self.gemm_params(), self.selects(name)


@dataclasses.dataclass
class CiMContext:
    """Per-call CiM context: the static params, an optional surrogate
    noise key (None: the deterministic term, as serving runs) and, under
    a mesh, the partition specs of the named matmuls' (K, N) weights as
    their shards were cut (`specs`, models.transformer.param_layout) and
    the mesh axes the activation rows are split over (`row_axes`: the
    data axes for a data-parallel slot pool, () for replicated rows).
    `child(name)` derives each named matmul's own key from (key,
    crc32(name)), as the reference folds the name into its JAX key."""

    p: CiMParams
    key: Optional[NoiseKey] = None
    specs: Optional[Dict[str, P]] = None
    row_axes: Tuple[str, ...] = ()

    def child(self, name: str) -> "CiMContext":
        if self.key is None:
            return self
        return dataclasses.replace(self, key=self.key.child(name))


# Interception of every named linear (core/allocate.py's probe and mixing
# evaluator).  The hook is called as fn(x, w, ctx, name); returning None
# falls through to the normal routing, any other value becomes the layer
# output (the bias is still added by cim_linear).  A list of one, so
# closures see swaps without a global statement.
_LINEAR_OVERRIDE = [None]


def set_linear_override(fn) -> None:
    """Install (or clear, with None) the cim_linear interception hook."""
    _LINEAR_OVERRIDE[0] = fn


def _tp_mesh_args(ctx: CiMContext, name: str):
    """(mesh, x_spec, w_spec) of one matmul under the ambient mesh, or
    None where nothing is split (no mesh; a whole weight and replicated
    rows: every rank computes the same product).  The specs are stated,
    not inferred: the rows on `ctx.row_axes`, the weight as it was cut,
    x's K on the weight's K axes (a row-parallel layer's input is this
    rank's slice of the heads or ff)."""
    mesh = ambient_mesh()
    if mesh is None:
        return None
    w_spec = (ctx.specs or {}).get(name, P(None, None))
    if w_spec == (None, None) and not ctx.row_axes:
        return None
    return mesh, P(spec_entry(ctx.row_axes), w_spec[0]), w_spec


def _mesh_max(m: torch.Tensor, mesh, axes) -> torch.Tensor:
    """An elementwise max over the shards of `axes`, in m's dtype (the
    exchange in f32, exact for bf16)."""
    return mesh.all_reduce(m.to(torch.float32), "max", axes).to(m.dtype)


def _fake_quant_at(x: torch.Tensor, m: torch.Tensor, bits: int):
    """`fake_quant` with the max |x| `m` given (forward only)."""
    scale = scale_from_max(m, bits).to(x.dtype)
    return torch.clamp(torch.round(x / scale), -qmax(bits),
                       qmax(bits)) * scale


def _float_tp(x, w, gp: Optional[GemmParams], mesh, x_spec, w_spec,
              fast: bool = False, key: Optional[NoiseKey] = None):
    """A float-mode matmul on shards: the plain product of mode "off"
    (`gp` None), or the fake-quant QAT form of mode "exact", of the exact
    macro an unselected module runs and of `surrogate_fast` (`gp` its
    GemmParams): the global scales as max-reductions over the shards
    (per tensor; with `gp.per_token` each row's over x's K shards only,
    the rows' products in `approx_gemm.ROW_BLOCK`-row blocks, so that a
    row is computed as it is alone, as on one device), and the local
    product; for a contraction-sharded weight the partial products are
    taken in f32, summed in f32 over the weight's K axes and rounded to
    the activation dtype once, as one device's dot rounds once.  The sum
    reassociates the dot, so this is allclose to one device, not bitwise.
    `fast` (an applied `surrogate_fast` GEMM) multiplies that product by
    its mean shift and, with `key`, adds one device's rank-1 noise: the
    row and column sums of squares summed over the K shards in f32, the
    global output's noise cut to this rank's block.  A quantized call is
    announced with its global MACs (`approx_gemm.mesh_float_plan`)."""
    wk = axes_of(w_spec[0])
    if gp is None:
        return _tp_product(x, w, torch.matmul, mesh, wk)
    noisy = fast and _draws_noise(gp, key)
    (dp, _, wn), (m, k, n) = mesh_float_plan(gp, x, w, mesh, x_spec, w_spec,
                                             noisy=noisy)
    if gp.per_token:
        xm = _mesh_max(x.abs().amax(dim=-1, keepdim=True), mesh,
                       axes_of(x_spec[1]))
    else:
        xm = _mesh_max(x.abs().amax(), mesh,
                       axes_of(x_spec[0]) + axes_of(x_spec[1]))
    cm = _mesh_max(w.abs().amax(dim=0, keepdim=True), mesh, wk)
    xq = _fake_quant_at(x, xm, gp.bits)
    wq = _fake_quant_at(w, cm, gp.bits).to(x.dtype)
    d = _tp_product(xq, wq, row_block_mm if gp.per_token else torch.matmul,
                    mesh, wk)
    if not fast:
        return d
    out = mean_shift(d, gp.mu)
    if not noisy:
        return out
    s = (scale_from_max(xm, gp.bits) * scale_from_max(cm, gp.bits)).to(
        torch.float32)
    xf = wf = None
    if gp.c1 > 0.0:
        xf, wf = xq.to(torch.float32), wq.to(torch.float32)
    var = surrogate_variance(gp, s * s, k, xf, wf, fast=True,
                             reduce=lambda t: mesh.all_reduce(t, "sum", wk))
    eps = shard_noise(key, m, n, x.device, mesh, dp, wn)
    noise = (torch.sqrt(torch.clamp_min(var, 0.0)).to(d.dtype)
             * eps.reshape(d.shape).to(d.dtype))
    return out + noise


def _tp_product(x, w, mm, mesh, wk):
    """x @ w on shards: local for a whole contraction, else f32 partial
    products summed over the K axes `wk` and rounded once."""
    if not wk:
        return mm(x, w)
    d = mm(x.to(torch.float32), w.to(torch.float32))
    return mesh.all_reduce(d, "sum", wk).to(x.dtype)


def _mesh_linear(x, w, ctx: CiMContext, name: str, mesh, x_spec, w_spec):
    p = ctx.p
    if p.mode == "off":
        return _float_tp(x, w, None, mesh, x_spec, w_spec)
    gp, apply = p.routing(name)
    if apply and gp.per_token and gp.mode != "exact":
        # the shard kernels and the surrogate route quantize x per
        # tensor; the reference's GSPMD sees whole rows.  No lane reaches
        # this on a mesh: the spec drafter is per tensor, the verifier
        # and the sentinel's reference are the exact rung
        raise NotImplementedError(
            f"per-token activation scales in mode {gp.mode!r} on shards are "
            "not ported (ROADMAP queue A 5): only the exact rung takes "
            "per-token scales under a mesh")
    if apply and gp.mode in MESH_MODES:
        return model_matmul(x, w, gp, apply=True, mesh=mesh, x_spec=x_spec,
                            w_spec=w_spec, local=True)
    key = ctx.child(name).key if name else ctx.key
    if apply and gp.mode == "surrogate":
        return surrogate_shard_matmul(x, w, gp, key, mesh=mesh,
                                      x_spec=x_spec, w_spec=w_spec)
    return _float_tp(x, w, gp, mesh, x_spec, w_spec,
                     fast=apply and gp.mode == "surrogate_fast", key=key)


def cim_linear(x, w: torch.Tensor, ctx: CiMContext, name: str = "",
               bias: Optional[torch.Tensor] = None):
    """y = approx(x @ w) per the CiM context.

    x: (..., K); w: (K, N).  Which kernel runs this matmul for the
    context's (family, mode, bits) and the operands' device is the
    dispatch engine's choice (core/approx_gemm.model_matmul); a context
    key draws this matmul's surrogate noise from its own child key.
    Under an ambient mesh x and w are this rank's shards and so is the
    result (see the module docstring).  There per-token scales run on the
    exact rung only (the spec verifier and the sentinel's reference): an
    applied approximate per-token GEMM on shards raises, and so does any
    fault (the shard kernels quantize their words on load and the float
    route fake-quantizes, neither sees a defect map; the reference
    refuses it too).  An installed `set_linear_override` hook sees the
    call first."""
    assert w.dim() == 2, "cim_linear expects 2-D weights (flatten heads)"
    if _LINEAR_OVERRIDE[0] is not None:
        out = _LINEAR_OVERRIDE[0](x, w, ctx, name)
        if out is not None:
            if bias is not None:
                out = out + bias
            return out
    p = ctx.p
    if p.fault is not None and p.mode != "off" and ambient_mesh() is not None:
        # the shard kernels quantize on load and `_float_tp` fake-quants:
        # neither sees the defect map (the reference refuses it too)
        raise ValueError(
            "fault injection is not supported under a mesh (the shard "
            "paths quantize their words on load); drop the mesh or the "
            "fault config")
    margs = _tp_mesh_args(ctx, name)
    if margs is not None:
        out = _mesh_linear(x, w, ctx, name, *margs)
    elif p.mode == "off":
        out = x @ w
    else:
        key = ctx.child(name).key if name else ctx.key
        gp, apply = p.routing(name)
        out = model_matmul(x, w, gp, key, apply=apply)
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
