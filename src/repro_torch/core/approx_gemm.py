"""Approximate CiM GEMM — the execution front door and dispatch engine
(GEMM and attention universes).

Execution modes (as in the JAX package):

  * ``exact``           — quantize-dequantize + float dot (QAT baseline).
  * ``bit_exact``       — every scalar product from the compiled
                          multiplier LUT (plain torch gather; validation
                          scale, O(M*K*N) work).
  * ``hardware``        — the same integer semantics executed by the
                          hand-written GPU kernels: the full-LUT gather
                          for exact/appro42, the arithmetic log-domain
                          kernel for mitchell/log_our.  On CPU tensors
                          the kernels' plain versions run instead.
  * ``surrogate``       — the compiler's default: the int8 dot times the
                          calibrated mean shift (1+mu) plus, when a noise
                          key is given, the calibrated noise
                          sqrt(c0*K*s^2 + c1*(A^2 @ B^2)*s^2) * eps.  On a
                          CUDA tensor the fused surrogate kernel runs it
                          (kernels/cim_gemm.py); on the CPU the plain
                          ``torch_surrogate`` route (dequantized dot +
                          epilogue), as the reference's CPU runs XLA.
  * ``surrogate_fast``  — the same with a rank-1 estimate of A^2 @ B^2
                          (``torch_surrogate`` on every device).

Noise is explicit randomness: a `NoiseKey` holds a 64-bit seed,
`NoiseKey.child(name)` derives another from (seed, crc32(name)), and each
draw seeds a `torch.Generator` on the operands' device from it (no
global RNG state), so the same key on the same device gives the same
eps.  The macro and conv frontends draw normal noise, the model frontend
rademacher (`NOISE_KIND`), as in the reference.

Every (family, mode, bits, backend) combination is routed by a single
**kernel registry**: `select_kernel` picks the highest-priority
`KernelEntry` that supports the request; the backend comes from the
operands' device ("cuda" or "cpu"), never from a global.  A hardware
GEMM on a CUDA tensor resolves to a ``cuda_*`` entry or raises — the
``torch_*`` plain entries are registered for "cpu" only.  Every route
of the reference's GEMM, conv and attention universes has its entry
here, with the reference's priorities.

Two float frontends execute a routed plan:

  * `cim_matmul`   — the macro frontend: true int quantization, f32 out.
  * `model_matmul` — the model-zoo frontend (`models.common.cim_linear`):
                     fake-quant for exact (and surrogate on the CPU), the
                     fused kernels for hardware and for surrogate on the
                     card, activation dtype preserved.

Kernel-backed paths carry a straight-through estimator
(`torch.autograd.Function`, backward ``g @ w.T`` / ``x.T @ g``, a zero
cotangent for the pre-drawn noise).

**Faults.**  A `GemmParams.fault` (core/faults.py, the integer and
exact modes) gates the fused runners off: the weight is quantized, its
stored words faulted (`apply_weight_faults`), and the int kernel runs
on them; the full-LUT gather takes the faulted table (on the card the
magnitude-table kernel, `lut_matmul_mag`), and routing passes no spec,
so no nibble kernel (which holds clean sub-tables) is chosen.  A faulted
conv runs `conv_im2col`; faulted attention and the mesh path refuse.

The conv universe (``op="conv"`` entries) routes `cim_conv2d`: the
implicit-GEMM conv kernels (kernels/conv_gemm.py) for hardware mode on
bit-safe geometries and for exact mode, planned by `plan_conv` against a
shared-memory model, and the materialized ``conv_im2col`` fallback
(im2col + the GEMM engine, noise included) for everything else, with the
float conv's gradient as the straight-through backward.

The attention universe (``op="attn"`` entries) routes `cim_attention`:
QK^T and PV through the flash CiM attention kernels
(kernels/attn_gemm.py) on the path the (family, mode) selects, planned
by `plan_attn` against a shared-memory model and the reference's
accumulator bit-safety gate, with the `attn_float` straight-through
backward.

**Plan cache.**  Each frontend resolves its work through a cache keyed
on (frontend, GemmParams, apply, noise drawn or not, operand dtypes,
power-of-two-bucketed shape, backend); a miss routes, builds the forward
and counts one `plan_misses()`.  This is the port's form of the reference's
zero-retrace contract: after an engine's warmup the count stays flat.

**Telemetry.**  `set_obs_sink` installs a host-side sink (obs/) that each
frontend tells of its call (op, multiplier, mode, width, exact MACs,
plan-cache hit) and each plan miss tells as a retrace; see `_OBS_SINK`
for what those count in an eager port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import zlib
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .autotune import bucket, bucket_attn, bucket_conv, heuristic_attn_block
from .error_model import SurrogateModel
from .faults import FAULT_MODES, FaultConfig, apply_weight_faults
from .luts import MAX_LUT_BITS, nibble_decomposable
from .multipliers import MultiplierSpec
from .quantization import (dequantize, fake_quant, quant_scale, quantize,
                           scale_from_max)
from ..parallel.sharding import axes_of, axes_size, shard, spec_entry

MODES = ("exact", "bit_exact", "hardware", "surrogate", "surrogate_fast")
FAMILIES = ("exact", "appro42", "mitchell", "log_our")
BACKENDS = ("cpu", "cuda")
SURROGATE_MODES = ("surrogate", "surrogate_fast")

# Surrogate noise of the model frontend.  "normal" is the
# calibration-faithful choice (the macro and conv frontends' default);
# "rademacher" (+-1 * sigma) matches the first two moments, and the
# downstream contractions re-gaussianize the error.
NOISE_KIND = "rademacher"
NOISE_KINDS = ("normal", "rademacher")


# ---------------------------------------------------------------------------
# Kernel registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One executable GEMM implementation and its routing envelope."""

    name: str
    modes: Tuple[str, ...]
    families: Tuple[str, ...]          # () = every family
    backends: Tuple[str, ...]          # () = every backend
    priority: int = 0                  # highest supported entry wins
    max_bits: int = 32
    cuda: bool = False                 # a hand-written GPU kernel
    description: str = ""
    # optional per-spec routing gate (e.g. nibble decomposability); such
    # entries are eligible only when the caller supplies a spec
    predicate: Optional[Callable[[MultiplierSpec], bool]] = dataclasses.field(
        default=None, compare=False)
    op: str = "gemm"                   # "gemm" | "conv" | "attn" (universe)

    def supports(self, family: str, mode: str, bits: int,
                 backend: str) -> bool:
        return (mode in self.modes
                and (not self.families or family in self.families)
                and (not self.backends or backend in self.backends)
                and bits <= self.max_bits)


_REGISTRY: Dict[str, KernelEntry] = {}
# set at the end of this module, once the dispatch caches exist: the
# registrations below run before them and have nothing to invalidate
_CACHES_DEFINED = False


def register_kernel(entry: KernelEntry) -> KernelEntry:
    if entry.name in _REGISTRY:
        raise ValueError(f"kernel {entry.name!r} already registered")
    _REGISTRY[entry.name] = entry
    if _CACHES_DEFINED:
        clear_dispatch_caches()    # late registration invalidates routing
    return entry


def registered_kernels() -> Tuple[KernelEntry, ...]:
    return tuple(_REGISTRY.values())


@functools.lru_cache(maxsize=1024)
def _select_kernel_cached(family: str, mode: str, bits: int, backend: str,
                          spec: Optional[MultiplierSpec]) -> KernelEntry:
    matches = [e for e in _REGISTRY.values()
               if e.op == "gemm" and e.supports(family, mode, bits, backend)
               and (e.predicate is None
                    or (spec is not None and e.predicate(spec)))]
    if not matches:
        raise ValueError(
            f"no kernel for family={family!r} mode={mode!r} bits={bits} "
            f"backend={backend!r}; registered: "
            f"{sorted(e.name for e in _REGISTRY.values() if e.op == 'gemm')}")
    return max(matches, key=lambda e: e.priority)


register_kernel(KernelEntry(
    name="torch_dot", modes=("exact",), families=(), backends=(),
    description="quantize-dequantize + torch.matmul (QAT baseline)"))
register_kernel(KernelEntry(
    name="torch_lut", modes=("bit_exact",), families=(), backends=(),
    max_bits=MAX_LUT_BITS,
    description="plain torch LUT gather oracle (validation scale)"))
register_kernel(KernelEntry(
    name="cuda_lut_gather", modes=("hardware",),
    families=("exact", "appro42"), backends=("cuda",), max_bits=8,
    cuda=True,
    description="CUDA full-LUT gather kernel, int16 table in shared memory"))
register_kernel(KernelEntry(
    name="torch_lut_gather", modes=("hardware",),
    families=("exact", "appro42"), backends=("cpu",), max_bits=8,
    description="plain version of the full-LUT gather kernel"))
register_kernel(KernelEntry(
    name="cuda_lut_nibble", modes=("hardware",),
    families=("exact", "appro42"), backends=("cuda",), priority=20,
    max_bits=8, cuda=True, predicate=nibble_decomposable,
    description="CUDA nibble-decomposed kernel (4 x 2^{b/2} int32 sub-LUTs "
                "in shared memory)"))
register_kernel(KernelEntry(
    name="torch_lut_nibble", modes=("hardware",),
    families=("exact", "appro42"), backends=("cpu",), priority=20,
    max_bits=8, predicate=nibble_decomposable,
    description="plain version of the nibble sub-LUT kernel"))
register_kernel(KernelEntry(
    name="cuda_log", modes=("hardware",), families=("mitchell", "log_our"),
    backends=("cuda",), priority=10, max_bits=16, cuda=True,
    description="CUDA arithmetic log-domain kernel (LoD + shift + OR)"))
register_kernel(KernelEntry(
    name="torch_log", modes=("hardware",), families=("mitchell", "log_our"),
    backends=("cpu",), priority=10, max_bits=16,
    description="plain version of the log-domain kernel"))
register_kernel(KernelEntry(
    name="cuda_fused_surrogate", modes=("surrogate",), families=(),
    backends=("cuda",), priority=10, max_bits=8, cuda=True,
    description="CUDA fused surrogate kernel: quantize on load, the int8 "
                "dot D and, with noise, A^2@B^2, the whole epilogue"))
register_kernel(KernelEntry(
    name="torch_surrogate", modes=SURROGATE_MODES, families=(), backends=(),
    description="dequantized dot + calibrated mean shift and noise "
                "epilogue (the reference's xla_surrogate)"))

# Attention universe (flash-style CiM attention).  Each kernel path has
# a CUDA entry for "cuda" and its plain version for "cpu", with the
# reference's priorities; the plain `torch_attn` (the twin of the
# reference's `attn_xla`) serves bit_exact on any device.  Modes: the
# quantized integer cores only; float and surrogate attention stay on the
# models layer's `_chunked_attn` path.
ATTN_MODES = ("exact", "bit_exact", "hardware")

register_kernel(KernelEntry(
    name="torch_attn", op="attn", modes=("bit_exact",), families=(),
    backends=(), max_bits=12,
    description="plain flash twin (the same bk-tiled online softmax)"))
for _dev, _cuda in (("cuda", True), ("cpu", False)):
    _pre = "cuda" if _cuda else "torch"
    _what = "CUDA flash attention" if _cuda else "plain version of the " \
        "flash attention kernel"
    register_kernel(KernelEntry(
        name=f"{_pre}_attn_mxu", op="attn", modes=("exact",), families=(),
        backends=(_dev,), priority=10, max_bits=8, cuda=_cuda,
        description=f"{_what}, exact integer dots (qmax^2*K < 2^24 gated)"))
    register_kernel(KernelEntry(
        name=f"{_pre}_attn_lut", op="attn", modes=("hardware",),
        families=("exact", "appro42"), backends=(_dev,), priority=10,
        max_bits=8, cuda=_cuda,
        description=f"{_what}, full-LUT gather QK^T/PV"))
    register_kernel(KernelEntry(
        name=f"{_pre}_attn_nibble", op="attn", modes=("hardware",),
        families=("exact", "appro42"), backends=(_dev,), priority=20,
        max_bits=8, cuda=_cuda, predicate=nibble_decomposable,
        description=f"{_what}, nibble sub-LUT QK^T/PV"))
    register_kernel(KernelEntry(
        name=f"{_pre}_attn_log", op="attn", modes=("hardware",),
        families=("mitchell", "log_our"), backends=(_dev,), priority=10,
        max_bits=12, cuda=_cuda,
        description=f"{_what}, log-domain QK^T/PV"))


def select_kernel(family: str, mode: str, bits: int, backend: str,
                  spec: Optional[MultiplierSpec] = None) -> KernelEntry:
    """Route one (family, mode, bits, backend) request to a kernel.

    `backend` is the operands' device type ("cuda" or "cpu").  `spec`
    unlocks predicate-gated entries (the nibble kernel).  Memoized."""
    _check_request(family, mode, backend)
    return _select_kernel_cached(family, mode, bits, backend, spec)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """A routed GEMM: which kernel on which backend."""

    entry: KernelEntry
    backend: str


def plan_gemm(family: str, mode: str, bits: int, m: int, k: int, n: int,
              backend: str, spec: Optional[MultiplierSpec] = None,
              mesh=None, x_spec=None,
              w_spec=None) -> Union[GemmPlan, "MeshPlan"]:
    """select_kernel for a concrete (bucketed) shape.  The kernels' tile
    sizes are fixed in this slice, so the shape only keys the plan.

    With `mesh` (and the partition specs `x_spec` over the (M, K) rows,
    `w_spec` over the (K, N) weight) the result is a `MeshPlan`: the
    shard-local plan for the per-rank extents of the global (m, k, n)
    plus the layout (see "Mesh-partitioned planning" below).  Only the
    integer modes (`MESH_MODES`) qualify."""
    if mesh is None:
        return GemmPlan(entry=select_kernel(family, mode, bits, backend,
                                            spec), backend=backend)
    _check_request(family, mode, backend)
    _check_mesh_gemm(mode, m, k, n, mesh, x_spec, w_spec)
    dp, wk, wn, (ml, kl, nl) = _mesh_gemm_layout(m, k, n, mesh, x_spec,
                                                 w_spec)
    return _plan_gemm_mesh_cached(family, mode, bits, bucket(ml),
                                  bucket(kl), bucket(nl), backend, spec,
                                  mesh, dp, wk, wn)


# ---------------------------------------------------------------------------
# Mesh-partitioned planning (the JAX package's DESIGN.md §11)
#
# A mesh GEMM runs one shard-local kernel per rank, in one of two
# tensor-parallel layouts picked by which weight dim `w_spec` shards:
#
#   * contraction-sharded (w_spec ("model", None): K; a conv's input
#     channels): each rank quantizes its slice of K against the GLOBAL
#     scales and runs a partial kernel that returns the raw int32 sum;
#     the sums are added over the model axis (exact in any order) and the
#     (acc * sx) * sw epilogue runs after;
#   * output-sharded (w_spec (None, "model")): each rank owns its output
#     columns with the whole K; nothing separates quantization from the
#     epilogue, so the rank runs the fused kernel with the global sx and
#     its slice of sw.
#
# The rows ride along on the data axes (`x_spec`'s first entry) in either
# layout.  The global scales are max-reductions over the shards (max is
# exact in any order), so every rank quantizes against the single-device
# values and the result is bit-identical to it.  Float modes would
# reassociate float partial sums and are refused here.
# ---------------------------------------------------------------------------

MESH_MODES = ("bit_exact", "hardware")


def _canon_spec(spec) -> Optional[Tuple]:
    """Hashable canonical form of a partition spec (a cache-key part)."""
    return None if spec is None else tuple(spec)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A mesh-partitioned GEMM or conv: the shard-local inner plan and
    the layout.  `dp` are the axes the rows (a conv's batch) split over,
    `wk` those the contraction (K, a conv's channels) splits over, which
    the int32 partial sums are reduced over, `wn` those the output
    columns split over; `local_shape` the per-rank (m, k, n), or (b, h,
    w, c, n) for a conv (bucketed)."""

    plan: Union[GemmPlan, "ConvPlan"]
    mesh: object
    dp: Tuple[str, ...]
    wk: Tuple[str, ...]
    wn: Tuple[str, ...]
    local_shape: Tuple[int, ...]

    @property
    def entry(self) -> KernelEntry:
        return self.plan.entry

    @property
    def reduce_axes(self) -> Tuple[str, ...]:
        return self.wk

    @property
    def x_axes(self) -> Tuple[str, ...]:
        """Every axis the activation is split over: its global max (sx)
        is reduced over them."""
        return self.dp + self.wk


def _mesh_axes(mesh, x_spec, w_spec):
    """(dp, wk, wn) of a request: the axes of x's rows, w's K and w's N,
    validated against the mesh."""
    xs = tuple(x_spec) if x_spec is not None else (None, None)
    ws = tuple(w_spec) if w_spec is not None else (None, None)
    dp = axes_of(xs[0] if xs else None)
    wk = axes_of(ws[0] if len(ws) > 0 else None)
    wn = axes_of(ws[1] if len(ws) > 1 else None)
    if wk and wn:
        raise ValueError(
            f"mesh GEMM: w sharded on both K ({wk}) and N ({wn}); pick "
            "one tensor-parallel layout")
    for ax in (*dp, *wk, *wn):
        if ax not in mesh.shape:
            raise ValueError(f"axis {ax!r} not in mesh {dict(mesh.shape)}")
    if set(dp) & (set(wk) | set(wn)):
        raise ValueError(f"row axes {dp} collide with weight axes")
    return dp, wk, wn


def _mesh_gemm_layout(m: int, k: int, n: int, mesh, x_spec, w_spec):
    """Validate and canonicalize a GEMM mesh request on the RAW global
    shape (two shapes of one bucket can differ in divisibility): returns
    (dp, wk, wn) and the shard-local (m, k, n)."""
    dp, wk, wn = _mesh_axes(mesh, x_spec, w_spec)
    for what, dim, axes in (("M", m, dp), ("K", k, wk), ("N", n, wn)):
        size = axes_size(mesh, axes)
        if dim % size:
            raise ValueError(
                f"mesh GEMM: {what}={dim} not divisible by axes "
                f"{axes} (size {size})")
    return dp, wk, wn, (m // axes_size(mesh, dp), k // axes_size(mesh, wk),
                        n // axes_size(mesh, wn))


def _check_mesh_mode(mode: str) -> None:
    if mode not in MESH_MODES:
        raise ValueError(
            f"mesh execution supports the integer modes {MESH_MODES}; "
            f"mode {mode!r} reassociates float partial sums (the models "
            "layer runs the float modes' tensor parallelism itself)")


def _check_mesh_gemm(mode: str, m: int, k: int, n: int, mesh, x_spec,
                     w_spec) -> None:
    """Exact-shape validation of one mesh GEMM request (mode, layout,
    divisibility).  The frontends run it on every call, before the
    bucketed plan cache can answer."""
    _check_mesh_mode(mode)
    _mesh_gemm_layout(m, k, n, mesh, x_spec, w_spec)


@functools.lru_cache(maxsize=512)
def _plan_gemm_mesh_cached(family: str, mode: str, bits: int, mbl: int,
                           kbl: int, nbl: int, backend: str,
                           spec: Optional[MultiplierSpec], mesh,
                           dp: Tuple[str, ...], wk: Tuple[str, ...],
                           wn: Tuple[str, ...]) -> "MeshPlan":
    inner = plan_gemm(family, mode, bits, mbl, kbl, nbl, backend, spec)
    if inner.entry.name not in PARTIAL_RUNNERS:
        raise ValueError(
            f"kernel {inner.entry.name!r} has no shard-local (partial) "
            f"runner; mesh execution supports {sorted(PARTIAL_RUNNERS)}")
    return MeshPlan(plan=inner, mesh=mesh, dp=dp, wk=wk, wn=wn,
                    local_shape=(mbl, kbl, nbl))


# ---------------------------------------------------------------------------
# Static GEMM parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GemmParams:
    """Static description of one approximate GEMM."""

    family: str = "exact"
    bits: int = 8
    mode: str = "surrogate"
    mu: float = 0.0                    # calibrated relative bias
    c0: float = 0.0                    # variance floor (int^2 units)
    c1: float = 0.0                    # variance slope on p^2
    compressor: str = "yang1"
    n_approx_cols: Optional[int] = None
    # per-row activation scales: each row of x quantizes against its own
    # max, so a row's result does not depend on the other rows (the
    # speculative-decoding verifier, serving/spec.py); the fused runners
    # carry one scalar sx, so integer modes take the int route
    per_token: bool = False
    # as-fabricated stuck-at defects (core/faults.py): faults the stored
    # LUT tables and the quantized weight words of the integer datapaths.
    # Part of every plan key, so a faulted lane and a clean one never
    # share a plan.  The fused runners quantize on load, so the word
    # surgery has no place there: a faulted call takes the int route
    fault: Optional[FaultConfig] = None

    def __post_init__(self):
        if self.fault is not None and self.mode not in FAULT_MODES:
            raise ValueError(
                f"fault injection needs an integer storage domain "
                f"(modes {FAULT_MODES}); mode {self.mode!r} stores no "
                "words or tables to fault")

    @property
    def spec(self) -> MultiplierSpec:
        return MultiplierSpec(self.family, self.bits, True,
                              self.compressor, self.n_approx_cols)

    @property
    def routing_spec(self) -> Optional[MultiplierSpec]:
        """The spec the planners route with: None under a fault, since
        the predicate-gated entries (the nibble kernels) hold the clean
        sub-tables and cannot see the defect map, so a faulted GEMM
        routes to the full-LUT gather, whose table is faulted."""
        return None if self.fault is not None else self.spec

    @classmethod
    def from_spec(cls, spec: MultiplierSpec, surrogate: SurrogateModel,
                  mode: str,
                  fault: Optional[FaultConfig] = None) -> "GemmParams":
        return cls(family=spec.family, bits=spec.bits, mode=mode,
                   mu=surrogate.mu_rel, c0=surrogate.c0_abs,
                   c1=surrogate.c1_rel, compressor=spec.compressor,
                   n_approx_cols=spec.n_approx_cols, fault=fault)


# ---------------------------------------------------------------------------
# Runners: integer route (int8 in, int32 out) and fused route (float in,
# f32 out).  The kernel wrappers pick the CUDA kernel or the plain
# version by the operands' device.
# ---------------------------------------------------------------------------


def _run_ref_lut(xq, wq, gp: GemmParams):
    from repro_torch.kernels import ops, ref

    table = (ops.lut_table(gp.spec, xq.device) if gp.fault is None
             else ops.faulted_lut_table(gp.spec, gp.fault, xq.device))
    return ref.lut_matmul_ref(xq, wq, table, gp.bits)


def _run_lut(xq, wq, gp: GemmParams):
    from repro_torch.kernels import ops

    if gp.fault is not None:       # the faulted table: the magnitude form
        return ops.approx_matmul_faulted(xq, wq, gp.spec, gp.fault)
    return ops.approx_matmul_bit_exact(xq, wq, gp.spec)


def _run_nibble(xq, wq, gp: GemmParams):
    from repro_torch.kernels import ops

    if gp.fault is not None:
        raise ValueError("the nibble kernels hold the clean sub-tables; a "
                         "faulted GEMM routes to the full-LUT gather "
                         "(GemmParams.routing_spec)")
    return ops.nibble_matmul_bit_exact(xq, wq, gp.spec)


def _run_log(xq, wq, gp: GemmParams):
    from repro_torch.kernels import ops

    return ops.log_matmul(xq, wq, bits=gp.bits,
                          compensated=(gp.family == "log_our"))


def _run_fused_lut(x, w, gp: GemmParams):
    from repro_torch.kernels import ops

    return ops.approx_matmul_fused(x, w, gp.spec)


def _run_fused_nibble(x, w, gp: GemmParams):
    from repro_torch.kernels import ops

    return ops.nibble_matmul_fused(x, w, gp.spec)


def _run_fused_log(x, w, gp: GemmParams):
    from repro_torch.kernels import ops

    return ops.log_matmul_fused(x, w, bits=gp.bits,
                                compensated=(gp.family == "log_our"))


# entry name -> int8 (M,K) x int8 (K,N) -> int32 (M,N)
INT_RUNNERS: Dict[str, Callable] = {
    "torch_lut": _run_ref_lut,
    "cuda_lut_gather": _run_lut,
    "torch_lut_gather": _run_lut,
    "cuda_lut_nibble": _run_nibble,
    "torch_lut_nibble": _run_nibble,
    "cuda_log": _run_log,
    "torch_log": _run_log,
}

# entry name -> float (M,K) x float (K,N) -> f32 (M,N); quantization and
# the (acc * sx) * sw epilogue run inside the kernel
FUSED_RUNNERS: Dict[str, Callable] = {
    "cuda_lut_gather": _run_fused_lut,
    "torch_lut_gather": _run_fused_lut,
    "cuda_lut_nibble": _run_fused_nibble,
    "torch_lut_nibble": _run_fused_nibble,
    "cuda_log": _run_fused_log,
    "torch_log": _run_fused_log,
}


# ---------------------------------------------------------------------------
# Shard-local runners of the mesh path: float (M, K_shard) x (K_shard, N)
# shards and the GLOBAL scales (sx one element, sw (N,)) in; the partial
# runners return the raw int32 sum, the scaled fused runners (the
# output-sharded layout) f32 through the epilogue.
# ---------------------------------------------------------------------------


def _partial_ref_lut(x, w, sx, sw, gp: GemmParams):
    from repro_torch.kernels import ops, ref

    xq = quantize(x.to(torch.float32), sx, gp.bits)
    wq = quantize(w.to(torch.float32), sw.reshape(1, -1), gp.bits)
    return ref.lut_matmul_ref(xq, wq, ops.lut_table(gp.spec, x.device),
                              gp.bits)


def _partial_lut(x, w, sx, sw, gp: GemmParams):
    from repro_torch.kernels import ops

    return ops.lut_partial_acc(x, w, gp.spec, sx, sw)


def _partial_nibble(x, w, sx, sw, gp: GemmParams):
    from repro_torch.kernels import ops

    return ops.nibble_partial_acc(x, w, gp.spec, sx, sw)


def _partial_log(x, w, sx, sw, gp: GemmParams):
    from repro_torch.kernels import ops

    return ops.log_partial_acc(x, w, sx, sw, bits=gp.bits,
                               compensated=(gp.family == "log_our"))


# entry name -> shard-local float (M, K_shard) x (K_shard, N) -> int32 (M, N)
PARTIAL_RUNNERS: Dict[str, Callable] = {
    "torch_lut": _partial_ref_lut,
    "cuda_lut_gather": _partial_lut,
    "torch_lut_gather": _partial_lut,
    "cuda_lut_nibble": _partial_nibble,
    "torch_lut_nibble": _partial_nibble,
    "cuda_log": _partial_log,
    "torch_log": _partial_log,
}


def _scaled_lut(x, w, sx, sw, gp: GemmParams):
    from repro_torch.kernels import ops

    return ops.lut_fused_scaled(x, w, gp.spec, sx, sw)


def _scaled_nibble(x, w, sx, sw, gp: GemmParams):
    from repro_torch.kernels import ops

    return ops.nibble_fused_scaled(x, w, gp.spec, sx, sw)


def _scaled_log(x, w, sx, sw, gp: GemmParams):
    from repro_torch.kernels import ops

    return ops.log_fused_scaled(x, w, sx, sw, bits=gp.bits,
                                compensated=(gp.family == "log_our"))


# entry name -> the fused kernel with caller-supplied scales (the
# output-sharded layout); torch_lut has none and keeps partial + epilogue
SCALED_FUSED_RUNNERS: Dict[str, Callable] = {
    "cuda_lut_gather": _scaled_lut,
    "torch_lut_gather": _scaled_lut,
    "cuda_lut_nibble": _scaled_nibble,
    "torch_lut_nibble": _scaled_nibble,
    "cuda_log": _scaled_log,
    "torch_log": _scaled_log,
}


def run_int_kernel(plan: GemmPlan, xq, wq, gp: GemmParams):
    """Execute the integer core of a routed bit_exact/hardware GEMM."""
    try:
        runner = INT_RUNNERS[plan.entry.name]
    except KeyError:
        raise ValueError(
            f"kernel {plan.entry.name!r} has no integer runner") from None
    return runner(xq, wq, gp)


# A per-token float product runs in blocks of this many rows, the last
# padded with zero rows: every block is one product of the same shape, so
# a row's result does not depend on how many rows it is batched with.
# (cuBLAS picks its kernel, and with it the order of a sum, by M: on an
# H100 a row of the (64, 6144) @ (6144, 2048) product differs from the
# same row of a 16-row one, which moved a prefilled request's cache.)
# 64 rows: a 4 x 512 prefill of qwen3-1.7b takes 1.8x the unblocked
# product's host time against 5.3x in 16-row blocks, and a decode round
# pads its 4 rows at no measurable cost (launch/row_block_ab.py).  One
# strided-batched product over the blocks is not row-pure there.
ROW_BLOCK = 64


def row_block_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, N) in ROW_BLOCK-row blocks."""
    a2 = a.reshape(-1, a.shape[-1])
    m = a2.shape[0]
    pad = -m % ROW_BLOCK
    if pad:
        a2 = F.pad(a2, (0, 0, 0, pad))
    out = torch.cat([a2[i:i + ROW_BLOCK] @ b
                     for i in range(0, m + pad, ROW_BLOCK)])
    return out[:m].reshape(*a.shape[:-1], b.shape[-1])


def _quantize_operands(x, w, bits, per_token: bool = False):
    # activations: per-tensor scale (the macro's ADC view), or an (M, 1)
    # per-row one for `per_token`; weights: per-out-channel
    sx = quant_scale(x, bits, axis=-1 if per_token else None)
    sw = quant_scale(w, bits, axis=0)
    return quantize(x, sx, bits), sx, quantize(w, sw, bits), sw


# ---------------------------------------------------------------------------
# Surrogate noise: explicit keys and the variance law
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NoiseKey:
    """An explicit surrogate-noise key: one 64-bit seed.

    ``child(name)`` derives an independent key from (seed, crc32(name))
    through numpy's SeedSequence (the reference folds crc32(name) into a
    JAX key); `generator` seeds a fresh `torch.Generator` on a device, so
    a draw touches no global RNG state and the same key on the same
    device always gives the same noise."""

    seed: int

    def __post_init__(self):
        if not 0 <= int(self.seed) < 1 << 64:
            raise ValueError(f"seed must be a 64-bit unsigned int, got "
                             f"{self.seed}")

    def child(self, name: str) -> "NoiseKey":
        ss = np.random.SeedSequence([int(self.seed),
                                     zlib.crc32(name.encode())])
        return NoiseKey(int(ss.generate_state(1, np.uint64)[0]))

    def generator(self, device) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(int(self.seed))


def surrogate_noise(key: NoiseKey, shape, device,
                    kind: str = "normal") -> torch.Tensor:
    """f32 noise of `shape` on `device` from `key`: standard normal, or
    rademacher (+-1 with equal odds)."""
    if not isinstance(key, NoiseKey):
        raise TypeError(f"a NoiseKey is expected, got {type(key).__name__}")
    g = key.generator(device)
    if kind == "normal":
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.float32)
    if kind == "rademacher":
        bits = torch.randint(0, 2, shape, generator=g, device=device,
                             dtype=torch.int32)
        return (2 * bits - 1).to(torch.float32)
    raise ValueError(f"noise kind {kind!r} not in {NOISE_KINDS}")


def surrogate_variance(gp: "GemmParams", scale2, k_len: int, xf=None,
                       wf=None, fast: bool = False,
                       reduce: Optional[Callable] = None):
    """var[out] = c0 * K * s^2 + c1 * (A^2 @ B^2), the calibrated law.

    `scale2` is the squared product of quantization scales broadcastable
    to the output; `xf`/`wf` the dequantized operands for the c1 term
    (``fast``: the rank-1 estimate sum_k a^2 * sum_k b^2 / K of
    ``surrogate_fast``); `k_len` the whole contraction.  `reduce` (the
    identity by default) completes each sum over K: on shards, the sum
    over the other K shards.  None when the family carries no noise."""
    if gp.c0 <= 0.0 and gp.c1 <= 0.0:
        return None
    red = reduce or (lambda t: t)
    var = gp.c0 * k_len * scale2
    if gp.c1 > 0.0 and xf is not None and wf is not None:
        if fast:
            a2 = red(torch.sum(xf * xf, dim=-1, keepdim=True))   # (M, 1)
            b2 = red(torch.sum(wf * wf, dim=0, keepdim=True))    # (1, N)
            sq = a2 * b2 / k_len
        else:
            sq = red((xf * xf) @ (wf * wf))
        var = var + gp.c1 * sq
    return var


def _draws_noise(gp: "GemmParams", key, apply: bool = True) -> bool:
    """The reference's `stochastic`: a surrogate mode, a key, and a
    variance law that is not zero."""
    return (apply and gp.mode in SURROGATE_MODES and key is not None
            and (gp.c0 > 0.0 or gp.c1 > 0.0))


class _STEMatmul(torch.autograd.Function):
    """A rank-2 (x2, w, eps) -> out forward with the exact-float STE VJP;
    the pre-drawn surrogate noise eps (None without noise) rides through
    with a zero cotangent."""

    @staticmethod
    def forward(ctx, x2, w, eps, forward):
        ctx.save_for_backward(x2, w)
        ctx.eps_dtype = None if eps is None else eps.dtype
        return forward(x2, w, eps)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        dt = torch.promote_types(g.dtype, w.dtype)
        gx = g.to(dt) @ w.to(dt).T
        gw = x2.to(dt).T @ g.to(dt)
        geps = (torch.zeros(g.shape, dtype=ctx.eps_dtype, device=g.device)
                if ctx.needs_input_grad[2] else None)
        return gx.to(x2.dtype), gw.to(w.dtype), geps, None


def _ste(forward: Callable) -> Callable:
    """Flatten leading dims, run `forward` (x2, w, eps) under the STE,
    restore."""

    def run(x, w, eps=None):
        x2 = x.reshape(-1, x.shape[-1])
        out = _STEMatmul.apply(x2, w, eps, forward)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    return run


def mean_shift(d: torch.Tensor, mu: float) -> torch.Tensor:
    """The surrogate's mean shift, (1 + mu) * d, with the factor rounded
    to d's dtype first, as the reference's weakly typed Python float is."""
    return d * torch.tensor(1.0 + mu, dtype=d.dtype).item()


def _run_fused_surrogate(x, w, eps, gp: GemmParams):
    from repro_torch.kernels import ops

    return ops.surrogate_gemm_fused(x, w, eps, gp.mu, gp.c0, gp.c1,
                                    bits=gp.bits)


def _fused_route(gp: GemmParams, plan: GemmPlan) -> bool:
    """Does an integer-mode GEMM run its fused runner?  Those carry one
    scalar sx and quantize on load: per-token (M, 1) scales and faulted
    weight words take the int route, the epilogue outside the kernel."""
    return (not gp.per_token and gp.fault is None
            and plan.entry.name in FUSED_RUNNERS)


def _fault_words(wq: torch.Tensor, gp: GemmParams) -> torch.Tensor:
    """The stored weight words as the macro reads them back (unchanged
    without a fault)."""
    if gp.fault is None:
        return wq
    return apply_weight_faults(wq, gp.fault, gp.bits)


def _cim_core(gp: GemmParams, plan: GemmPlan) -> Callable:
    """Macro frontend's rank-2 forward (xf, wf, eps=None): true
    quantization, f32 out; eps is the pre-drawn surrogate noise (None:
    the deterministic term, and always for the integer modes)."""
    mode = gp.mode
    if mode == "exact":
        def forward(xf, wf, eps=None):
            xq, sx, wq, sw = _quantize_operands(xf, wf, gp.bits,
                                                gp.per_token)
            wq = _fault_words(wq, gp)
            mm = row_block_mm if gp.per_token else torch.matmul
            return mm(dequantize(xq, sx), dequantize(wq, sw))
    elif mode in ("bit_exact", "hardware"):
        if _fused_route(gp, plan):
            runner = FUSED_RUNNERS[plan.entry.name]

            def forward(xf, wf, eps=None):
                return runner(xf, wf, gp)
        else:
            def forward(xf, wf, eps=None):
                xq, sx, wq, sw = _quantize_operands(
                    xf.to(torch.float32), wf.to(torch.float32), gp.bits,
                    gp.per_token)
                acc = run_int_kernel(plan, xq, _fault_words(wq, gp), gp)
                return (acc.to(torch.float32) * sx) * sw
    elif plan.entry.name == "cuda_fused_surrogate":
        def forward(xf, wf, eps=None):
            return _run_fused_surrogate(xf, wf, eps, gp)
    else:  # torch_surrogate: dequantized dot + the epilogue
        # the surrogate forms quantize per tensor whatever `per_token`
        # says, as the reference's surrogate branches do
        def forward(xf, wf, eps=None):
            xq, sx, wq, sw = _quantize_operands(xf, wf, gp.bits)
            xdq, wdq = dequantize(xq, sx), dequantize(wq, sw)
            out = mean_shift(xdq @ wdq, gp.mu)
            if eps is not None:
                s = sx * sw                    # (1, N): per-out-channel
                var = surrogate_variance(gp, s * s, xf.shape[-1], xdq, wdq,
                                         fast=(mode == "surrogate_fast"))
                if var is not None:
                    out = out + torch.sqrt(torch.clamp_min(var, 0.0)) * eps
            return out
    return forward


def _cim_forward(gp: GemmParams, plan: GemmPlan) -> Callable:
    """Macro frontend: `_cim_core` under the STE."""
    return _ste(_cim_core(gp, plan))


def _model_forward(gp: GemmParams, plan: GemmPlan, apply: bool) -> Callable:
    """Model frontend (x, w, eps=None): kernel-backed STE for the integer
    modes and for surrogate on the card, the fake-quant QAT form
    otherwise; the activation dtype is preserved.  eps is the pre-drawn
    (M, N) f32 surrogate noise, None for the deterministic term."""
    if apply and gp.mode in ("bit_exact", "hardware"):
        if _fused_route(gp, plan):
            runner = FUSED_RUNNERS[plan.entry.name]

            def forward(x2, wf, eps=None):
                # the kernels widen bf16 operands on load (exact), so no
                # f32 copy of the weight is made
                return runner(x2, wf, gp).to(x2.dtype)
        else:
            # per-token or faulted: the int kernel on the quantized (and
            # faulted) operands, the (acc * sx) * sw epilogue outside it
            def forward(x2, wf, eps=None):
                xq, sx, wq, sw = _quantize_operands(
                    x2.to(torch.float32), wf.to(torch.float32), gp.bits,
                    gp.per_token)
                acc = run_int_kernel(plan, xq, _fault_words(wq, gp), gp)
                return ((acc.to(torch.float32) * sx) * sw).to(x2.dtype)
        return _ste(forward)

    if apply and plan.entry.name == "cuda_fused_surrogate":
        # the production path on the card: one kernel, bf16 widened on
        # load, one scalar sx whatever `per_token` says (the reference's
        # fused surrogate branch does not read it either)
        def forward(x2, wf, eps=None):
            return _run_fused_surrogate(x2, wf, eps, gp).to(x2.dtype)
        return _ste(forward)

    # exact / surrogate paths: fake-quant QAT form, the weight in ITS dtype;
    # `per_token` quantizes x per row, the noise's sx stays per tensor (as
    # in the reference)
    def fn(x, w, eps=None):
        xq = fake_quant(x, gp.bits, axis=-1 if gp.per_token else None)
        if apply and gp.fault is not None:
            # the as-fabricated exact macro: true-quantize the weight,
            # fault its stored words, dequantize, under the STE (the
            # gradient flows to w as through fake_quant)
            wd = w.detach().to(torch.float32)
            sw = quant_scale(wd, gp.bits, axis=0)
            wi = apply_weight_faults(quantize(wd, sw, gp.bits), gp.fault,
                                     gp.bits)
            wdq = dequantize(wi, sw).to(w.dtype)
            wq = (w + (wdq - w).detach()).to(x.dtype)
        else:
            wq = fake_quant(w, gp.bits, axis=0).to(x.dtype)
        d = row_block_mm(xq, wq) if gp.per_token else xq @ wq
        if not apply or gp.mode == "exact":
            return d
        out = mean_shift(d, gp.mu)
        if eps is not None:
            sx = quant_scale(x.detach(), gp.bits)
            sw = quant_scale(w.detach(), gp.bits, axis=0)
            s = (sx * sw).to(torch.float32)
            xf = wf = None
            if gp.c1 > 0.0:
                xf = xq.detach().to(torch.float32)
                wf = wq.detach().to(torch.float32)
            var = surrogate_variance(gp, s * s, x.shape[-1], xf, wf,
                                     fast=(gp.mode == "surrogate_fast"))
            if var is not None:
                noise = (torch.sqrt(torch.clamp_min(var, 0.0)).to(d.dtype)
                         * eps.reshape(d.shape).to(d.dtype))
                out = out + noise.detach()
        return out

    return fn


# ---------------------------------------------------------------------------
# Plan cache (the port's zero-retrace contract)
# ---------------------------------------------------------------------------

_FORWARDS: Dict[Tuple, Callable] = {}
_LOCK = threading.Lock()
_PLAN_MISSES = [0]


def plan_misses() -> int:
    """Plans built so far (new (GemmParams, bucketed shape, backend)
    keys); flat in steady state."""
    return _PLAN_MISSES[0]


# Observability sink (obs/): a host-side object told of every frontend
# call, with its operation, multiplier, mode, width, exact MAC count and
# whether the plan cache held its plan, and of every plan built.  The
# reference's sink hears only eager calls and traces (a jitted replay
# never re-enters its frontends); the port runs eagerly, so its sink
# hears every call: `repro_dispatch_calls_total{cache="hit"}` grows with
# the traffic, and the live `repro_dispatch_macs_total` is every MAC the
# frontends ran.  `None` (the default) costs one list load and a branch.
_OBS_SINK: List[Optional[object]] = [None]


def set_obs_sink(sink) -> Optional[object]:
    """Install the dispatch-boundary telemetry sink; returns the previous
    one, so a scoped capture (obs/energy.py) can restore it.  The sink
    must expose ``dispatch(op, family, mode, bits, macs, cache_hit)``
    and ``retrace()``."""
    prev = _OBS_SINK[0]
    _OBS_SINK[0] = sink
    return prev


def _obs_dispatch(op: str, gp: "GemmParams", macs: float,
                  cache_hit: bool) -> None:
    _OBS_SINK[0].dispatch(op=op, family=gp.family, mode=gp.mode,
                          bits=gp.bits, macs=macs, cache_hit=cache_hit)


def _plan_miss() -> None:
    """Count one plan built; a plan miss is the port's form of the
    reference's executable trace, so the sink hears it as `retrace`."""
    _PLAN_MISSES[0] += 1
    sink = _OBS_SINK[0]
    if sink is not None:
        sink.retrace()


def clear_dispatch_caches() -> None:
    """Drop the plan cache and the memoized routing table (tests)."""
    with _LOCK:
        _FORWARDS.clear()
    _select_kernel_cached.cache_clear()
    _entries_cached.cache_clear()
    _plan_conv_cached.cache_clear()
    _plan_attn_cached.cache_clear()
    _plan_gemm_mesh_cached.cache_clear()
    _plan_conv_mesh_cached.cache_clear()


def _backend(x: torch.Tensor, w: torch.Tensor) -> str:
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    return x.device.type


# the dispatch sink's op names of the GEMM frontends (the reference's)
_OBS_OPS = {"cim": "gemm", "model": "model_gemm"}


def _cached(key, build: Callable, op: str, gp: GemmParams,
            macs: float) -> Callable:
    """The forward under `key` in the plan cache, built by `build` on a
    miss (counted by `_plan_miss`); the call told to the sink as `op`
    with its MACs."""
    fn = _FORWARDS.get(key)
    if _OBS_SINK[0] is not None:
        _obs_dispatch(op, gp, macs, fn is not None)
    if fn is None:
        with _LOCK:
            fn = _FORWARDS.get(key)
            if fn is None:
                fn = _FORWARDS[key] = build()
                _plan_miss()
    return fn


def _forward_for(frontend: str, gp: GemmParams, apply: bool, noisy: bool,
                 x: torch.Tensor, w: torch.Tensor) -> Callable:
    m = 1
    for s in x.shape[:-1]:
        m *= int(s)
    k, n = x.shape[-1], w.shape[-1]
    backend = _backend(x, w)
    key = (frontend, gp, apply, noisy, x.dtype, w.dtype, bucket(m),
           bucket(k), bucket(n), backend)

    def build():
        if gp.mode not in MODES:
            raise ValueError(f"mode {gp.mode!r} not in {MODES}")
        plan = plan_gemm(gp.family, gp.mode if apply else "exact", gp.bits,
                         m, k, n, backend, spec=gp.routing_spec)
        return (_cim_forward(gp, plan) if frontend == "cim"
                else _model_forward(gp, plan, apply))

    return _cached(key, build, _OBS_OPS[frontend], gp, float(m) * k * n)


def _noise(noisy: bool, key, x: torch.Tensor, n: int, kind: str):
    """The (M, N) f32 noise of one call (None without noise)."""
    if not noisy:
        return None
    return surrogate_noise(key, (x.numel() // x.shape[-1], n), x.device,
                           kind)


# ---------------------------------------------------------------------------
# Mesh forwards: one shard-local kernel per rank (see "Mesh-partitioned
# planning" above)
# ---------------------------------------------------------------------------


def _global_max(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """max |t| over the shards of `axes` (f32; exact in any order)."""
    return mesh.all_reduce(t.to(torch.float32).abs().amax(), "max", axes)


def _global_colmax(w: torch.Tensor, mesh, axes, dims=0) -> torch.Tensor:
    """max |w| per output column over `dims` and the shards of `axes`
    (f32, (N,)); the max of a bf16 weight is taken in bf16 and widened
    after (exact), so the weight is never copied."""
    return mesh.all_reduce(w.abs().amax(dim=dims).to(torch.float32), "max",
                           axes)


def _mesh_core(gp: GemmParams, mp: MeshPlan) -> Callable:
    """The shard-local (x_l (M_l, K_l), w_l (K_l, N_l)) -> f32 (M_l, N_l)
    forward of a mesh GEMM: the global scales from max-reductions over
    the shards, then the fused kernel (output-sharded) or the partial
    kernel, the int32 sum over `wk` and the epilogue (contraction-
    sharded)."""
    mesh, red = mp.mesh, mp.reduce_axes
    fused = None if red else SCALED_FUSED_RUNNERS.get(mp.entry.name)
    partial = PARTIAL_RUNNERS[mp.entry.name]

    def forward(x_l, w_l):
        sx = scale_from_max(_global_max(x_l, mesh, mp.x_axes), gp.bits)
        sw = scale_from_max(_global_colmax(w_l, mesh, red), gp.bits)
        if fused is not None:
            return fused(x_l, w_l, sx, sw, gp)
        acc = partial(x_l, w_l, sx, sw, gp)
        acc = mesh.all_reduce(acc, "sum", red)
        return (acc.to(torch.float32) * sx) * sw

    return forward


def _check_mesh_gemm_request(gp: GemmParams) -> None:
    if gp.per_token:
        raise ValueError(
            "per-token activation scales are not supported on the mesh "
            "path (the shards quantize against global per-tensor scales); "
            "drop the mesh or per_token")
    if gp.fault is not None:
        raise ValueError(
            "fault injection is not supported on the mesh path (the "
            "shard kernels quantize their words on load); drop the mesh "
            "or the fault config")


def _mesh_matmul(frontend: str, gp: GemmParams, x: torch.Tensor,
                 w: torch.Tensor, mesh, x_spec, w_spec, local: bool,
                 preserve_dtype: bool) -> torch.Tensor:
    """One mesh GEMM.  `local`: x (..., K_l) and w (K_l, N_l) are this
    rank's shards and so is the result (the models layer); else x and w
    are the global tensors, the same on every rank, which each rank cuts
    to its shards, and the result is gathered whole on every rank."""
    _check_mesh_gemm_request(gp)
    dp, wk, wn = _mesh_axes(mesh, x_spec, w_spec)
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    m, n = x2.shape[0], w.shape[-1]
    if local:
        m, k, n = (m * axes_size(mesh, dp), k * axes_size(mesh, wk),
                   n * axes_size(mesh, wn))
    # every call: divisibility is not bucket-stable
    _check_mesh_gemm(gp.mode, m, k, n, mesh, x_spec, w_spec)
    backend = _backend(x, w)
    key = ("mesh", frontend, gp, x.dtype, w.dtype, bucket(m), bucket(k),
           bucket(n), backend, mesh.key, _canon_spec(x_spec),
           _canon_spec(w_spec))
    # the global product's MACs, as the reference's GSPMD frontend sees it
    fn = _cached(key, lambda: _mesh_core(gp, plan_gemm(
        gp.family, gp.mode, gp.bits, m, k, n, backend, spec=gp.routing_spec,
        mesh=mesh, x_spec=x_spec, w_spec=w_spec)), _OBS_OPS[frontend], gp,
        float(m) * k * n)

    def forward(x2_, w_, eps=None):
        if not local:
            x2_ = shard(x2_, (spec_entry(dp), spec_entry(wk)), mesh)
            w_ = shard(w_, (spec_entry(wk), spec_entry(wn)), mesh)
        out = fn(x2_, w_)
        if preserve_dtype:
            out = out.to(x.dtype)
        if not local:
            out = mesh.all_gather(mesh.all_gather(out, wn, 1), dp, 0)
        return out

    if local:            # the models layer (inference): no STE here
        out = forward(x2, w)
    else:
        out = _STEMatmul.apply(x2, w, None, forward)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def cim_matmul(x: torch.Tensor, w: torch.Tensor, gp: GemmParams,
               key: Optional[NoiseKey] = None, *,
               noise_kind: str = "normal", mesh=None, x_spec=None,
               w_spec=None) -> torch.Tensor:
    """Dispatch + execute one approximate GEMM (macro semantics).

    x: (..., K) float; w: (K, N) float, on one device.  Returns float32
    (..., N) with straight-through exact gradients.  In a surrogate mode
    a `key` draws the calibrated noise (`noise_kind`, normal by default)
    on the operands' device; without one the output is the deterministic
    term.

    With `mesh` (a launch.mesh.Mesh; `x_spec` over the flattened (M, K)
    rows, `w_spec` over (K, N), see `plan_gemm`) every rank passes the
    same global x and w, runs one shard-local kernel on its shards and
    gets the whole result: bit-identical to the call without a mesh, for
    the integer modes only (`MESH_MODES`)."""
    if mesh is not None:
        return _mesh_matmul("cim", gp, x, w, mesh, x_spec, w_spec,
                            local=False, preserve_dtype=False)
    noisy = _draws_noise(gp, key)
    eps = _noise(noisy, key, x, w.shape[-1], noise_kind)
    return _forward_for("cim", gp, True, noisy, x, w)(x, w, eps)


def model_matmul(x: torch.Tensor, w: torch.Tensor, gp: GemmParams,
                 key: Optional[NoiseKey] = None, *, apply: bool = True,
                 noise_kind: str = NOISE_KIND, mesh=None, x_spec=None,
                 w_spec=None, local: bool = False) -> torch.Tensor:
    """The model-zoo execution path (cim_linear core), registry-routed.

    Fake-quant STE for exact (and for surrogate on the CPU), the fused
    kernels for `hardware` and for `surrogate` on the card, the
    activation dtype preserved end to end.  A `key` draws the surrogate
    noise (rademacher by default).  `apply=False` runs the exact int8
    macro (mixed-macro allocation).

    With `mesh` (integer modes and `apply=True`), as `cim_matmul`'s mesh
    path with the activation dtype preserved; `local=True` takes and
    returns this rank's shards (`models.common.cim_linear` under a mesh,
    inference only: no gradient is defined there)."""
    if mesh is not None and not apply:
        if local:
            raise ValueError("the exact macro (apply=False) has no "
                             "shard-local form")
        mesh = None                    # global operands: run unsharded
    if mesh is not None:
        return _mesh_matmul("model", gp, x, w, mesh, x_spec, w_spec,
                            local=local, preserve_dtype=True)
    noisy = _draws_noise(gp, key, apply)
    eps = _noise(noisy, key, x, w.shape[-1], noise_kind)
    return _forward_for("model", gp, apply, noisy, x, w)(x, w, eps)


# ---------------------------------------------------------------------------
# The models layer's float and surrogate modes on shards.  The dispatch
# engine's mesh plans take the integer modes only (`_check_mesh_mode`, as
# the reference's shard_map path does); `models.common.cim_linear` runs
# the other modes on a rank's shards: `surrogate` through
# `surrogate_shard_matmul`, the float forms (mode "exact", the exact
# macro, `surrogate_fast`) through `models.common._float_tp`, whose
# layout `mesh_float_plan` plans.  Both plan, cache and announce like
# `_mesh_matmul`: the global m * k * n to the sink (the reference's GSPMD
# frontend sees the global shapes), a plan miss to `_plan_miss`.
# ---------------------------------------------------------------------------


def _mesh_local_layout(kind: str, gp: GemmParams, x: torch.Tensor,
                       w: torch.Tensor, mesh, x_spec, w_spec, *extra):
    """(dp, wk, wn, (m, k, n) global, plan-cache key) of one shard-local
    matmul of the models layer; validates the layout and divisibility
    (every call: they are not bucket-stable)."""
    dp, wk, wn = _mesh_axes(mesh, x_spec, w_spec)
    m = x.numel() // x.shape[-1]
    m, k, n = (m * axes_size(mesh, dp), x.shape[-1] * axes_size(mesh, wk),
               w.shape[-1] * axes_size(mesh, wn))
    _mesh_gemm_layout(m, k, n, mesh, x_spec, w_spec)
    key = ("mesh", kind, gp, *extra, x.dtype, w.dtype, bucket(m),
           bucket(k), bucket(n), _backend(x, w), mesh.key,
           _canon_spec(x_spec), _canon_spec(w_spec))
    return dp, wk, wn, (m, k, n), key


def mesh_float_plan(gp: GemmParams, x: torch.Tensor, w: torch.Tensor, mesh,
                    x_spec, w_spec, noisy: bool = False):
    """The layout of a fake-quantized float matmul on shards
    (`models.common._float_tp`), from the plan cache: (dp, wk, wn) and
    the global (m, k, n).  The call is announced with its global MACs, as
    one device's `model_matmul` announces it."""
    dp, wk, wn, mkn, key = _mesh_local_layout("float", gp, x, w, mesh,
                                              x_spec, w_spec, noisy)
    m, k, n = mkn
    return (_cached(key, lambda: (dp, wk, wn), "model_gemm", gp,
                    float(m) * k * n), mkn)


def shard_noise(key: "NoiseKey", m: int, n: int, device, mesh, dp,
                wn) -> torch.Tensor:
    """This rank's block of the (m, n) noise of the global product: drawn
    whole from `key` on the rank's device (`NOISE_KIND`, as the models
    layer draws it) and cut to its rows (over `dp`) and columns (over
    `wn`), so the noise is one device's, element for element."""
    eps = surrogate_noise(key, (m, n), device, NOISE_KIND)
    return shard(eps, (spec_entry(dp), spec_entry(wn)), mesh)


def _surrogate_shard_core(gp: GemmParams, mesh, dp, wk, wn):
    """The shard-local (x2 (M_l, K_l), w (K_l, N_l), key, m, k, n) ->
    (M_l, N_l) forward of `surrogate_shard_matmul`."""
    from repro_torch.kernels import cim_gemm

    x_axes = dp + wk

    def forward(x2, w, key, m, k, n):
        sx = scale_from_max(_global_max(x2, mesh, x_axes), gp.bits)
        sw = scale_from_max(_global_colmax(w, mesh, wk), gp.bits)
        eps = (None if key is None else
               shard_noise(key, m, n, x2.device, mesh, dp, wn))
        if not wk:
            # the whole contraction on this rank: the fused kernel itself
            return cim_gemm.cim_gemm_fused(x2, w, sx, sw, eps, gp.mu, gp.c0,
                                           gp.c1, bits=gp.bits)
        need_sq = eps is not None and gp.c1 > 0.0
        if need_sq:
            cim_gemm.check_sq_k(k)          # the sums of every shard
        acc = cim_gemm.cim_gemm_partial(x2, w, sx, sw, need_sq, gp.bits)
        acc = mesh.all_reduce(acc, "sum", wk)
        return cim_gemm.partial_flush(acc, sx, sw, eps, gp.mu, gp.c0, gp.c1,
                                      k)

    return forward


def surrogate_shard_matmul(x: torch.Tensor, w: torch.Tensor, gp: GemmParams,
                           key: Optional[NoiseKey] = None, *, mesh, x_spec,
                           w_spec) -> torch.Tensor:
    """A `surrogate`-mode GEMM on this rank's shards (the models layer's
    route, `models.common.cim_linear` under a mesh; inference only).

    x (..., K_l) and w (K_l, N_l) are this rank's shards under `x_spec`
    and `w_spec` (as `model_matmul(local=True)`), and so is the result,
    in x's dtype.  The scales are one device's: sx the max |x| over the
    rows' and K's shards, sw each column's max over the K shards.  A
    `key` draws the noise of the GLOBAL (M, N) output on the rank's
    device and cuts the rank's block out of it (`shard_noise`).  A rank
    that holds the whole contraction (a column-parallel layer, or a whole
    weight) runs the fused kernel `cim_gemm_fused` on its shard; a
    contraction-sharded one runs `cim_gemm_partial` (the same kernel,
    flush off), the exact int32 sums are added over the K shards and the
    flush runs once with the global K (`cim_gemm.partial_flush`).  Either
    way the result is one device's `cim_gemm_fused` bit for bit, noise
    included; the kernel wrappers run their plain versions on CPU
    tensors.  Per-token scales and faults are refused, as on the mesh
    frontends."""
    if gp.mode != "surrogate":
        raise ValueError(f"surrogate_shard_matmul runs mode 'surrogate', "
                         f"not {gp.mode!r}")
    _check_mesh_gemm_request(gp)
    noisy = _draws_noise(gp, key)
    dp, wk, wn, (m, k, n), ckey = _mesh_local_layout(
        "surrogate", gp, x, w, mesh, x_spec, w_spec, noisy)
    fn = _cached(ckey, lambda: _surrogate_shard_core(gp, mesh, dp, wk, wn),
                 "model_gemm", gp, float(m) * k * n)
    x2 = x.reshape(-1, x.shape[-1])
    out = fn(x2, w, key if noisy else None, m, k, n).to(x.dtype)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def approx_matmul(x: torch.Tensor, w: torch.Tensor, spec: MultiplierSpec,
                  surrogate: SurrogateModel, mode: str = "surrogate",
                  key: Optional[NoiseKey] = None) -> torch.Tensor:
    """Approximate x @ w with straight-through exact gradients: the
    back-compat wrapper over `cim_matmul` that the Table IV benchmark
    calls."""
    return cim_matmul(x, w, GemmParams.from_spec(spec, surrogate, mode), key)


# ---------------------------------------------------------------------------
# Conv universe: implicit-GEMM convolution
# ---------------------------------------------------------------------------

# The materialized im2col + GEMM path is registered at priority 0 as the
# always-eligible fallback; the implicit kernels outrank it when the
# request, the geometry's bit safety and the shared-memory model admit
# them (`plan_conv`).  Each kernel has a CUDA entry and its plain version
# for "cpu", with the reference's priorities.
register_kernel(KernelEntry(
    name="conv_im2col", op="conv", modes=MODES, families=(), backends=(),
    description="materialized-patch fallback: im2col + the GEMM engine "
                "(every mode)"))
for _dev, _cuda in (("cuda", True), ("cpu", False)):
    _pre = "cuda" if _cuda else "torch"
    _what = "CUDA implicit-GEMM conv" if _cuda else "plain version of the " \
        "implicit-GEMM conv kernel"
    register_kernel(KernelEntry(
        name=f"{_pre}_conv_mxu", op="conv", modes=("exact",), families=(),
        backends=(_dev,), priority=10, max_bits=8, cuda=_cuda,
        description=f"{_what}, exact integer products (the reference's "
                    "pallas_conv_mxu)"))
    register_kernel(KernelEntry(
        name=f"{_pre}_conv_lut", op="conv", modes=("hardware",),
        families=("exact", "appro42"), backends=(_dev,), priority=10,
        max_bits=8, cuda=_cuda, description=f"{_what}, full-LUT gather"))
    register_kernel(KernelEntry(
        name=f"{_pre}_conv_nibble", op="conv", modes=("hardware",),
        families=("exact", "appro42"), backends=(_dev,), priority=20,
        max_bits=8, cuda=_cuda, predicate=nibble_decomposable,
        description=f"{_what}, nibble sub-LUT gather"))
    register_kernel(KernelEntry(
        name=f"{_pre}_conv_log", op="conv", modes=("hardware",),
        families=("mitchell", "log_our"), backends=(_dev,), priority=10,
        max_bits=16, cuda=_cuda, description=f"{_what}, log-domain product"))

# implicit conv entry -> its core in kernels/conv_gemm.py
_CONV_CORES = {f"{pre}_conv_{core}": core for pre in ("cuda", "torch")
               for core in ("lut", "nibble", "log", "mxu")}


@dataclasses.dataclass(frozen=True)
class ConvParams:
    """Static conv geometry: kernel taps + stride, kh//2 zero padding
    (SAME for stride 1).  Odd kernels only: an even kernel under
    symmetric kh//2 padding would silently compute another conv."""

    kh: int = 3
    kw: int = 3
    stride: int = 1

    def __post_init__(self):
        if self.kh % 2 != 1 or self.kw % 2 != 1:
            raise ValueError(
                f"even conv kernels ({self.kh}x{self.kw}) need asymmetric "
                "padding, which the symmetric kh//2 scheme cannot express")
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")


def conv_out_hw(h: int, w: int, kh: int, kw: int,
                stride: int = 1) -> Tuple[int, int]:
    """Output plane of a (kh, kw, stride) conv under kh//2 zero padding
    (SAME for stride 1); the kernels size their launches with it too."""
    return ((h + 2 * (kh // 2) - kh) // stride + 1,
            (w + 2 * (kw // 2) - kw) // stride + 1)


def im2col_nhwc(x: torch.Tensor, conv: ConvParams) -> torch.Tensor:
    """(B,H,W,C) -> (B,OH,OW,kh*kw*C) materialized patch matrix (tap-major
    columns, then channel): the oracle the implicit-GEMM kernels replace,
    and the `conv_im2col` fallback."""
    kh, kw, s = conv.kh, conv.kw, conv.stride
    oh, ow = conv_out_hw(x.shape[1], x.shape[2], kh, kw, s)
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    cols = [xp[:, i:i + (oh - 1) * s + 1:s, j:j + (ow - 1) * s + 1:s]
            for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1)


def _conv_kernel_fits(entry_name: str, bits: int) -> bool:
    """Does one block of the CUDA conv kernel the entry launches at `bits`
    fit a Hopper SM's shared memory?

    Re-derived from the reference's TPU VMEM model, which held a whole
    padded input plane (8 MiB budget), for csrc/conv_gemm.cu's layouts,
    none of which holds a plane, so the image size does not enter and
    the answer depends on the core and the operand width alone.  The LUT
    and log kernel up to 8 bits (csrc/conv_tile.cuh, fused and partial
    alike) holds the table, TILE_HALO_WORDS words of staged input halo
    and a weight region of the form's size, whatever the geometry: it
    takes the channels in chunks and the taps in groups; the log core's
    9..16 bits run the template, which holds one staged A and B tile
    (kernels/conv_gemm.gemm_smem_bytes, which reads template_smem_bytes
    for them alone).  The exact core (the int8 tensor-core kernel) holds
    an int8 input halo, an int8 weight tile and its k-word offsets,
    54,848 bytes, whatever the geometry; one output pixel's halo must
    still fit, so it takes at most conv_gemm.MXU_MAX_TAPS (4,096) taps;
    `plan_conv` sends a larger kernel to `conv_im2col`.  No width the
    conv entries accept fails it (the largest block, the 8-bit full
    table's tile kernel, is 217,104 bytes): it holds the registry to the
    kernels' layouts should an entry widen, and each launch checks the
    same total again.  The plain versions are held to the same gate, so
    a geometry routes alike on both devices."""
    from repro_torch.kernels.build import SMEM_BYTES
    from repro_torch.kernels.conv_gemm import gemm_smem_bytes

    return gemm_smem_bytes(_CONV_CORES[entry_name], bits) <= SMEM_BYTES


def _conv_bit_exact_safe(h: int, w: int, conv: ConvParams) -> bool:
    """True iff the implicit kernels are bit-identical to the im2col
    oracle at this geometry.  The implicit path quantizes with
    quant_scale(x), the oracle with quant_scale(im2col(x)); the
    max-based scales agree iff every input pixel reaches >= 1 patch:
    stride <= min(kh, kw) keeps tap coverage contiguous, and the
    sampling residue (Hp - kh) % stride must not exceed the padding —
    otherwise trailing real rows/cols are never sampled.  Computed on
    the *actual* dims (bucketing would mask the residue)."""
    s = conv.stride
    if s > min(conv.kh, conv.kw):
        return False
    return ((h + 2 * (conv.kh // 2) - conv.kh) % s <= conv.kh // 2
            and (w + 2 * (conv.kw // 2) - conv.kw) % s <= conv.kw // 2)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """A routed conv: entry, geometry, backend."""

    entry: KernelEntry
    conv: ConvParams
    backend: str


@functools.lru_cache(maxsize=1024)
def _entries_cached(op: str, family: str, mode: str, bits: int, backend: str,
                    spec: Optional[MultiplierSpec]) -> Tuple[KernelEntry, ...]:
    """Every entry of universe `op` ("conv" or "attn") supporting the
    request, highest priority first (the planners walk it)."""
    matches = [e for e in _REGISTRY.values()
               if e.op == op and e.supports(family, mode, bits, backend)
               and (e.predicate is None
                    or (spec is not None and e.predicate(spec)))]
    if not matches:
        raise ValueError(
            f"no {op} kernel for family={family!r} mode={mode!r} "
            f"bits={bits} backend={backend!r}; registered: "
            f"{sorted(e.name for e in _REGISTRY.values() if e.op == op)}")
    return tuple(sorted(matches, key=lambda e: -e.priority))


def _check_request(family: str, mode: str, backend: str,
                   modes: Tuple[str, ...] = MODES) -> None:
    if mode not in modes:
        raise ValueError(f"mode {mode!r} not in {modes}")
    if family not in FAMILIES:
        raise ValueError(f"family {family!r} not in {FAMILIES}")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")


def select_conv_kernel(family: str, mode: str, bits: int = 8,
                       backend: str = "cuda",
                       spec: Optional[MultiplierSpec] = None) -> KernelEntry:
    """Highest-priority conv entry for the request (no footprint or
    bit-safety gate: `plan_conv` applies those against the geometry)."""
    _check_request(family, mode, backend)
    return _entries_cached("conv", family, mode, bits, backend, spec)[0]


@functools.lru_cache(maxsize=1024)
def _plan_conv_cached(family: str, mode: str, bits: int, bb: int, hb: int,
                      wb: int, cb: int, nb: int, conv: ConvParams,
                      bit_safe: bool, backend: str,
                      spec: Optional[MultiplierSpec]) -> ConvPlan:
    from repro_torch.kernels.conv_gemm import MXU_MAX_TAPS

    for entry in _entries_cached("conv", family, mode, bits, backend, spec):
        if entry.name in _CONV_CORES:
            # the im2col path IS the oracle of the integer cores; the
            # exact-mode core is bounded by f32 rounding, as the
            # reference's, so it runs on any geometry
            if not bit_safe and _CONV_CORES[entry.name] != "mxu":
                continue
            if not _conv_kernel_fits(entry.name, bits):
                continue           # tile too large: try lower priority
            if (_CONV_CORES[entry.name] == "mxu"
                    and conv.kh * conv.kw > MXU_MAX_TAPS):
                continue           # one pixel's halo does not fit
        return ConvPlan(entry=entry, conv=conv, backend=backend)
    raise ValueError(                  # conv_im2col always matches
        f"no eligible conv kernel for family={family!r} mode={mode!r}")


def plan_conv(family: str, mode: str, bits: int, b: int, h: int, w: int,
              c: int, n: int, conv: ConvParams, backend: str = "cuda",
              spec: Optional[MultiplierSpec] = None, mesh=None, x_spec=None,
              w_spec=None) -> Union[ConvPlan, MeshPlan]:
    """Route one conv to an entry.

    Memoized on the conv-bucketed shape (autotune.bucket_conv: powers of
    two on the data dims, taps and stride exact) plus the geometry's
    exact bit-safety flag (`_conv_bit_exact_safe`, which bucketing would
    mask).  The bit-exact implicit kernels are skipped when the flag is
    False (the materialized fallback is the oracle; the exact-mode
    kernel, bounded by f32 rounding as in the reference, is not), and
    every implicit kernel when its block does not fit shared memory
    (`_conv_kernel_fits`), the exact-mode kernel also beyond
    conv_gemm.MXU_MAX_TAPS taps; `conv_im2col` always matches.

    With `mesh`, `x_spec` shards the batch dim of (B, H, W, C) (its other
    entries must be None) and `w_spec` is a (K, N)-style pair over the
    (kh*kw*C, N) weight: ("model", None) shards the input channels (the
    contraction: partial kernels and an int32 sum), (None, "model") the
    output channels (fused kernels, no sum).  Returns a `MeshPlan` over
    the shard-local geometry; only the integer modes and bit-safe
    geometries qualify (elsewhere the oracle's scale needs the whole
    materialized patch matrix, which no shard holds)."""
    _check_request(family, mode, backend)
    if mesh is not None:
        _check_mesh_conv(mode, h, w, conv, b, c, n, mesh, x_spec, w_spec)
        dp, wk, wn = _mesh_axes(mesh, (_one_spec(x_spec),), w_spec)
        return _plan_conv_mesh_cached(family, mode, bits, b, h, w, c, n,
                                      conv, backend, spec, mesh, dp, wk, wn)
    bb, hb, wb, cb, _, _, _ = bucket_conv(b, h, w, c, conv.kh, conv.kw,
                                          conv.stride)
    return _plan_conv_cached(family, mode, bits, bb, hb, wb, cb, bucket(n),
                             conv, _conv_bit_exact_safe(h, w, conv), backend,
                             spec)


def _one_spec(x_spec):
    """The batch entry of a conv x_spec; its other entries must be None
    (tiling H or W would need a halo exchange)."""
    if x_spec is None:
        return None
    xs = tuple(x_spec)
    if any(e is not None for e in xs[1:]):
        raise ValueError(
            f"mesh conv shards batch (and C via w_spec) only; got {xs}")
    return xs[0] if xs else None


def _check_mesh_conv(mode: str, h: int, w: int, conv: ConvParams, b: int,
                     c: int, n: int, mesh, x_spec, w_spec) -> None:
    """Exact-geometry validation of one mesh conv request (mode,
    bit-safety, which bucketing would mask, layout, divisibility), run
    on every call."""
    _check_mesh_mode(mode)
    if not _conv_bit_exact_safe(h, w, conv):
        raise ValueError(
            f"mesh conv: geometry (h={h}, w={w}, {conv.kh}x{conv.kw} "
            f"s{conv.stride}) is not bit-safe: the oracle's scale needs "
            "the whole materialized patch matrix; run unsharded")
    _mesh_gemm_layout(b, c, n, mesh, (_one_spec(x_spec),), w_spec)


@functools.lru_cache(maxsize=512)
def _plan_conv_mesh_cached(family: str, mode: str, bits: int, b: int,
                           h: int, w: int, c: int, n: int, conv: ConvParams,
                           backend: str, spec: Optional[MultiplierSpec],
                           mesh, dp: Tuple[str, ...], wk: Tuple[str, ...],
                           wn: Tuple[str, ...]) -> MeshPlan:
    bl = b // axes_size(mesh, dp)
    cl = c // axes_size(mesh, wk)
    nl = n // axes_size(mesh, wn)
    bb, hb, wb, cb, _, _, _ = bucket_conv(bl, h, w, cl, conv.kh, conv.kw,
                                          conv.stride)
    inner = _plan_conv_cached(family, mode, bits, bb, hb, wb, cb, bucket(nl),
                              conv, True, backend, spec)
    return MeshPlan(plan=inner, mesh=mesh, dp=dp, wk=wk, wn=wn,
                    local_shape=(bl, h, w, cl, nl))


def _fault_conv_plan(conv: ConvParams, backend: str) -> ConvPlan:
    """The plan of a faulted conv: `conv_im2col`, always registered and
    eligible, whose inner GEMM routes through the faultable int paths
    (`GemmParams.routing_spec`)."""
    return ConvPlan(entry=_REGISTRY["conv_im2col"], conv=conv,
                    backend=backend)


def _run_conv_mxu(x4, w2, gp: GemmParams, plan: ConvPlan):
    from repro_torch.kernels import ops

    return ops.conv2d_mxu_fused(x4, w2, bits=gp.bits, kh=plan.conv.kh,
                                kw=plan.conv.kw, stride=plan.conv.stride)


def _run_conv_lut(x4, w2, gp: GemmParams, plan: ConvPlan):
    from repro_torch.kernels import ops

    return ops.conv2d_lut_fused(x4, w2, gp.spec, kh=plan.conv.kh,
                                kw=plan.conv.kw, stride=plan.conv.stride)


def _run_conv_nibble(x4, w2, gp: GemmParams, plan: ConvPlan):
    from repro_torch.kernels import ops

    return ops.conv2d_nibble_fused(x4, w2, gp.spec, kh=plan.conv.kh,
                                   kw=plan.conv.kw, stride=plan.conv.stride)


def _run_conv_log(x4, w2, gp: GemmParams, plan: ConvPlan):
    from repro_torch.kernels import ops

    return ops.conv2d_log_fused(x4, w2, bits=gp.bits,
                                compensated=(gp.family == "log_our"),
                                kh=plan.conv.kh, kw=plan.conv.kw,
                                stride=plan.conv.stride)


# entry name -> f32 (B,H,W,C) x f32 (kh*kw*C,N) -> f32 (B,OH,OW,N); the
# patch gather, quantization and the epilogue all run inside one kernel
CONV_RUNNERS: Dict[str, Callable] = {
    f"{pre}_conv_{core}": run for pre in ("cuda", "torch")
    for core, run in (("lut", _run_conv_lut), ("nibble", _run_conv_nibble),
                      ("log", _run_conv_log), ("mxu", _run_conv_mxu))}


# the mesh path's conv runners: f32 x (B, H, W, C_shard), the tap stack
# w3 (kh*kw, C_shard, N_shard) and the GLOBAL scales in; the partial
# runners return the raw int32 (B, OH, OW, N_shard) sum over the shard's
# channels, the scaled runners (the output-sharded layout) f32


def _conv_kw(plan: ConvPlan) -> Dict:
    return dict(kh=plan.conv.kh, kw=plan.conv.kw, stride=plan.conv.stride)


def _partial_conv_lut(x, w3, sx, sw, gp: GemmParams, plan: ConvPlan):
    from repro_torch.kernels import ops

    return ops.conv2d_lut_partial(x, w3, gp.spec, sx, sw, nibble=False,
                                  **_conv_kw(plan))


def _partial_conv_nibble(x, w3, sx, sw, gp: GemmParams, plan: ConvPlan):
    from repro_torch.kernels import ops

    return ops.conv2d_lut_partial(x, w3, gp.spec, sx, sw, nibble=True,
                                  **_conv_kw(plan))


def _partial_conv_log(x, w3, sx, sw, gp: GemmParams, plan: ConvPlan):
    from repro_torch.kernels import ops

    return ops.conv2d_log_partial(x, w3, sx, sw, bits=gp.bits,
                                  compensated=(gp.family == "log_our"),
                                  **_conv_kw(plan))


def _scaled_conv_lut(x, w3, sx, sw, gp: GemmParams, plan: ConvPlan):
    from repro_torch.kernels import ops

    return ops.conv2d_lut_fused_scaled(x, w3, gp.spec, sx, sw, nibble=False,
                                       **_conv_kw(plan))


def _scaled_conv_nibble(x, w3, sx, sw, gp: GemmParams, plan: ConvPlan):
    from repro_torch.kernels import ops

    return ops.conv2d_lut_fused_scaled(x, w3, gp.spec, sx, sw, nibble=True,
                                       **_conv_kw(plan))


def _scaled_conv_log(x, w3, sx, sw, gp: GemmParams, plan: ConvPlan):
    from repro_torch.kernels import ops

    return ops.conv2d_log_fused_scaled(x, w3, sx, sw, bits=gp.bits,
                                       compensated=(gp.family == "log_our"),
                                       **_conv_kw(plan))


CONV_PARTIAL_RUNNERS: Dict[str, Callable] = {
    f"{pre}_conv_{core}": run for pre in ("cuda", "torch")
    for core, run in (("lut", _partial_conv_lut),
                      ("nibble", _partial_conv_nibble),
                      ("log", _partial_conv_log))}
SCALED_CONV_RUNNERS: Dict[str, Callable] = {
    f"{pre}_conv_{core}": run for pre in ("cuda", "torch")
    for core, run in (("lut", _scaled_conv_lut),
                      ("nibble", _scaled_conv_nibble),
                      ("log", _scaled_conv_log))}


def _mesh_conv_core(gp: GemmParams, mp: MeshPlan) -> Callable:
    """The shard-local (x_l (B_l, H, W, C_l), w3_l (kh*kw, C_l, N_l)) ->
    f32 (B_l, OH, OW, N_l) forward of a mesh conv, as `_mesh_core`.  A
    plan without an implicit kernel (`conv_im2col`: bit_exact mode)
    materializes the shard's own patch matrix and runs the routed integer
    GEMM on it: its columns are the shard's channels in the tap-major
    order of the shard's tap stack, and the int32 sum over the shards
    does not depend on the order of K."""
    plan, conv, mesh = mp.plan, mp.plan.conv, mp.mesh
    red = mp.reduce_axes
    fused = None if red else SCALED_CONV_RUNNERS.get(plan.entry.name)
    partial = CONV_PARTIAL_RUNNERS.get(plan.entry.name)
    if fused is None and partial is None:
        bl, h, w_, cl, nl = mp.local_shape
        oh, ow = conv_out_hw(bucket(h), bucket(w_), conv.kh, conv.kw,
                             conv.stride)
        gplan = plan_gemm(gp.family, gp.mode, gp.bits, bucket(bl) * oh * ow,
                          conv.kh * conv.kw * bucket(cl), bucket(nl),
                          plan.backend, spec=gp.routing_spec)

        def partial(x, w3, sx, sw, gp_, _plan):
            cols = im2col_nhwc(x, conv)
            xq = quantize(cols.reshape(-1, cols.shape[-1]), sx, gp_.bits)
            wq = quantize(w3.reshape(-1, w3.shape[-1]), sw.reshape(1, -1),
                          gp_.bits)
            acc = run_int_kernel(gplan, xq, wq, gp_)
            return acc.reshape(cols.shape[:3] + (w3.shape[-1],))

    def forward(x_l, w3_l):
        x32, w32 = x_l.to(torch.float32), w3_l.to(torch.float32)
        sx = scale_from_max(_global_max(x32, mesh, mp.x_axes), gp.bits)
        sw = scale_from_max(_global_colmax(w32, mesh, red, dims=(0, 1)),
                            gp.bits)
        if fused is not None:
            return fused(x32, w32, sx, sw, gp, plan)
        acc = mesh.all_reduce(partial(x32, w32, sx, sw, gp, plan), "sum",
                              red)
        return (acc.to(torch.float32) * sx) * sw

    return forward


def _conv_macs(b: int, h: int, w: int, c: int, n: int,
               conv: ConvParams) -> float:
    oh, ow = conv_out_hw(h, w, conv.kh, conv.kw, conv.stride)
    return float(b) * oh * ow * conv.kh * conv.kw * c * n


def _mesh_conv2d(gp: GemmParams, x: torch.Tensor, w: torch.Tensor,
                 conv: ConvParams, mesh, x_spec, w_spec) -> torch.Tensor:
    """One mesh conv over the global x (B, H, W, C) and w (kh*kw*C, N),
    the same on every rank: each rank cuts its shards (batch on the row
    axes, C on the contraction axes, the tap stack's C and N), runs the
    shard-local forward, and gets the whole (B, OH, OW, N) result."""
    _check_mesh_gemm_request(gp)
    b, h, w_, c = x.shape
    n = w.shape[-1]
    _check_mesh_conv(gp.mode, h, w_, conv, b, c, n, mesh, x_spec, w_spec)
    dp, wk, wn = _mesh_axes(mesh, (_one_spec(x_spec),), w_spec)
    backend = _backend(x, w)
    key = (("mesh-conv2d", gp, conv, x.dtype, w.dtype, backend, mesh.key,
            _canon_spec(x_spec), _canon_spec(w_spec))
           + bucket_conv(b, h, w_, c, conv.kh, conv.kw, conv.stride)
           + (bucket(n),))
    fn = _cached(key, lambda: _mesh_conv_core(gp, plan_conv(
        gp.family, gp.mode, gp.bits, b, h, w_, c, n, conv, backend=backend,
        spec=gp.spec, mesh=mesh, x_spec=x_spec, w_spec=w_spec)), "conv", gp,
        _conv_macs(b, h, w_, c, n, conv))

    def forward(x4, w2, eps=None):
        x_l = shard(x4, (spec_entry(dp), None, None, spec_entry(wk)), mesh)
        w3 = w2.reshape(conv.kh * conv.kw, c, n)
        w3_l = shard(w3, (None, spec_entry(wk), spec_entry(wn)), mesh)
        out = fn(x_l, w3_l)
        return mesh.all_gather(mesh.all_gather(out, wn, 3), dp, 0)

    return _STEConv.apply(x, w, None, forward, conv)


def _float_conv(x4: torch.Tensor, w2: torch.Tensor,
                conv: ConvParams) -> torch.Tensor:
    """Exact float conv (the STE gradient reference): x4 (B,H,W,C), w2
    (kh*kw*C, N) tap-major -> (B,OH,OW,N)."""
    c = x4.shape[-1]
    wk = w2.reshape(conv.kh, conv.kw, c, -1).permute(3, 2, 0, 1)
    y = F.conv2d(x4.permute(0, 3, 1, 2), wk, stride=conv.stride,
                 padding=(conv.kh // 2, conv.kw // 2))
    return y.permute(0, 2, 3, 1)


@contextlib.contextmanager
def _full_f32_convs():
    """cuDNN's f32 convolutions in full f32 (PyTorch allows TF32 there by
    default, about three decimal digits): the STE gradient is the exact
    float conv's, as the reference's."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _STEConv(torch.autograd.Function):
    """A (x4, w2, eps) -> out4 conv forward with the exact float conv's
    VJP (the conv analogue of g @ w.T / x.T @ g in `_STEMatmul`); the
    pre-drawn surrogate noise eps (None without noise) rides through
    with a zero cotangent."""

    @staticmethod
    def forward(ctx, x4, w2, eps, forward, conv):
        ctx.save_for_backward(x4, w2)
        ctx.conv = conv
        ctx.eps_shape = None if eps is None else (eps.shape, eps.dtype)
        return forward(x4, w2, eps)

    @staticmethod
    def backward(ctx, g):
        x4, w2 = ctx.saved_tensors
        with torch.enable_grad(), _full_f32_convs():
            xs = [t.detach().to(torch.float32).requires_grad_(True)
                  for t in (x4, w2)]
            out = _float_conv(*xs, ctx.conv)
            gx, gw = torch.autograd.grad(out, xs, g.to(torch.float32))
        geps = None
        if ctx.needs_input_grad[2]:
            shape, dtype = ctx.eps_shape
            geps = torch.zeros(shape, dtype=dtype, device=g.device)
        return gx.to(x4.dtype), gw.to(w2.dtype), geps, None, None


def _conv_forward(gp: GemmParams, plan: ConvPlan,
                  shape: Tuple[int, int, int, int, int]) -> Callable:
    """The (x4, w2, eps=None) -> f32 out4 forward of a routed conv: an
    implicit-GEMM kernel, or the `conv_im2col` fallback, which
    materializes the patches and reuses the GEMM engine's macro forward
    (every mode; eps is its (B*OH*OW, N) surrogate noise).  Its inner
    GEMM plan is resolved once, from the conv-bucketed dims."""
    conv = plan.conv
    if plan.entry.name in CONV_RUNNERS:
        runner = CONV_RUNNERS[plan.entry.name]

        def forward(x4, w2, eps=None):
            return runner(x4.to(torch.float32), w2.to(torch.float32), gp,
                          plan)
        return forward

    b, h, w_, c, n = shape
    oh, ow = conv_out_hw(bucket(h), bucket(w_), conv.kh, conv.kw,
                         conv.stride)
    gplan = plan_gemm(gp.family, gp.mode, gp.bits, bucket(b) * oh * ow,
                      conv.kh * conv.kw * bucket(c), bucket(n), plan.backend,
                      spec=gp.routing_spec)
    inner = _cim_core(gp, gplan)

    def forward(x4, w2, eps=None):
        cols = im2col_nhwc(x4.to(torch.float32), conv)
        out2 = inner(cols.reshape(-1, cols.shape[-1]), w2.to(torch.float32),
                     eps)
        return out2.reshape(cols.shape[:3] + (w2.shape[-1],))
    return forward


def cim_conv2d(x: torch.Tensor, w: torch.Tensor, gp: GemmParams,
               key: Optional[NoiseKey] = None, *, kh: int = 3, kw: int = 3,
               stride: int = 1, noise_kind: str = "normal", mesh=None,
               x_spec=None, w_spec=None) -> torch.Tensor:
    """Dispatch + execute one approximate convolution (macro semantics).

    x: (B, H, W, C) float; w: (kh*kw*C, N) float with tap-major rows (the
    `im2col_nhwc` column order), on one device.  Returns float32
    (B, OH, OW, N) with the exact float conv's straight-through gradients.

    Hardware and exact mode run the implicit-GEMM kernels
    (kernels/conv_gemm.py): the patch gather happens inside the kernel by
    index arithmetic, so the (M, kh*kw*C) im2col tensor never exists.  A
    hardware result is bit-identical to `im2col + cim_matmul` wherever
    the geometry is bit-safe (`_conv_bit_exact_safe`), and `plan_conv`
    enforces it: other geometries and the bit_exact and surrogate modes
    run `conv_im2col`; the exact-mode kernel differs from `im2col +
    cim_matmul` by f32 rounding only and runs on any geometry of at most
    conv_gemm.MXU_MAX_TAPS taps (larger ones run `conv_im2col`).  In a
    surrogate mode a `key` draws the (B*OH*OW, N) noise of the
    materialized GEMM (`noise_kind`, normal by default).  Plans are
    cached on the conv-bucketed shape, the bit-safety flag and whether
    noise is drawn (a miss counts in `plan_misses()`).  A faulted conv
    (a `GemmParams` with a fault config) runs `conv_im2col`
    (`_fault_conv_plan`): the implicit kernels quantize on load, where
    the stored-word faults cannot reach, and the materialized GEMM
    takes the faulted int route.

    With `mesh` (`x_spec` over the batch, `w_spec` over the (kh*kw*C, N)
    weight, see `plan_conv`) every rank passes the same global x and w
    and gets the whole result, bit-identical to the call without a mesh
    for the integer modes on bit-safe geometries."""
    conv = ConvParams(kh, kw, stride)
    if x.dim() != 4 or w.dim() != 2:
        raise ValueError(f"cim_conv2d wants x (B,H,W,C), w (K,N); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    b, h, w_, c = x.shape
    n = w.shape[-1]
    if w.shape[0] != kh * kw * c:
        raise ValueError(
            f"weight rows {w.shape[0]} != kh*kw*C = {kh}*{kw}*{c}")
    if gp.mode not in MODES:
        raise ValueError(f"mode {gp.mode!r} not in {MODES}")
    if mesh is not None:
        return _mesh_conv2d(gp, x, w, conv, mesh, x_spec, w_spec)
    backend = _backend(x, w)
    bit_safe = _conv_bit_exact_safe(h, w_, conv)
    noisy = _draws_noise(gp, key)
    fkey = (("conv2d", gp, conv, bit_safe, noisy, x.dtype, w.dtype, backend)
            + bucket_conv(b, h, w_, c, kh, kw, stride) + (bucket(n),))

    def build():
        if gp.fault is not None:
            plan = _fault_conv_plan(conv, backend)
        else:
            plan = plan_conv(gp.family, gp.mode, gp.bits, b, h, w_, c, n,
                             conv, backend=backend, spec=gp.spec)
        forward = _conv_forward(gp, plan, (b, h, w_, c, n))
        return lambda x4, w2, eps: _STEConv.apply(x4, w2, eps, forward, conv)

    fn = _cached(fkey, build, "conv", gp, _conv_macs(b, h, w_, c, n, conv))
    eps = None
    if noisy:
        oh, ow = conv_out_hw(h, w_, kh, kw, stride)
        eps = surrogate_noise(key, (b * oh * ow, n), x.device, noise_kind)
    return fn(x, w, eps)


# ---------------------------------------------------------------------------
# Attention planning universe (flash-style CiM attention)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnParams:
    """Static attention geometry: the masking contract.

    ``causal`` gates ``kpos <= qpos``; ``window`` additionally gates
    ``kpos > qpos - window``.  Ragged validity rides in the runtime
    ``kv_valid`` operand, not here: it changes per call, never the plan."""

    causal: bool = True
    window: Optional[int] = None

    def __post_init__(self):
        if self.window is not None and self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")


# entry name -> inner-dot datapath of kernels/attn_gemm.py.  torch_attn
# resolves per request (_attn_path): it mirrors whichever datapath the
# request's mode/family would run.
_ATTN_PATHS = {f"{pre}_attn_{path}": path
               for pre in ("cuda", "torch")
               for path in ("mxu", "lut", "nibble", "log")}


def _attn_path(entry_name: str, family: str, mode: str) -> str:
    path = _ATTN_PATHS.get(entry_name)
    if path is not None:
        return path
    if mode == "exact":
        return "mxu"
    if family in ("mitchell", "log_our"):
        return "log"
    return "lut"


def _attn_ref_name(entry_name: str) -> str:
    """The reference's kernel name for an entry (its block defaults)."""
    path = _ATTN_PATHS.get(entry_name)
    return f"pallas_attn_{path}" if path is not None else "attn_xla"


def _attn_kernel_fits(entry_name: str, bits: int, block: Tuple[int, int],
                      head_dim: int) -> bool:
    """Does one block of the CUDA kernel fit a Hopper SM's shared memory?

    Re-derived from the reference's TPU VMEM model for the layout of
    csrc/attn_gemm.cu: the path's table, the f32 accumulator and score
    tile, the int16 probability tile and the quantized q/k/v tiles, at
    the kernel's largest query block (attn_gemm.ATTN_BQ rows) and the
    plan's bk.  The head dim is not lane-padded here.  The plain
    versions are held to the same gate, so a geometry routes alike on
    both devices."""
    from repro_torch.kernels.attn_gemm import (ATTN_BQ, SMEM_BYTES,
                                               attn_smem_bytes)

    path = _ATTN_PATHS[entry_name]
    return attn_smem_bytes(path, bits, ATTN_BQ, block[1],
                           head_dim) <= SMEM_BYTES


def _attn_bit_safe(bits: int, path: str, head_dim: int, bk: int) -> bool:
    """True iff every inner-dot partial sum is exactly representable.

    Kept exactly as the reference (lane-padded head dim included) so
    that routing matches it: QK^T contracts the head dim, PV the kv tile,
    so the worst accumulator magnitude is qmax^2 * max(dp, bk); the mxu
    path is exact below 2^24 (the reference sums in f32), the integer
    paths below 2^31."""
    qm = (1 << (bits - 1)) - 1
    dp = max(128, -(-head_dim // 128) * 128)
    worst = qm * qm * max(dp, bk)
    return worst < ((1 << 24) if path == "mxu" else (1 << 31))


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    """A routed attention: entry, masking, (bq, bk) block, backend.  Only
    bk reaches the numerics; the CUDA kernels pick their own bq."""

    entry: KernelEntry
    attn: AttnParams
    block: Tuple[int, int]
    backend: str


def select_attn_kernel(family: str, mode: str, bits: int = 8,
                       backend: str = "cuda",
                       spec: Optional[MultiplierSpec] = None) -> KernelEntry:
    """Highest-priority attention entry for the request (no footprint or
    bit-safety gate: `plan_attn` applies those against the geometry)."""
    _check_request(family, mode, backend, ATTN_MODES)
    return _entries_cached("attn", family, mode, bits, backend, spec)[0]


@functools.lru_cache(maxsize=1024)
def _plan_attn_cached(family: str, mode: str, bits: int, bb: int,
                      heads: int, kv_heads: int, sqb: int, skvb: int,
                      head_dim: int, attn: AttnParams, backend: str,
                      block: Optional[Tuple[int, int]],
                      spec: Optional[MultiplierSpec]) -> AttnPlan:
    for entry in _entries_cached("attn", family, mode, bits, backend, spec):
        path = _attn_path(entry.name, family, mode)
        blk = block
        if blk is None:
            blk = heuristic_attn_block(_attn_ref_name(entry.name), sqb, skvb)
        if entry.name in _ATTN_PATHS and not _attn_kernel_fits(
                entry.name, bits, blk, head_dim):
            continue                   # tile too large: try lower priority
        if not _attn_bit_safe(bits, path, head_dim, blk[1]):
            continue                   # accumulator could overflow
        return AttnPlan(entry=entry, attn=attn, block=tuple(blk),
                        backend=backend)
    raise ValueError(
        f"no eligible attention kernel for family={family!r} "
        f"mode={mode!r} bits={bits} head_dim={head_dim} (bit-safety / "
        "shared-memory predicates rejected every entry)")


def plan_attn(family: str, mode: str, bits: int, b: int, heads: int,
              kv_heads: int, sq: int, skv: int, head_dim: int,
              attn: AttnParams = AttnParams(), backend: str = "cuda",
              block: Optional[Tuple[int, int]] = None,
              spec: Optional[MultiplierSpec] = None) -> AttnPlan:
    """Route one attention call to an entry and a (bq, bk) block.

    Memoized on the attention-bucketed shape (autotune.bucket_attn).
    Entries are gated by the shared-memory model (`_attn_kernel_fits`)
    and the accumulator bit-safety predicate (`_attn_bit_safe`); a
    request no entry accepts raises ValueError, and the models layer
    falls back to the float `_chunked_attn` path."""
    _check_request(family, mode, backend, ATTN_MODES)
    if heads % kv_heads:
        raise ValueError(
            f"GQA needs heads % kv_heads == 0, got {heads} % {kv_heads}")
    bb, hh, kh, sqb, skvb, hd = bucket_attn(b, heads, kv_heads, sq, skv,
                                            head_dim)
    return _plan_attn_cached(family, mode, bits, bb, hh, kh, sqb, skvb, hd,
                             attn, backend,
                             tuple(block) if block is not None else None,
                             spec)


# ---------------------------------------------------------------------------
# Attention runners.  Kernel layout: q (B, H, Sq, D), k/v (B, KH, Skv, D)
# float, qpos (B, Sq) + kpos/kval (B, Skv) int32 -> f32 (B, H, Sq, D);
# tables and scales resolve inside ops.*
# ---------------------------------------------------------------------------


def _attn_run_kwargs(gp: GemmParams, plan: AttnPlan) -> Dict:
    path = _attn_path(plan.entry.name, gp.family, gp.mode)
    kw = dict(path=path, bits=gp.bits, causal=plan.attn.causal,
              window=plan.attn.window,
              compensated=(gp.family == "log_our"), block=plan.block)
    if path in ("lut", "nibble"):
        kw["spec"] = gp.spec
    return kw


def _run_attn_kernel(qh, kh_, vh, qpos, kpos, kval, gp: GemmParams,
                     plan: AttnPlan):
    from repro_torch.kernels import ops

    return ops.cim_attn_fused(qh, kh_, vh, qpos, kpos, kval,
                              **_attn_run_kwargs(gp, plan))


def _run_attn_plain(qh, kh_, vh, qpos, kpos, kval, gp: GemmParams,
                    plan: AttnPlan):
    from repro_torch.kernels import ops

    return ops.cim_attn_reference(qh, kh_, vh, qpos, kpos, kval,
                                  **_attn_run_kwargs(gp, plan))


ATTN_RUNNERS: Dict[str, Callable] = {"torch_attn": _run_attn_plain}
ATTN_RUNNERS.update({name: _run_attn_kernel for name in _ATTN_PATHS})


def attn_materialized_oracle(q, k, v, gp: GemmParams, plan: AttnPlan,
                             qpos, kpos, kval):
    """The bit-exact oracle of a routed attention (kernel layout): the
    same math as the fused kernel with the score tensor materialized in
    device memory."""
    from repro_torch.kernels import ops

    return ops.cim_attn_materialized(q, k, v, qpos, kpos, kval,
                                     **_attn_run_kwargs(gp, plan))


class _STEAttn(torch.autograd.Function):
    """Model-layout (q, k, v) -> out through the routed integer kernel,
    with the exact-float VJP of `attn_float` (straight-through past the
    quantization, as the GEMM frontends)."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, kval, run, causal, window):
        ctx.save_for_backward(q, k, v, qpos, kpos, kval)
        ctx.causal, ctx.window = causal, window
        t = lambda a: a.transpose(1, 2)  # noqa: E731
        return t(run(t(q), t(k), t(v), qpos, kpos, kval))

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.attn_gemm import attn_float

        q, k, v, qpos, kpos, kval = ctx.saved_tensors
        t = lambda a: a.transpose(1, 2)  # noqa: E731
        with torch.enable_grad():
            xs = [a.detach().requires_grad_(True) for a in (q, k, v)]
            out = t(attn_float(*(t(a) for a in xs), qpos, kpos, kval,
                               causal=ctx.causal, window=ctx.window))
            grads = torch.autograd.grad(out, xs, g.to(torch.float32))
        return (*(d.to(a.dtype) for d, a in zip(grads, (q, k, v))),
                None, None, None, None, None, None)


def _attn_forward(gp: GemmParams, plan: AttnPlan) -> Callable:
    runner = ATTN_RUNNERS[plan.entry.name]

    def run(qh, kh_, vh, qpos, kpos, kval):
        return runner(qh, kh_, vh, qpos, kpos, kval, gp, plan)

    def forward(q, k, v, qpos, kpos, kval):
        return _STEAttn.apply(q, k, v, qpos, kpos, kval, run,
                              plan.attn.causal, plan.attn.window)

    return forward


def cim_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  gp: GemmParams, *, causal: bool = True,
                  window: Optional[int] = None,
                  q_positions: Optional[torch.Tensor] = None,
                  kv_positions: Optional[torch.Tensor] = None,
                  kv_valid: Optional[torch.Tensor] = None,
                  block: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Dispatch + execute one approximate attention.

    q: (B, Sq, H, D) float; k/v: (B, Skv, KH, D) with H % KH == 0.
    Returns float32 (B, Sq, H, D) with the straight-through exact-float
    gradients of `attn_float`.  Both inner dots run through the datapath
    `gp` selects, under online-softmax tiling; `causal`/`window` are plan
    geometry, `q_positions` (B, Sq), `kv_positions` + `kv_valid` (B, Skv)
    runtime operands defaulting to dense positions, all valid.

    Integer modes only (`ATTN_MODES`); a geometry every entry rejects
    raises ValueError, which the models layer turns into the float path.
    A planned call that its kernel then refuses is a fault, not a
    fallback, and raises RuntimeError; so does a faulted `gp`
    (NotImplementedError: faulted attention tables are not ported).
    Plans are cached on `bucket_attn` (a miss counts in
    `plan_misses()`)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"cim_attention wants (B, S, H, D) operands; got q.dim="
            f"{q.dim()} k.dim={k.dim()} v.dim={v.dim()}")
    b, sq, heads, hd = q.shape
    skv, kv_heads = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, skv, kv_heads, hd) or v.shape != k.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if heads % kv_heads:
        raise ValueError(
            f"GQA needs H % KH == 0, got {heads} % {kv_heads}")
    if gp.fault is not None:
        # not a ValueError: the models layer turns those into the float
        # path, which would hide the refusal
        raise NotImplementedError(
            "faulted CiM attention is not ported: the attention kernels "
            "hold the clean int16 table (ROADMAP queue A 10); serve a "
            "faulted ladder with attn=False")
    if gp.mode not in ATTN_MODES:
        raise ValueError(
            f"cim_attention runs the integer modes {ATTN_MODES}; "
            f"mode {gp.mode!r} stays on the float attention path")
    if gp.per_token:
        raise ValueError(
            "cim_attention quantizes per (batch, head); per_token scale "
            "requests stay on the float attention path")
    backend = _backend(q, k)
    _backend(q, v)
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(sq, device=dev).expand(b, sq)
    if kv_positions is None:
        kv_positions = torch.arange(skv, device=dev).expand(b, skv)
    if kv_valid is None:
        kv_valid = torch.ones((b, skv), dtype=torch.int32, device=dev)
    ap = AttnParams(causal=causal, window=window)
    key = (("attn", gp, ap, q.dtype, k.dtype, v.dtype,
            None if block is None else tuple(block), backend)
           + bucket_attn(b, heads, kv_heads, sq, skv, hd))
    # QK^T + PV: two Skv-deep dots per (batch, head, query)
    fn = _cached(key, lambda: _attn_forward(gp, plan_attn(
        gp.family, gp.mode, gp.bits, b, heads, kv_heads, sq, skv, hd, ap,
        backend=backend, block=block, spec=gp.spec)), "attn", gp,
        2.0 * b * heads * sq * skv * hd)
    try:
        return fn(q, k, v, q_positions.to(torch.int32),
                  kv_positions.to(torch.int32), kv_valid.to(torch.int32))
    except ValueError as err:
        raise RuntimeError(
            f"the planned attention kernel refused its call: {err}") from err


_CACHES_DEFINED = True
