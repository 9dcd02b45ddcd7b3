"""Approximate CiM GEMM — the execution front door and dispatch engine
(GEMM universe).

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
  * ``surrogate``,
    ``surrogate_fast``  — dot + the calibrated mean shift (1+mu).  The
                          noise term and the fused surrogate kernel are
                          a later slice.

Every (family, mode, bits, backend) combination is routed by a single
**kernel registry**: `select_kernel` picks the highest-priority
`KernelEntry` that supports the request; the backend comes from the
operands' device ("cuda" or "cpu"), never from a global.  A hardware
GEMM on a CUDA tensor resolves to a ``cuda_*`` entry or raises — the
``torch_*`` plain entries are registered for "cpu" only.  Entries that
exist in the reference but are ported in a later slice (the nibble
sub-LUT kernel, the fused surrogate kernel) stay registered with their
reference priorities, and routing to one raises `NotImplementedError`.

Two float frontends execute a routed plan:

  * `cim_matmul`   — the macro frontend: true int quantization, f32 out.
  * `model_matmul` — the model-zoo frontend (`models.common.cim_linear`):
                     fake-quant for exact/surrogate, the fused kernels for
                     hardware, activation dtype preserved.

Kernel-backed paths carry a straight-through estimator
(`torch.autograd.Function`, backward ``g @ w.T`` / ``x.T @ g``).

**Plan cache.**  Each frontend resolves its work through a cache keyed
on (frontend, GemmParams, apply, operand dtypes, power-of-two-bucketed
shape, backend); a miss routes, builds the forward and counts one
`plan_misses()`.  This is the port's form of the reference's
zero-retrace contract: after an engine's warmup the count stays flat.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from .error_model import SurrogateModel
from .luts import MAX_LUT_BITS, nibble_decomposable
from .multipliers import MultiplierSpec
from .quantization import dequantize, fake_quant, quant_scale, quantize

MODES = ("exact", "bit_exact", "hardware", "surrogate", "surrogate_fast")
FAMILIES = ("exact", "appro42", "mitchell", "log_our")
BACKENDS = ("cpu", "cuda")


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
    # non-empty: the reference routes here but the port has not ported it
    # yet; selecting the entry raises NotImplementedError naming this
    later: str = ""
    # optional per-spec routing gate (e.g. nibble decomposability); such
    # entries are eligible only when the caller supplies a spec
    predicate: Optional[Callable[[MultiplierSpec], bool]] = dataclasses.field(
        default=None, compare=False)

    def supports(self, family: str, mode: str, bits: int,
                 backend: str) -> bool:
        return (mode in self.modes
                and (not self.families or family in self.families)
                and (not self.backends or backend in self.backends)
                and bits <= self.max_bits)


_REGISTRY: Dict[str, KernelEntry] = {}


def register_kernel(entry: KernelEntry) -> KernelEntry:
    if entry.name in _REGISTRY:
        raise ValueError(f"kernel {entry.name!r} already registered")
    _REGISTRY[entry.name] = entry
    _select_kernel_cached.cache_clear()
    return entry


def registered_kernels() -> Tuple[KernelEntry, ...]:
    return tuple(_REGISTRY.values())


@functools.lru_cache(maxsize=1024)
def _select_kernel_cached(family: str, mode: str, bits: int, backend: str,
                          spec: Optional[MultiplierSpec]) -> KernelEntry:
    matches = [e for e in _REGISTRY.values()
               if e.supports(family, mode, bits, backend)
               and (e.predicate is None
                    or (spec is not None and e.predicate(spec)))]
    if not matches:
        raise ValueError(
            f"no kernel for family={family!r} mode={mode!r} bits={bits} "
            f"backend={backend!r}; registered: {sorted(_REGISTRY)}")
    best = max(matches, key=lambda e: e.priority)
    if best.later:
        raise NotImplementedError(
            f"family={family!r} mode={mode!r} bits={bits} on {backend!r} "
            f"routes to {best.name!r} ({best.description}), which is "
            f"ported in a later slice: {best.later}")
    return best


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
    name="lut_nibble", modes=("hardware",), families=("exact", "appro42"),
    backends=BACKENDS, priority=20, max_bits=8, predicate=nibble_decomposable,
    description="nibble-decomposed kernel (4 x 2^{b/2} sub-LUTs)",
    later="the nibble sub-LUT kernel (ROADMAP queue B)"))
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
    backends=("cuda",), priority=10, max_bits=8,
    description="fused D / A^2@B^2 surrogate kernel",
    later="the fused surrogate kernel (ROADMAP queue B)"))
register_kernel(KernelEntry(
    name="torch_surrogate", modes=("surrogate", "surrogate_fast"),
    families=(), backends=(),
    description="dot + calibrated mean shift (noise term: later slice)"))


def select_kernel(family: str, mode: str, bits: int, backend: str,
                  spec: Optional[MultiplierSpec] = None) -> KernelEntry:
    """Route one (family, mode, bits, backend) request to a kernel.

    `backend` is the operands' device type ("cuda" or "cpu").  `spec`
    unlocks predicate-gated entries (the nibble kernel).  Memoized."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if family not in FAMILIES:
        raise ValueError(f"family {family!r} not in {FAMILIES}")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    return _select_kernel_cached(family, mode, bits, backend, spec)


def bucket(v: int) -> int:
    """Next power of two >= v (floor 8): the plan cache's shape key."""
    b = 8
    while b < v:
        b <<= 1
    return b


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """A routed GEMM: which kernel on which backend."""

    entry: KernelEntry
    backend: str


def plan_gemm(family: str, mode: str, bits: int, m: int, k: int, n: int,
              backend: str,
              spec: Optional[MultiplierSpec] = None) -> GemmPlan:
    """select_kernel for a concrete (bucketed) shape.  The kernels' tile
    sizes are fixed in this slice, so the shape only keys the plan."""
    del m, k, n
    return GemmPlan(entry=select_kernel(family, mode, bits, backend, spec),
                    backend=backend)


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
    per_token: bool = False            # later slice
    fault: Optional[object] = None     # later slice

    def __post_init__(self):
        if self.per_token or self.fault is not None:
            raise NotImplementedError(
                "per-token scales and fault injection are ported in a "
                "later slice")

    @property
    def spec(self) -> MultiplierSpec:
        return MultiplierSpec(self.family, self.bits, True,
                              self.compressor, self.n_approx_cols)

    @property
    def routing_spec(self) -> MultiplierSpec:
        return self.spec

    @classmethod
    def from_spec(cls, spec: MultiplierSpec, surrogate: SurrogateModel,
                  mode: str) -> "GemmParams":
        return cls(family=spec.family, bits=spec.bits, mode=mode,
                   mu=surrogate.mu_rel, c0=surrogate.c0_abs,
                   c1=surrogate.c1_rel, compressor=spec.compressor,
                   n_approx_cols=spec.n_approx_cols)


# ---------------------------------------------------------------------------
# Runners: integer route (int8 in, int32 out) and fused route (float in,
# f32 out).  The kernel wrappers pick the CUDA kernel or the plain
# version by the operands' device.
# ---------------------------------------------------------------------------


def _run_ref_lut(xq, wq, gp: GemmParams):
    from repro_torch.kernels import ops, ref

    return ref.lut_matmul_ref(xq, wq, ops.lut_table(gp.spec, xq.device),
                              gp.bits)


def _run_lut(xq, wq, gp: GemmParams):
    from repro_torch.kernels import ops

    return ops.approx_matmul_bit_exact(xq, wq, gp.spec)


def _run_log(xq, wq, gp: GemmParams):
    from repro_torch.kernels import ops

    return ops.log_matmul(xq, wq, bits=gp.bits,
                          compensated=(gp.family == "log_our"))


def _run_fused_lut(x, w, gp: GemmParams):
    from repro_torch.kernels import ops

    return ops.approx_matmul_fused(x, w, gp.spec)


def _run_fused_log(x, w, gp: GemmParams):
    from repro_torch.kernels import ops

    return ops.log_matmul_fused(x, w, bits=gp.bits,
                                compensated=(gp.family == "log_our"))


# entry name -> int8 (M,K) x int8 (K,N) -> int32 (M,N)
INT_RUNNERS: Dict[str, Callable] = {
    "torch_lut": _run_ref_lut,
    "cuda_lut_gather": _run_lut,
    "torch_lut_gather": _run_lut,
    "cuda_log": _run_log,
    "torch_log": _run_log,
}

# entry name -> float (M,K) x float (K,N) -> f32 (M,N); quantization and
# the (acc * sx) * sw epilogue run inside the kernel
FUSED_RUNNERS: Dict[str, Callable] = {
    "cuda_lut_gather": _run_fused_lut,
    "torch_lut_gather": _run_fused_lut,
    "cuda_log": _run_fused_log,
    "torch_log": _run_fused_log,
}


def run_int_kernel(plan: GemmPlan, xq, wq, gp: GemmParams):
    """Execute the integer core of a routed bit_exact/hardware GEMM."""
    try:
        runner = INT_RUNNERS[plan.entry.name]
    except KeyError:
        raise ValueError(
            f"kernel {plan.entry.name!r} has no integer runner") from None
    return runner(xq, wq, gp)


def _quantize_operands(x, w, bits):
    # activations: per-tensor scale (the macro's ADC view); weights:
    # per-out-channel
    sx = quant_scale(x, bits)
    sw = quant_scale(w, bits, axis=0)
    return quantize(x, sx, bits), sx, quantize(w, sw, bits), sw


class _STEMatmul(torch.autograd.Function):
    """A rank-2 (x2, w) -> out forward with the exact-float STE VJP."""

    @staticmethod
    def forward(ctx, x2, w, forward):
        ctx.save_for_backward(x2, w)
        return forward(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        dt = torch.promote_types(g.dtype, w.dtype)
        gx = g.to(dt) @ w.to(dt).T
        gw = x2.to(dt).T @ g.to(dt)
        return gx.to(x2.dtype), gw.to(w.dtype), None


def _ste(forward: Callable) -> Callable:
    """Flatten leading dims, run `forward` under the STE, restore."""

    def run(x, w):
        x2 = x.reshape(-1, x.shape[-1])
        out = _STEMatmul.apply(x2, w, forward)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    return run


def _shift(d: torch.Tensor, mu: float) -> torch.Tensor:
    # (1 + mu) * d with the factor rounded to d's dtype first, as the
    # reference's weakly typed Python float is
    return d * torch.tensor(1.0 + mu, dtype=d.dtype).item()


def _cim_forward(gp: GemmParams, plan: GemmPlan) -> Callable:
    """Macro frontend: true quantization, f32 out."""
    mode = gp.mode
    if mode == "exact":
        def forward(xf, wf):
            xq, sx, wq, sw = _quantize_operands(xf, wf, gp.bits)
            return dequantize(xq, sx) @ dequantize(wq, sw)
    elif mode in ("bit_exact", "hardware"):
        if plan.entry.name in FUSED_RUNNERS:
            runner = FUSED_RUNNERS[plan.entry.name]

            def forward(xf, wf):
                return runner(xf, wf, gp)
        else:
            def forward(xf, wf):
                xq, sx, wq, sw = _quantize_operands(
                    xf.to(torch.float32), wf.to(torch.float32), gp.bits)
                acc = run_int_kernel(plan, xq, wq, gp)
                return (acc.to(torch.float32) * sx) * sw
    else:  # surrogate / surrogate_fast, deterministic term
        def forward(xf, wf):
            xq, sx, wq, sw = _quantize_operands(xf, wf, gp.bits)
            return _shift(dequantize(xq, sx) @ dequantize(wq, sw), gp.mu)
    return _ste(forward)


def _model_forward(gp: GemmParams, plan: GemmPlan, apply: bool) -> Callable:
    """Model frontend: kernel-backed STE for the integer modes, the
    fake-quant QAT form otherwise; the activation dtype is preserved."""
    if apply and gp.mode in ("bit_exact", "hardware"):
        if plan.entry.name in FUSED_RUNNERS:
            runner = FUSED_RUNNERS[plan.entry.name]

            def forward(x2, wf):
                # the kernels widen bf16 operands on load (exact), so no
                # f32 copy of the weight is made
                return runner(x2, wf, gp).to(x2.dtype)
        else:
            def forward(x2, wf):
                xq, sx, wq, sw = _quantize_operands(
                    x2.to(torch.float32), wf.to(torch.float32), gp.bits)
                acc = run_int_kernel(plan, xq, wq, gp)
                return ((acc.to(torch.float32) * sx) * sw).to(x2.dtype)
        return _ste(forward)

    # exact / surrogate paths: fake-quant QAT form, the weight in ITS dtype
    def fn(x, w):
        xq = fake_quant(x, gp.bits)
        wq = fake_quant(w, gp.bits, axis=0).to(x.dtype)
        d = xq @ wq
        if not apply or gp.mode == "exact":
            return d
        return _shift(d, gp.mu)

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


def clear_dispatch_caches() -> None:
    """Drop the plan cache and the memoized routing table (tests)."""
    with _LOCK:
        _FORWARDS.clear()
    _select_kernel_cached.cache_clear()


def _backend(x: torch.Tensor, w: torch.Tensor) -> str:
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    return x.device.type


def _forward_for(frontend: str, gp: GemmParams, apply: bool,
                 x: torch.Tensor, w: torch.Tensor) -> Callable:
    m = 1
    for s in x.shape[:-1]:
        m *= int(s)
    k, n = x.shape[-1], w.shape[-1]
    backend = _backend(x, w)
    key = (frontend, gp, apply, x.dtype, w.dtype, bucket(m), bucket(k),
           bucket(n), backend)
    fn = _FORWARDS.get(key)
    if fn is None:
        with _LOCK:
            fn = _FORWARDS.get(key)
            if fn is None:
                if gp.mode not in MODES:
                    raise ValueError(f"mode {gp.mode!r} not in {MODES}")
                mode = gp.mode if apply else "exact"
                plan = plan_gemm(gp.family, mode, gp.bits, m, k, n, backend,
                                 spec=gp.routing_spec)
                fn = (_cim_forward(gp, plan) if frontend == "cim"
                      else _model_forward(gp, plan, apply))
                _FORWARDS[key] = fn
                _PLAN_MISSES[0] += 1
    return fn


def cim_matmul(x: torch.Tensor, w: torch.Tensor,
               gp: GemmParams) -> torch.Tensor:
    """Dispatch + execute one approximate GEMM (macro semantics).

    x: (..., K) float; w: (K, N) float, on one device.  Returns float32
    (..., N) with straight-through exact gradients."""
    return _forward_for("cim", gp, True, x, w)(x, w)


def model_matmul(x: torch.Tensor, w: torch.Tensor, gp: GemmParams, *,
                 apply: bool = True) -> torch.Tensor:
    """The model-zoo execution path (cim_linear core), registry-routed.

    Fake-quant STE for exact/surrogate (QAT), the fused hardware kernels
    for `hardware`, the activation dtype preserved end to end.
    `apply=False` runs the exact int8 macro (mixed-macro allocation)."""
    return _forward_for("model", gp, apply, x, w)(x, w)
