"""The OpenACM compiler facade: CiMConfig -> CiMMacro.

`compile_macro` mirrors the paper's flow (Fig. 1/5): from an
architecture-level specification (multiplier family + bit width +
approximation knobs + SRAM geometry) it emits a "macro" — the calibrated
error surrogate, the error metrics, the PPA report and optionally the
variation-aware yield report.  The macro's product table is built on
first use by the kernel layer (kernels/ops.py).

Model code consumes a `CiMConfig` through `models.common.CiMParams`; the
macro-level matmul is `CiMMacro.matmul` (`core.approx_gemm.cim_matmul`),
on the card unless its operands lie on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from . import energy_model, sram_model, yield_analysis
from .approx_gemm import (FAMILIES, MODES, SURROGATE_MODES, GemmParams,
                          GemmPlan, NoiseKey, cim_matmul, plan_gemm)
from .error_model import ErrorMetrics, SurrogateModel, characterize
from .faults import FAULT_MODES, FaultConfig
from .multipliers import MultiplierSpec

@dataclasses.dataclass(frozen=True)
class CiMConfig:
    """User-facing specification of the approximate CiM substrate."""

    family: str = "exact"            # exact | appro42 | mitchell | log_our
    bits: int = 8
    signed: bool = True
    compressor: str = "yang1"
    n_approx_cols: Optional[int] = None
    mode: str = "surrogate"          # one of approx_gemm.MODES; "hardware"
                                     # runs the hand-written GPU kernels
    # apply the approximate family only to matmuls whose name starts with
    # one of these prefixes; everything else runs the exact int8 macro.
    # () = everywhere (the paper's setting).
    apply_to: tuple = ()
    # heterogeneous per-module allocation (`core.allocate.autoallocate`'s
    # output): entries of (name_prefix, family, compressor, n_approx_cols)
    # route each matmul whose name matches the LONGEST prefix to that
    # multiplier; "exact"-family entries and unmatched modules run the
    # exact int8 macro.  Every entry runs in this config's `mode` at its
    # `bits`.  Exclusive with `apply_to` (its single-family special case)
    # and with `fault` (a defect map is compiled against one multiplier's
    # tables)
    alloc: Optional[tuple] = None
    # per-row (per-token) activation scales: each activation row
    # quantizes against its own max, so a row's result does not depend on
    # the rows batched with it (the speculative-decoding verifier,
    # serving/spec.py); the macro (`CiMMacro.gemm_params`) stays per
    # tensor, as the reference's
    per_token: bool = False
    # route self-attention's QK^T and PV through the fused CiM attention
    # kernels in the integer modes; `attn_heads` optionally gives one
    # family per query head (per-head tier allocation)
    attn: bool = False
    attn_heads: Optional[tuple] = None
    sram: sram_model.SRAMConfig = dataclasses.field(
        default_factory=sram_model.SRAMConfig)
    run_yield: bool = False
    # as-fabricated stuck-at defects of the macro's stored words and
    # tables (core/faults.py); integer and exact modes only
    fault: Optional[FaultConfig] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.alloc is not None:
            self._check_alloc()
        if self.fault is not None and self.mode not in FAULT_MODES:
            raise ValueError(
                f"fault injection needs an integer storage domain "
                f"(modes {FAULT_MODES}); mode {self.mode!r} stores no "
                "words or tables to fault")
        if self.attn_heads is not None:
            if not self.attn:
                raise ValueError("attn_heads requires attn=True")
            bad = [f for f in self.attn_heads if f not in FAMILIES]
            if bad:
                raise ValueError(
                    f"attn_heads families {bad!r} not in {FAMILIES}")

    def _check_alloc(self) -> None:
        """Validate `alloc` as the reference does and normalize it to a
        tuple of (str, str, str, int | None) tuples."""
        if self.apply_to:
            raise ValueError(
                "alloc and apply_to are mutually exclusive: apply_to is "
                "the single-family special case of alloc")
        if self.fault is not None:
            raise ValueError(
                "alloc and fault are mutually exclusive: a defect map is "
                "compiled against one multiplier's tables")
        norm = []
        for e in self.alloc:
            if len(e) != 4:
                raise ValueError(
                    f"alloc entries are (prefix, family, compressor, "
                    f"n_approx_cols) 4-tuples; got {e!r}")
            prefix, family, compressor, ncols = e
            if not isinstance(prefix, str) or not prefix:
                raise ValueError(
                    f"alloc prefix must be a non-empty str: {e!r}")
            if family not in FAMILIES:
                raise ValueError(
                    f"alloc family {family!r} not in {FAMILIES}")
            if ncols is not None and (not isinstance(ncols, int)
                                      or ncols < 0):
                raise ValueError(
                    f"alloc n_approx_cols must be None or int >= 0: {e!r}")
            norm.append((prefix, family, str(compressor), ncols))
        object.__setattr__(self, "alloc", tuple(norm))

    @property
    def spec(self) -> MultiplierSpec:
        return MultiplierSpec(self.family, self.bits, self.signed,
                              self.compressor, self.n_approx_cols)


@dataclasses.dataclass(frozen=True)
class CiMMacro:
    """Compiled macro: what the model layers execute against."""

    config: CiMConfig
    surrogate: SurrogateModel
    metrics: ErrorMetrics
    ppa: energy_model.PPAReport
    yield_report: Optional[yield_analysis.YieldResult]

    def gemm_params(self, mode: Optional[str] = None) -> GemmParams:
        """Static dispatch parameters for this macro."""
        return GemmParams.from_spec(self.config.spec, self.surrogate,
                                    mode or self.config.mode,
                                    fault=self.config.fault)

    def matmul(self, x, w, key: Optional[NoiseKey] = None,
               mode: Optional[str] = None):
        """x @ w on this macro (`cim_matmul`): f32 out, straight-through
        gradients; in a surrogate mode a `key` draws the calibrated
        noise."""
        return cim_matmul(x, w, self.gemm_params(mode), key)

    def warmup(self, shapes, mode: Optional[str] = None, dtype=None,
               device=None) -> int:
        """Build the plans of `matmul` for a set of (m, k, n) shapes, so
        the first real call at any of them (or in their buckets) builds
        nothing (`plan_misses()` stays flat): the deterministic plan and,
        when the macro carries calibrated noise in a surrogate mode, the
        noisy one.  Each shape runs once on zeros of `dtype` (f32) on
        `device` (the card unless "cpu"), which also loads its kernel.
        Returns the number of shapes."""
        import torch

        from repro_torch.device import resolve_device

        dev = resolve_device(device)
        dtype = dtype or torch.float32
        gp = self.gemm_params(mode)
        noisy = gp.mode in SURROGATE_MODES and (gp.c0 > 0.0 or gp.c1 > 0.0)
        for m, k, n in shapes:
            x = torch.zeros((m, k), dtype=dtype, device=dev)
            w = torch.zeros((k, n), dtype=dtype, device=dev)
            cim_matmul(x, w, gp)
            if noisy:
                cim_matmul(x, w, gp, NoiseKey(0))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return len(shapes)

    def kernel_plan(self, m: int, k: int, n: int, backend: str = "cuda",
                    mode: Optional[str] = None) -> GemmPlan:
        """Which kernel a (m, k, n) GEMM on `backend` routes to."""
        return plan_gemm(self.config.family, mode or self.config.mode,
                         self.config.bits, m, k, n, backend,
                         spec=self.config.spec)

    def energy_for(self, n_macs: float) -> float:
        return energy_model.workload_energy_j(
            self.config.family, self.config.bits, n_macs)

    def fakeram_abstract(self):
        return sram_model.fakeram_abstract(self.config.sram)

    def summary(self) -> str:
        m, p = self.metrics, self.ppa
        return (f"CiMMacro[{self.config.spec.short_name()} mode={self.config.mode} "
                f"sram={self.config.sram.rows}x{self.config.sram.cols}] "
                f"NMED={m.nmed:.2e} MRED={m.mred:.2e} WCE={m.wce} "
                f"E/MAC={p.energy_per_mac_j*1e12:.2f}pJ area={p.pnr_area_um2:.0f}um2")


def compile_macro(config: CiMConfig) -> CiMMacro:
    """OpenACM's end-to-end compile step (paper Fig. 1)."""
    spec = config.spec
    metrics = characterize(spec)
    surrogate = (SurrogateModel.exact(spec) if config.family == "exact"
                 else SurrogateModel.fit(spec))
    ppa = energy_model.ppa_report(config.family, config.bits,
                                  config.sram.rows, config.sram.cols,
                                  compressor=config.compressor,
                                  n_approx_cols=config.n_approx_cols)
    yrep = None
    if config.run_yield:
        model = yield_analysis.model_for_geometry(config.sram.rows)
        yrep = yield_analysis.mnis_yield(model)
    return CiMMacro(config=config, surrogate=surrogate, metrics=metrics,
                    ppa=ppa, yield_report=yrep)
