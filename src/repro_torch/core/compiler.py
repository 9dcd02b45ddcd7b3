"""The OpenACM compiler facade: CiMConfig -> CiMMacro.

`compile_macro` mirrors the paper's flow (Fig. 1/5): from an
architecture-level specification (multiplier family + bit width +
approximation knobs + SRAM geometry) it emits a "macro" — the calibrated
error surrogate, the error metrics, the PPA report and optionally the
variation-aware yield report.  The macro's product table is built on
first use by the kernel layer (kernels/ops.py).

Model code consumes a `CiMConfig` through `models.common.CiMParams`; the
macro-level matmul lives in `core.approx_gemm.cim_matmul`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from . import energy_model, sram_model, yield_analysis
from .approx_gemm import MODES, GemmParams, GemmPlan, plan_gemm
from .error_model import ErrorMetrics, SurrogateModel, characterize
from .multipliers import MultiplierSpec

# CiMConfig fields whose non-default values select features of later
# slices of the port (per-module allocation, fault injection, CiM
# attention, per-token scales): accepted as fields, refused as values.
_LATER_SLICE = ("alloc", "fault", "attn", "attn_heads", "per_token")


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
    alloc: Optional[tuple] = None
    per_token: bool = False
    attn: bool = False
    attn_heads: Optional[tuple] = None
    sram: sram_model.SRAMConfig = dataclasses.field(
        default_factory=sram_model.SRAMConfig)
    run_yield: bool = False
    fault: Optional[object] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        for name in _LATER_SLICE:
            if getattr(self, name) not in (None, False):
                raise NotImplementedError(
                    f"CiMConfig.{name} is not ported yet (a later slice "
                    "of the PyTorch port)")

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
                                    mode or self.config.mode)

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
