"""SRAM macro model: geometry/timing knobs + FakeRAM-style abstract.

Models the banked, subarrayed 6T macro of paper Fig. 4 at the level the
compiler needs: compiler-visible knobs (rows, cols, word width, banks,
subarrays, column-mux ratio, SAE/precharge timing) -> access
latency/energy/area, plus a FakeRAM2.0-style abstract dict so the macro
can be dropped into black-box P&R flows (paper Sec. III-D).

On TPU, the geometry knobs additionally map onto kernel tiling: a
(rows x cols) CiM array is one Pallas block; banks map to grid steps.
`tile_shape()` is consumed by kernels/ for that co-design loop.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

from .energy_model import delay_ns, sram_area_um2


@dataclasses.dataclass(frozen=True)
class SRAMConfig:
    rows: int = 16
    cols: int = 8               # bits per word
    banks: int = 1
    subarrays: int = 1
    mux_ratio: int = 1          # column multiplexing
    sae_ps: int = 350           # sense-amp enable timing
    precharge_ps: int = 300
    vdd: float = 1.0

    def __post_init__(self):
        for f in ("rows", "cols", "banks", "subarrays", "mux_ratio"):
            v = getattr(self, f)
            if v < 1 or (v & (v - 1)) != 0:
                raise ValueError(f"{f} must be a positive power of two, got {v}")
        if self.rows % self.subarrays:
            raise ValueError("rows must divide evenly into subarrays")

    @property
    def words(self) -> int:
        return self.rows * self.banks

    @property
    def total_bits(self) -> int:
        return self.words * self.cols


# FreePDK45-flavour energy constants (J), first order:
_E_BITLINE = 2.1e-15      # per column precharge+swing per access
_E_WORDLINE = 0.6e-15     # per row on the asserted WL segment
_E_SA = 1.3e-15           # per sense amp fired
_E_LEAK_PER_BIT = 1.0e-18  # static per bit per cycle @ 100MHz


def access_energy_j(cfg: SRAMConfig) -> float:
    """Dynamic energy of one read access (one word)."""
    rows_per_sub = cfg.rows // cfg.subarrays
    cols_active = cfg.cols * cfg.mux_ratio      # mux shares SAs over columns
    sas = cfg.cols
    e = (_E_BITLINE * cols_active * rows_per_sub / 16.0
         + _E_WORDLINE * cols_active
         + _E_SA * sas)
    return e * cfg.vdd ** 2


def access_latency_ns(cfg: SRAMConfig) -> float:
    base = delay_ns(cfg.rows)
    # timing knobs move the SAE/precharge portion of the critical path
    return base + (cfg.sae_ps - 350) * 1e-3 + (cfg.precharge_ps - 300) * 1e-3


def leakage_w(cfg: SRAMConfig) -> float:
    return _E_LEAK_PER_BIT * cfg.total_bits * 1e8


def area_um2(cfg: SRAMConfig) -> float:
    per_bank = sram_area_um2(cfg.rows, cfg.cols)
    return per_bank * cfg.banks * (1.0 + 0.03 * (cfg.subarrays - 1))


def tile_shape(cfg: SRAMConfig) -> tuple:
    """CiM array -> Pallas block co-design mapping.

    One bank of (rows x cols-bit words) holds a (rows, rows) int8 weight
    tile in the kernels' layout; clamped to MXU-friendly multiples.
    """
    t = max(8, min(512, cfg.rows * cfg.banks))
    return (t, t)


def fakeram_abstract(cfg: SRAMConfig, name: str = "openacm_sram") -> Dict:
    """FakeRAM2.0-style abstract view for black-box P&R integration."""
    width_um = math.sqrt(area_um2(cfg)) * 1.2
    height_um = area_um2(cfg) / width_um
    return {
        "name": f"{name}_{cfg.words}x{cfg.cols}",
        "width_um": round(width_um, 3),
        "height_um": round(height_um, 3),
        "depth": cfg.words,
        "width_bits": cfg.cols,
        "banks": cfg.banks,
        "access_time_ns": round(access_latency_ns(cfg), 3),
        "cycle_time_ns": round(access_latency_ns(cfg) * 1.1, 3),
        "pins": ["clk", "we_in", "ce_in",
                 f"addr_in[{max(1, (cfg.words - 1).bit_length()) - 1}:0]",
                 f"wd_in[{cfg.cols - 1}:0]", f"rd_out[{cfg.cols - 1}:0]"],
    }
