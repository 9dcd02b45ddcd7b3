"""Accuracy-constrained design-space exploration (paper Sec. VI goal).

Given an application accuracy budget (max NMED / max MRED), enumerate
the multiplier design space (family x approximate-column count x bit
width), filter by the budget, and rank by energy per MAC — the
"fine-grained accuracy-energy trade-off" loop OpenACM automates.

Each spec is characterized by the serial `error_model.characterize`
(bitwise the same metrics as the reference's batched evaluation), backed
by the port's characterization cache.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from . import energy_model
from .error_model import characterize
from .multipliers import MultiplierSpec


@dataclasses.dataclass(frozen=True)
class DSEPoint:
    spec: MultiplierSpec
    nmed: float
    mred: float
    wce: int
    energy_per_mac_j: float
    logic_area_um2: float

    def dominates(self, other: "DSEPoint") -> bool:
        return (self.nmed <= other.nmed
                and self.energy_per_mac_j <= other.energy_per_mac_j
                and (self.nmed < other.nmed
                     or self.energy_per_mac_j < other.energy_per_mac_j))


def design_space(bits: int = 8,
                 families: Sequence[str] = ("exact", "appro42", "mitchell",
                                            "log_our"),
                 compressors: Sequence[str] = ("yang1", "orplane"),
                 approx_col_counts: Optional[Sequence[int]] = None,
                 ) -> List[MultiplierSpec]:
    """The spec grid `enumerate_space` characterizes."""
    if approx_col_counts is None:
        approx_col_counts = (bits // 2, 3 * bits // 4, bits, 5 * bits // 4)
    specs: List[MultiplierSpec] = []
    for fam in families:
        if fam == "appro42":
            for comp in compressors:
                for n in approx_col_counts:
                    specs.append(MultiplierSpec(fam, bits, False, comp, n))
        else:
            specs.append(MultiplierSpec(fam, bits))
    return specs


def points_for(specs: Sequence[MultiplierSpec],
               n_samples: int = 200_000, seed: int = 0) -> List[DSEPoint]:
    """Characterize + price an explicit spec list (cache-backed)."""
    pts = []
    for spec in specs:
        m = characterize(spec, n_samples=n_samples, seed=seed)
        pts.append(DSEPoint(
            spec=spec, nmed=m.nmed, mred=m.mred, wce=m.wce,
            energy_per_mac_j=energy_model.energy_per_mac_j(
                spec.family, spec.bits, spec.compressor,
                spec.n_approx_cols),
            logic_area_um2=energy_model.logic_area_um2(spec.family,
                                                       spec.bits)))
    return pts


def enumerate_space(bits: int = 8,
                    families: Sequence[str] = ("exact", "appro42", "mitchell",
                                               "log_our"),
                    compressors: Sequence[str] = ("yang1", "orplane"),
                    approx_col_counts: Optional[Sequence[int]] = None,
                    ) -> List[DSEPoint]:
    return points_for(design_space(bits, families, compressors,
                                   approx_col_counts))


def select(points: List[DSEPoint], max_nmed: Optional[float] = None,
           max_mred: Optional[float] = None) -> List[DSEPoint]:
    """Feasible points under the accuracy budget, best energy first."""
    ok = [p for p in points
          if (max_nmed is None or p.nmed <= max_nmed)
          and (max_mred is None or p.mred <= max_mred)]
    return sorted(ok, key=lambda p: p.energy_per_mac_j)


def pareto_frontier(points: List[DSEPoint]) -> List[DSEPoint]:
    front = [p for p in points
             if not any(q.dominates(p) for q in points if q is not p)]
    return sorted(front, key=lambda p: p.energy_per_mac_j)


def best_under_budget(bits: int = 8, max_nmed: float = 5e-3,
                      **kw) -> DSEPoint:
    sel = select(enumerate_space(bits=bits, **kw), max_nmed=max_nmed)
    if not sel:
        raise ValueError(f"no design meets NMED<={max_nmed} at {bits} bits")
    return sel[0]
