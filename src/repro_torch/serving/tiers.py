"""Accuracy tiers: the paper's compile-time accuracy-energy knob turned
into a runtime, per-request degree of freedom.

A tier is a named (CiMConfig, characterized NMED, energy/MAC) triple.
The default ladder is built from the DSE characterization
(core/dse.enumerate_space), one tier per multiplier family:

  * ``exact``    — the exact int8 macro (QAT semantics, NMED 0); always
                   ``mode="exact"``
  * ``balanced`` — the best Appro4-2 point
  * ``economy``  — the best log-domain point (mitchell / log_our)

`TierRouter.route` maps a request's declared error tolerance (max NMED)
to the cheapest-energy tier whose characterized NMED fits; requests may
also pin a tier by name (SLA classes).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core import dse
from repro_torch.core.compiler import CiMConfig


@dataclasses.dataclass(frozen=True)
class AccuracyTier:
    """One rung of the accuracy-energy ladder."""

    name: str
    cim: Optional[CiMConfig]         # None = CiM off (pure float serving)
    nmed: float                      # characterized NMED of the multiplier
    energy_per_mac_j: float

    @property
    def family(self) -> str:
        return self.cim.family if self.cim is not None else "off"


def build_tiers(bits: int = 8, mode: str = "surrogate_fast",
                families: Sequence[str] = ("exact", "appro42", "mitchell",
                                           "log_our"),
                ) -> Tuple[AccuracyTier, ...]:
    """DSE-characterized default ladder, sorted by ascending NMED.

    `mode` is the execution mode of the *approximate* tiers (the exact
    tier always runs the exact int8 macro); "hardware" runs the
    bit-true GPU kernels."""
    pts = dse.enumerate_space(bits=bits, families=tuple(families))
    tiers = []
    if "exact" in families:
        ex = [p for p in pts if p.spec.family == "exact"][0]
        tiers.append(AccuracyTier(
            "exact", CiMConfig(family="exact", bits=bits, mode="exact"),
            ex.nmed, ex.energy_per_mac_j))
    app = dse.select([p for p in pts if p.spec.family == "appro42"])
    if app:
        best = app[0]
        tiers.append(AccuracyTier(
            "balanced",
            CiMConfig(family="appro42", bits=bits, mode=mode,
                      compressor=best.spec.compressor,
                      n_approx_cols=best.spec.n_approx_cols),
            best.nmed, best.energy_per_mac_j))
    logp = dse.select([p for p in pts
                       if p.spec.family in ("mitchell", "log_our")])
    if logp:
        best = logp[0]
        tiers.append(AccuracyTier(
            "economy", CiMConfig(family=best.spec.family, bits=bits,
                                 mode=mode),
            best.nmed, best.energy_per_mac_j))
    return tuple(sorted(tiers, key=lambda t: t.nmed))


class TierRouter:
    """Tolerance -> configured tier (feasibility filter + energy rank)."""

    def __init__(self, tiers: Sequence[AccuracyTier]):
        if not tiers:
            raise ValueError("need at least one tier")
        self.tiers: Dict[str, AccuracyTier] = {t.name: t for t in tiers}

    def route(self, tolerance: Optional[float] = None,
              tier: Optional[str] = None) -> AccuracyTier:
        """An explicit `tier` name wins (SLA class); otherwise the
        cheapest-energy tier with NMED <= tolerance (None or 0 demands
        the exact rung)."""
        if tier is not None:
            try:
                return self.tiers[tier]
            except KeyError:
                raise KeyError(f"unknown tier {tier!r}; configured: "
                               f"{sorted(self.tiers)}") from None
        tol = tolerance or 0.0
        ok = [t for t in self.tiers.values() if t.nmed <= tol]
        if not ok:
            raise ValueError(
                f"no configured tier meets NMED <= {tol:g}; tightest is "
                f"{min(self.tiers.values(), key=lambda t: t.nmed).nmed:g}")
        return min(ok, key=lambda t: t.energy_per_mac_j)
