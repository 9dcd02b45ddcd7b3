"""Accuracy tiers: the paper's compile-time accuracy-energy knob turned
into a runtime, per-request degree of freedom.

A tier is a named (CiMConfig, characterized NMED, energy/MAC) triple.
The default ladder is built from the DSE characterization
(core/dse.enumerate_space), one tier per multiplier family:

  * ``exact``    — the exact int8 macro (QAT semantics, NMED 0); always
                   ``mode="exact"``
  * ``balanced`` — the best Appro4-2 point
  * ``economy``  — the best log-domain point (mitchell / log_our)

`allocation_tier` makes a rung of a per-module allocation
(core/allocate.py).  `TierRouter.route` maps a request's declared error
tolerance (max NMED) to the cheapest-energy tier whose characterized
NMED fits; requests may also pin a tier by name (SLA classes).
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
                attn: bool = False) -> Tuple[AccuracyTier, ...]:
    """DSE-characterized default ladder, sorted by ascending NMED.

    `mode` is the execution mode of the *approximate* tiers (the exact
    tier always runs the exact int8 macro): "surrogate_fast" (fake-quant
    dot times the calibrated mean shift), "surrogate" (on the card the
    fused surrogate kernel, on the CPU its plain route) or "hardware"
    (the bit-true GPU kernels).  Serving threads no noise key, so a
    surrogate lane is deterministic: the mean shift applies and the
    variance term stays dormant.  ``attn=True`` also routes every tier's
    self-attention through the fused CiM attention kernels; only the
    integer modes (hardware/bit_exact) take that path, so the exact tier
    keeps the float attention."""
    pts = dse.enumerate_space(bits=bits, families=tuple(families))
    tiers = []
    if "exact" in families:
        ex = [p for p in pts if p.spec.family == "exact"][0]
        tiers.append(AccuracyTier(
            "exact", CiMConfig(family="exact", bits=bits, mode="exact",
                               attn=attn),
            ex.nmed, ex.energy_per_mac_j))
    app = dse.select([p for p in pts if p.spec.family == "appro42"])
    if app:
        best = app[0]
        tiers.append(AccuracyTier(
            "balanced",
            CiMConfig(family="appro42", bits=bits, mode=mode,
                      compressor=best.spec.compressor,
                      n_approx_cols=best.spec.n_approx_cols,
                      attn=attn),
            best.nmed, best.energy_per_mac_j))
    logp = dse.select([p for p in pts
                       if p.spec.family in ("mitchell", "log_our")])
    if logp:
        best = logp[0]
        tiers.append(AccuracyTier(
            "economy", CiMConfig(family=best.spec.family, bits=bits,
                                 mode=mode, attn=attn),
            best.nmed, best.energy_per_mac_j))
    return tuple(sorted(tiers, key=lambda t: t.nmed))


def allocation_tier(allocation, name: str = "autoalloc",
                    mode: Optional[str] = None,
                    attn: bool = False) -> AccuracyTier:
    """Turn a `core.allocate.Allocation` into a serving-ladder rung.

    The tier's CiMConfig carries the per-module `alloc` table, so the
    engine builds it like any other lane: every module's frozen
    GemmParams keys its own plans, warmed with the lane's shapes, and the
    MEASURED allocation NMED (not a per-multiplier proxy) is what the
    router ranks against request tolerances.  Energy is the allocation's
    MAC-weighted energy/MAC over the probed modules."""
    cim = allocation.to_cim_config(attn=attn,
                                   **({} if mode is None
                                      else {"mode": mode}))
    return AccuracyTier(name, cim, allocation.nmed,
                        allocation.energy_per_mac_j)


def spec_pair(tiers: Sequence[AccuracyTier],
              drafter: Optional[str] = None
              ) -> Tuple[AccuracyTier, AccuracyTier]:
    """(drafter, verifier) of speculative decoding (serving/spec.py).

    The verifier is the ladder's ``exact`` rung with per-token activation
    scales (``per_token=True``): under them a batched multi-position
    verify computes every row as a single step would, so accepting only
    the verifier's own argmax keeps the output the exact lane's.  The
    drafter is the named tier or, by default, the cheapest-energy
    approximate rung (a wrong guess costs a rejected draft, never
    accuracy)."""
    by_name = {t.name: t for t in tiers}
    if "exact" not in by_name:
        raise ValueError("spec decoding needs an 'exact' tier to verify "
                         f"against; configured: {sorted(by_name)}")
    ex = by_name["exact"]
    verifier = dataclasses.replace(
        ex, cim=dataclasses.replace(ex.cim, per_token=True))
    approx = [t for t in tiers if t.name != "exact" and t.cim is not None]
    if drafter is not None:
        try:
            d = by_name[drafter]
        except KeyError:
            raise KeyError(f"unknown drafter tier {drafter!r}; "
                           f"configured: {sorted(by_name)}") from None
    elif approx:
        d = min(approx, key=lambda t: t.energy_per_mac_j)
    else:
        d = ex                    # degenerate: exact drafts for itself
    return d, verifier


class TierRouter:
    """Tolerance -> configured tier (feasibility filter + energy rank)."""

    def __init__(self, tiers: Sequence[AccuracyTier]):
        if not tiers:
            raise ValueError("need at least one tier")
        self.tiers: Dict[str, AccuracyTier] = {t.name: t for t in tiers}

    def route(self, tolerance: Optional[float] = None,
              tier: Optional[str] = None,
              avoid: Sequence[str] = ()) -> AccuracyTier:
        """Pick a tier for one request.

        An explicit `tier` name wins (SLA class); otherwise the
        cheapest-energy tier with NMED <= tolerance (None or 0 demands
        the exact rung).

        `avoid` names quarantined tiers (sentinel-tripped lanes).  A
        pinned request whose tier is avoided is demoted to the
        cheapest-energy healthy tier whose NMED is no worse than the
        pinned tier's: accuracy degrades upward, never downward.
        Tolerance routing filters the avoided tiers out."""
        avoid = frozenset(avoid)
        if tier is not None:
            try:
                t = self.tiers[tier]
            except KeyError:
                raise KeyError(f"unknown tier {tier!r}; configured: "
                               f"{sorted(self.tiers)}") from None
            if tier not in avoid:
                return t
            ok = [u for u in self.tiers.values()
                  if u.name not in avoid and u.nmed <= t.nmed]
            if not ok:
                raise ValueError(
                    f"tier {tier!r} is quarantined and no healthy tier "
                    f"with NMED <= {t.nmed:g} remains")
            return min(ok, key=lambda u: u.energy_per_mac_j)
        tol = tolerance or 0.0
        ok = [t for t in self.tiers.values()
              if t.nmed <= tol and t.name not in avoid]
        if not ok:
            raise ValueError(
                f"no configured{' healthy' if avoid else ''} tier meets "
                f"NMED <= {tol:g}; tightest is "
                f"{min(self.tiers.values(), key=lambda t: t.nmed).nmed:g}")
        return min(ok, key=lambda t: t.energy_per_mac_j)
