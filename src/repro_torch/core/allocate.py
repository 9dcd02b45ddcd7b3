"""Surrogate-guided per-module accuracy allocation.

The paper's DSE loop (Sec. VI) picks ONE multiplier for the whole
application.  This module allocates a multiplier PER MODULE NAME
("wq", "mlp_wo", ...) under a model-level NMED budget, in three stages:

  1. **Probe** — one eager forward with the `cim_linear` override hook
     records each named matmul's shape, MAC count, calls and
     activation/weight ranges.
  2. **Learned surrogate** — ground-truth per-module NMED contributions
     come from the mixing evaluator (every candidate tier's output per
     allocatable module, mixed by a one-hot selection row); a small MLP
     (torch, the reference's hand-written Adam) regresses the
     contribution from (tier error statistics x module statistics), and a
     calibrated root-sum-square combiner maps per-module risks to the
     model's NMED.
  3. **Search** — greedy cheapest-first with repair plus a beam over
     modules (largest MACs first) scored by the surrogate; the top
     candidates are re-measured by the evaluator, so the returned
     allocation's `nmed` is a measurement, not a prediction.

`autoallocate(model, max_nmed)` is the one-command entry; the result's
`.to_cim_config()` / `.alloc` plug into `CiMConfig.alloc` and
`serving.tiers.allocation_tier` (a served lane whose modules each pin
their own plans, so no plan is built in steady state).

Everything runs eagerly on the model's device (the card unless the
model was built on the CPU).  The search helpers are the reference's
numpy, copied.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import energy_model
from .approx_gemm import GemmParams, NoiseKey, model_matmul
from .error_model import ErrorMetrics, SurrogateModel, characterize_batch
from .multipliers import MultiplierSpec

# the unit of `MixEvaluator.nmed_many`: selections are measured one
# forward each and brought to the host a chunk at a time
_CHUNK = 32


# ---------------------------------------------------------------------------
# Observability (the error_model sink pattern)
# ---------------------------------------------------------------------------

_OBS_SINK: List[Optional[object]] = [None]


def set_obs_sink(sink) -> Optional[object]:
    """Install an allocation-search sink; returns the previous one.
    The sink's `alloc_search(event=..., count=...)` is called (if
    present) with events "probe", "truth", "search", "reeval"."""
    prev = _OBS_SINK[0]
    _OBS_SINK[0] = sink
    return prev


def _obs(event: str, count: int) -> None:
    sink = _OBS_SINK[0]
    if sink is None:
        return
    fn = getattr(sink, "alloc_search", None)
    if fn is not None:
        fn(event=event, count=count)


# ---------------------------------------------------------------------------
# Stage 0: candidate tiers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TierCandidate:
    """One multiplier a module may be allocated to."""

    spec: MultiplierSpec
    metrics: ErrorMetrics
    energy_per_mac_j: float

    @property
    def is_exact(self) -> bool:
        return self.spec.family == "exact"

    def short_name(self) -> str:
        return self.spec.short_name()


def default_candidates(bits: int = 8, signed: bool = True,
                       ) -> List[MultiplierSpec]:
    """Default per-module tier ladder: exact + both appro42 cells at
    full column count + the cheaper logarithmic family.  Always starts
    with exact so the repair loop can terminate."""
    return [
        MultiplierSpec("exact", bits, signed),
        MultiplierSpec("appro42", bits, signed, "yang1", min(bits, 8)),
        MultiplierSpec("appro42", bits, signed, "orplane",
                       5 * bits // 4),
        MultiplierSpec("log_our", bits, signed),
    ]


def build_candidates(specs: Sequence[MultiplierSpec], mesh=None,
                     device=None) -> List[TierCandidate]:
    """Characterize (batched on `device`, cache-backed) and price a spec
    list; the exact tier is moved to index 0 (search invariant)."""
    metrics = characterize_batch(specs, mesh=mesh, device=device)
    cands = [TierCandidate(
        spec=s, metrics=m,
        energy_per_mac_j=energy_model.energy_per_mac_j(
            s.family, s.bits, s.compressor, s.n_approx_cols))
        for s, m in zip(specs, metrics)]
    cands.sort(key=lambda c: (not c.is_exact,))
    if not cands or not cands[0].is_exact:
        raise ValueError("candidate set must include the exact tier")
    return cands


# ---------------------------------------------------------------------------
# Stage 1: probe — per-module shapes/MACs/ranges from one eager forward
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModuleStats:
    """What one probed matmul looks like to the allocator."""

    name: str
    k: int
    n: int
    macs: float          # total MACs over the probe batch (all calls)
    calls: int           # executions per forward (one a layer)
    absmax_x: float
    absmax_w: float


def _tokens(tokens, device) -> torch.Tensor:
    """A token batch (tensor or array-like, copied) on `device`."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.array(tokens, np.int64))
    return tokens.to(device)


def _with_override(hook, run):
    from repro_torch.models import common as mcommon

    prev = mcommon._LINEAR_OVERRIDE[0]
    mcommon.set_linear_override(hook)
    try:
        with torch.inference_mode():
            return run()
    finally:
        mcommon.set_linear_override(prev)


def probe_modules(model, params, tokens,
                  modules: Optional[Sequence[str]] = None,
                  ) -> List[ModuleStats]:
    """Run one forward (`LM.forward_logits(params, tokens)`) with the
    linear-override hook recording every named matmul (or those of
    `modules`)."""
    acc: Dict[str, Dict] = {}
    order: List[str] = []

    def hook(x, w, ctx, name):
        if not name or (modules is not None and name not in modules):
            return None
        m = 1
        for s in x.shape[:-1]:
            m *= int(s)
        k, n = int(w.shape[0]), int(w.shape[1])
        st = acc.get(name)
        if st is None:
            order.append(name)
            st = acc[name] = dict(k=k, n=n, macs=0.0, calls=0,
                                  ax=0.0, aw=0.0)
        st["macs"] += float(m) * k * n
        st["calls"] += 1
        st["ax"] = max(st["ax"], float(x.abs().max()))
        st["aw"] = max(st["aw"], float(w.abs().max()))
        return None

    tokens = _tokens(tokens, model.device)
    _with_override(hook, lambda: model.forward_logits(params, tokens))
    stats = [ModuleStats(name=nm, k=acc[nm]["k"], n=acc[nm]["n"],
                         macs=acc[nm]["macs"], calls=acc[nm]["calls"],
                         absmax_x=acc[nm]["ax"], absmax_w=acc[nm]["aw"])
             for nm in order]
    _obs("probe", len(stats))
    return stats


# ---------------------------------------------------------------------------
# Stage 2a: mixing evaluator — the measured model NMED of any allocation
# ---------------------------------------------------------------------------


class MixEvaluator:
    """Measures model NMED of per-module tier selections.

    Every allocatable module's output is the selection row's mix of the
    candidate tiers' outputs, so an allocation is an input (a selection
    matrix), never a new model.  Tiers of weight 0 are not computed: for
    the one-hot rows the search makes, that is the reference's sum of
    every tier's output times its weight, value for value.  Each
    selection is one forward of its own: activation scales are per
    tensor, so batching selections into one forward would give another
    result.  Noise keys are fixed per (module, tier), so evaluations are
    deterministic and comparable.  The exact tier runs the exact int8
    macro (`model_matmul(..., apply=False)`); modules outside `modules`
    take the model's own CiM routing (the plain float product when the
    model has no CiMConfig).
    NMED = mean |logits - logits_exact| / max |logits_exact|."""

    def __init__(self, model, params, tokens,
                 candidates: Sequence[TierCandidate],
                 modules: Sequence[ModuleStats],
                 mode: str = "surrogate"):
        self.model, self.params = model, params
        self.device = model.device
        self.tokens = _tokens(tokens, self.device)
        self.candidates = list(candidates)
        self.modules = list(modules)
        self.mode = mode
        self._index = {m.name: i for i, m in enumerate(self.modules)}
        self._n_evals = 0
        self._tiers: List[Optional[GemmParams]] = []
        for c in self.candidates:
            if c.is_exact:
                self._tiers.append(None)   # exact int8 macro (apply=False)
            else:
                sur = SurrogateModel(
                    mu_rel=c.metrics.mu_rel, c0_abs=c.metrics.c0_abs,
                    c1_rel=c.metrics.c1_rel, wce=c.metrics.wce,
                    spec=c.spec)
                self._tiers.append(GemmParams.from_spec(c.spec, sur, mode))
        # the exact tier's int8 macro (the family is not read when
        # apply=False)
        self._exact_gp = GemmParams(family="exact",
                                    bits=self.candidates[0].spec.bits,
                                    mode=mode)
        base = NoiseKey(0)
        self._keys = [[base.child(str(i)).child(str(t))
                       for t in range(len(self.candidates))]
                      for i in range(len(self.modules))]
        self._sel: Optional[np.ndarray] = None
        L, T = len(self.modules), len(self.candidates)
        sel0 = np.zeros((L, T), np.float32)
        sel0[:, 0] = 1.0
        self._ref = self._forward(sel0).to(torch.float32)
        self._ref_scale = torch.clamp_min(self._ref.abs().max(), 1e-12)

    def _hook(self, x, w, ctx, name):
        i = self._index.get(name)
        if i is None:
            return None                    # not allocatable: model routing
        out = None
        for t, wt in enumerate(self._sel[i]):
            if wt == 0.0:
                continue
            gp = self._tiers[t]
            if gp is None:
                o = model_matmul(x, w, self._exact_gp, None, apply=False)
            else:
                o = model_matmul(x, w, gp, self._keys[i][t], apply=True)
            if wt != 1.0:
                o = o * torch.tensor(wt, dtype=o.dtype, device=o.device)
            out = o if out is None else out + o
        return out

    def _forward(self, sel: np.ndarray) -> torch.Tensor:
        self._sel = sel
        try:
            return _with_override(self._hook, lambda: self.model
                                  .forward_logits(self.params, self.tokens))
        finally:
            self._sel = None

    def logits(self, assignment: Sequence[int]) -> torch.Tensor:
        """The model's logits under one assignment (not counted)."""
        return self._forward(self.sel_matrix(assignment))

    @property
    def n_evals(self) -> int:
        return self._n_evals

    def sel_matrix(self, assignment: Sequence[int]) -> np.ndarray:
        L, T = len(self.modules), len(self.candidates)
        sel = np.zeros((L, T), np.float32)
        for i, t in enumerate(assignment):
            sel[i, t] = 1.0
        return sel

    def nmed_many(self, assignments: Sequence[Sequence[int]],
                  ) -> np.ndarray:
        """Measured model NMED per assignment (list of per-module tier
        indices), one forward each, brought to the host _CHUNK at a
        time."""
        out = []
        for ofs in range(0, len(assignments), _CHUNK):
            vals = []
            for a in assignments[ofs:ofs + _CHUNK]:
                d = self.logits(a).to(torch.float32) - self._ref
                vals.append(d.abs().mean() / self._ref_scale)
            out.append(torch.stack(vals).cpu().numpy())
        self._n_evals += len(assignments)
        if not out:
            return np.zeros((0,), np.float64)
        return np.concatenate(out).astype(np.float64)

    def nmed(self, assignment: Sequence[int]) -> float:
        return float(self.nmed_many([assignment])[0])


# ---------------------------------------------------------------------------
# Stage 2b: learned surrogate — MLP over (tier x module) features
# ---------------------------------------------------------------------------


def _features(c: TierCandidate, m: ModuleStats,
              total_macs: float) -> np.ndarray:
    met = c.metrics
    return np.array([
        math.log10(met.nmed + 1e-12),
        math.log10(met.mred + 1e-12),
        met.mu_rel * 100.0,
        math.log10(met.c0_abs + met.c1_rel + 1e-12),
        math.log10(c.energy_per_mac_j),
        math.log10(m.macs + 1.0),
        m.macs / max(total_macs, 1.0),
        math.log10(m.k),
        math.log10(m.n),
        float(m.calls),
        math.log10(m.absmax_x + 1e-12),
        math.log10(m.absmax_w + 1e-12),
    ], np.float32)


def _mlp_init(gen: torch.Generator, d_in: int, width: int = 32,
              ) -> Dict[str, torch.Tensor]:
    """The reference's initialization (scaled normals, zero biases),
    drawn from `gen` (a CPU generator: the same values on any device)."""
    s = 1.0 / math.sqrt(d_in)
    return {
        "w1": torch.randn((d_in, width), generator=gen) * s,
        "b1": torch.zeros((width,)),
        "w2": torch.randn((width, width), generator=gen) / math.sqrt(width),
        "b2": torch.zeros((width,)),
        "w3": torch.randn((width, 1), generator=gen) / math.sqrt(width),
        "b3": torch.zeros((1,)),
    }


def _mlp_apply(p, x):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    h = torch.tanh(h @ p["w2"] + p["b2"])
    return (h @ p["w3"] + p["b3"])[..., 0]


def _fit_run(Xn: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
             p0: Dict[str, torch.Tensor], steps: int, lr: float,
             ) -> Dict[str, torch.Tensor]:
    """`steps` full-batch Adam steps on the weighted squared error, the
    reference's hand-written update (f32, bias-corrected, eps 1e-8)."""
    names = sorted(p0)
    flat = [p0[k].detach().clone() for k in names]
    m1 = [torch.zeros_like(f) for f in flat]
    m2 = [torch.zeros_like(f) for f in flat]
    step = torch.zeros((), dtype=torch.float32, device=Xn.device)
    denom = torch.clamp_min(w.sum(), 1.0)
    for _ in range(steps):
        leaves = [f.requires_grad_(True) for f in flat]
        with torch.enable_grad():
            r = _mlp_apply(dict(zip(names, leaves)), Xn) - y
            g = torch.autograd.grad(torch.sum(w * r * r) / denom, leaves)
        with torch.no_grad():
            step = step + 1
            m1 = [0.9 * a + 0.1 * gi for a, gi in zip(m1, g)]
            m2 = [0.999 * a + 0.001 * gi * gi for a, gi in zip(m2, g)]
            bc1 = 1.0 - 0.9 ** step
            bc2 = 1.0 - 0.999 ** step
            flat = [f - lr * (a / bc1) / (torch.sqrt(b / bc2) + 1e-8)
                    for f, a, b in zip(flat, m1, m2)]
    return {k: f.detach() for k, f in zip(names, flat)}


@dataclasses.dataclass
class ContributionSurrogate:
    """MLP regressor: (tier, module) features -> log10 per-module NMED
    contribution; exact tiers are pinned to zero contribution."""

    params: Dict
    x_mu: np.ndarray
    x_sd: np.ndarray
    table: np.ndarray        # (L, T) predicted contributions

    @classmethod
    def fit(cls, candidates: Sequence[TierCandidate],
            modules: Sequence[ModuleStats],
            truth: np.ndarray,               # (L, T) measured NMED
            steps: int = 600, lr: float = 3e-3, seed: int = 0,
            init: Optional[Dict] = None, device=None,
            ) -> "ContributionSurrogate":
        """Train on `device` (the card unless ``device="cpu"``) from
        `init` (a dict of arrays, e.g. the reference's initialization)
        or from `_mlp_init` with a torch.Generator seeded by `seed`."""
        from repro_torch.device import resolve_device

        dev = resolve_device(device)
        total = sum(m.macs for m in modules)
        feats, targs, mask = [], [], []
        for i, m in enumerate(modules):
            for t, c in enumerate(candidates):
                feats.append(_features(c, m, total))
                targs.append(math.log10(max(truth[i, t], 1e-12)))
                mask.append(0.0 if c.is_exact else 1.0)
        X = np.stack(feats)
        y = np.array(targs, np.float32)
        w = np.array(mask, np.float32)
        x_mu = X.mean(0)
        x_sd = X.std(0) + 1e-6
        if init is None:
            init = _mlp_init(torch.Generator().manual_seed(seed),
                             X.shape[1])

        def dev_f32(a):
            return torch.as_tensor(np.array(a, np.float32), device=dev)

        Xn = dev_f32((X - x_mu) / x_sd)
        p = _fit_run(Xn, dev_f32(y), dev_f32(w),
                     {k: dev_f32(v) for k, v in init.items()}, steps, lr)
        with torch.no_grad():
            out = _mlp_apply(p, Xn).cpu().numpy()
        pred = 10.0 ** np.asarray(out, np.float64)
        table = (pred * (w > 0)).reshape(len(modules), len(candidates))
        params = {k: v.cpu().numpy() for k, v in p.items()}
        return cls(params=params, x_mu=x_mu, x_sd=x_sd, table=table)


def _combined_risk(table: np.ndarray, assignment: Sequence[int]) -> float:
    """Root-sum-square combiner: independent per-module perturbations
    add in variance, so model NMED ~ alpha * sqrt(sum c_i^2)."""
    s = 0.0
    for i, t in enumerate(assignment):
        s += table[i, t] ** 2
    return math.sqrt(s)


# ---------------------------------------------------------------------------
# Stage 3: constrained search
# ---------------------------------------------------------------------------


def _greedy(table: np.ndarray, energies: np.ndarray, macs: np.ndarray,
            risk_budget: float) -> List[int]:
    """Start all-exact; repeatedly take the move with the best energy
    saving per unit of added risk that still fits the budget."""
    L, T = table.shape
    assign = [0] * L
    risk2 = 0.0
    budget2 = risk_budget ** 2
    while True:
        best, best_score = None, 0.0
        for i in range(L):
            cur = assign[i]
            for t in range(T):
                d_e = (energies[cur] - energies[t]) * macs[i]
                if d_e <= 0.0:
                    continue
                d_r2 = table[i, t] ** 2 - table[i, cur] ** 2
                if risk2 + d_r2 > budget2:
                    continue
                score = d_e / max(d_r2, 1e-30)
                if score > best_score:
                    best, best_score = (i, t, d_r2), score
        if best is None:
            return assign
        i, t, d_r2 = best
        assign[i] = t
        risk2 += d_r2


def _beam(table: np.ndarray, energies: np.ndarray, macs: np.ndarray,
          risk_budget: float, width: int = 8) -> List[List[int]]:
    """Beam over modules (largest MACs first), states scored by
    (energy, risk); infeasible states pruned."""
    L, T = table.shape
    order = sorted(range(L), key=lambda i: -macs[i])
    budget2 = risk_budget ** 2
    # state: (energy, risk2, partial dict)
    states = [(0.0, 0.0, {})]
    for i in order:
        nxt = []
        for e, r2, part in states:
            for t in range(T):
                nr2 = r2 + table[i, t] ** 2
                if nr2 > budget2:
                    continue
                nxt.append((e + macs[i] * energies[t], nr2,
                            {**part, i: t}))
        if not nxt:      # every branch infeasible: force exact here
            nxt = [(e + macs[i] * energies[0], r2, {**part, i: 0})
                   for e, r2, part in states]
        nxt.sort(key=lambda s: (s[0], s[1]))
        states = nxt[:width]
    return [[part[i] for i in range(L)] for _, _, part in states]


def _repair(assign: List[int], table: np.ndarray) -> bool:
    """Demote the highest-contribution non-exact module to exact.
    Returns False when nothing is left to demote."""
    worst, wi = 0.0, -1
    for i, t in enumerate(assign):
        if t != 0 and table[i, t] >= worst:
            worst, wi = table[i, t], i
    if wi < 0:
        return False
    assign[wi] = 0
    return True


# ---------------------------------------------------------------------------
# The result + one-command entry point
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Allocation:
    """An accuracy-budgeted per-module multiplier assignment."""

    tier_map: tuple              # ((module, tier short name), ...)
    alloc: tuple                 # ((prefix, family, compressor, ncols), ...)
    nmed: float                  # measured (exact re-evaluation)
    nmed_predicted: float        # surrogate estimate at the same point
    max_nmed: float
    energy_per_mac_j: float      # MAC-weighted over probed modules
    exact_energy_per_mac_j: float
    mode: str
    bits: int
    modules: tuple               # ModuleStats
    candidates: tuple            # TierCandidate
    evals: int                   # evaluator calls spent

    @property
    def energy_saving(self) -> float:
        return 1.0 - self.energy_per_mac_j / self.exact_energy_per_mac_j

    def to_cim_config(self, **overrides):
        """A ready-to-run CiMConfig carrying this allocation."""
        from .compiler import CiMConfig

        kw = dict(family="appro42", bits=self.bits, mode=self.mode,
                  alloc=self.alloc)
        kw.update(overrides)
        return CiMConfig(**kw)

    def report(self) -> str:
        lines = [f"allocation: NMED {self.nmed:.3e} (budget "
                 f"{self.max_nmed:.3e}), E/MAC "
                 f"{self.energy_per_mac_j*1e12:.3f} pJ "
                 f"({100*self.energy_saving:.1f}% vs exact), "
                 f"{self.evals} exact evals"]
        for name, tier in self.tier_map:
            lines.append(f"  {name:12s} -> {tier}")
        return "\n".join(lines)


def _allocation(ev: MixEvaluator, assign: Sequence[int], nmed: float,
                pred: float, max_nmed: float, evals_start: int,
                ) -> Allocation:
    cands, stats = ev.candidates, ev.modules
    energies = np.array([c.energy_per_mac_j for c in cands])
    macs = np.array([m.macs for m in stats])
    e_alloc = sum(macs[i] * energies[t]
                  for i, t in enumerate(assign)) / float(macs.sum())
    return Allocation(
        tier_map=tuple((m.name, cands[t].short_name())
                       for m, t in zip(stats, assign)),
        alloc=tuple((m.name, cands[t].spec.family, cands[t].spec.compressor,
                     cands[t].spec.n_approx_cols)
                    for m, t in zip(stats, assign)),
        nmed=float(nmed), nmed_predicted=float(pred),
        max_nmed=float(max_nmed), energy_per_mac_j=float(e_alloc),
        exact_energy_per_mac_j=float(energies[0]), mode=ev.mode,
        bits=cands[0].spec.bits, modules=tuple(stats),
        candidates=tuple(cands), evals=ev.n_evals - evals_start)


def make_evaluator(model, *, params=None, tokens=None,
                   candidates: Optional[Sequence[MultiplierSpec]] = None,
                   modules: Optional[Sequence[str]] = None,
                   mode: str = "surrogate", seed: int = 0,
                   mesh=None) -> MixEvaluator:
    """Build the probe + candidate set + mixing evaluator once, for reuse
    across `autoallocate`/`exhaustive_oracle` calls at different budgets.

    model: a `models.transformer.LM` (on its device).  `params` default to
    `model.init(seed)`, `tokens` to a (2, 16) batch drawn from a
    torch.Generator seeded with seed + 1."""
    cfg = model.cfg
    bits = cfg.cim.bits if cfg.cim is not None else 8
    if params is None:
        params = model.init(seed)
    if tokens is None:
        gen = torch.Generator().manual_seed(seed + 1)
        tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    tokens = _tokens(tokens, model.device)
    specs = (list(candidates) if candidates is not None
             else default_candidates(bits))
    cands = build_candidates(specs, mesh=mesh, device=model.device)
    stats = probe_modules(model, params, tokens, modules=modules)
    if not stats:
        raise ValueError("probe found no named matmuls to allocate")
    return MixEvaluator(model, params, tokens, cands, stats, mode=mode)


def autoallocate(model, max_nmed: float, *,
                 params=None, tokens=None,
                 candidates: Optional[Sequence[MultiplierSpec]] = None,
                 modules: Optional[Sequence[str]] = None,
                 mode: str = "surrogate",
                 beam_width: int = 8, topk: int = 8,
                 seed: int = 0, mesh=None,
                 evaluator: Optional[MixEvaluator] = None) -> Allocation:
    """One command: probe -> surrogate -> constrained search -> exact
    re-evaluation.  Returns the cheapest allocation whose MEASURED model
    NMED fits `max_nmed`.

    model: a `models.transformer.LM`.  `params`/`tokens` default as in
    `make_evaluator`.  The candidate tier ladder defaults to
    `default_candidates(bits)` and must include the exact tier.  Pass a
    `make_evaluator` result as `evaluator` to share the probe and the
    characterization across budget sweeps (params, tokens, candidates,
    modules and mode are then taken from it)."""
    if evaluator is not None:
        ev = evaluator
    else:
        ev = make_evaluator(model, params=params, tokens=tokens,
                            candidates=candidates, modules=modules,
                            mode=mode, seed=seed, mesh=mesh)
    cands, stats = ev.candidates, ev.modules
    evals_start = ev.n_evals
    L, T = len(stats), len(cands)

    # ground truth: single-module contributions (L*T evals, one batch)
    singles = []
    for i in range(L):
        for t in range(T):
            a = [0] * L
            a[i] = t
            singles.append(a)
    truth = ev.nmed_many(singles).reshape(L, T)
    _obs("truth", L * T)
    sur = ContributionSurrogate.fit(cands, stats, truth, seed=seed,
                                    device=ev.device)

    # combiner calibration: alpha = measured / rss-predicted on a few
    # random multi-module allocations (CLT makes this ~constant)
    rng = np.random.default_rng(seed)
    calib = [list(rng.integers(0, T, size=L)) for _ in range(8)]
    meas = ev.nmed_many(calib)
    ratios = []
    for a, mv in zip(calib, meas):
        pred = _combined_risk(sur.table, a)
        if pred > 0 and mv > 0:
            ratios.append(mv / pred)
    alpha = float(np.median(ratios)) if ratios else 1.0
    risk_budget = max_nmed / max(alpha, 1e-12)

    energies = np.array([c.energy_per_mac_j for c in cands])
    macs = np.array([m.macs for m in stats])

    # search: greedy + beam, dedup, exact re-eval of the top-K
    props = [_greedy(sur.table, energies, macs, risk_budget)]
    props += _beam(sur.table, energies, macs, risk_budget,
                   width=beam_width)
    seen, uniq = set(), []
    for a in props:
        k2 = tuple(a)
        if k2 not in seen:
            seen.add(k2)
            uniq.append(a)
    uniq.sort(key=lambda a: sum(macs[i] * energies[t]
                                for i, t in enumerate(a)))
    uniq = uniq[:topk]
    _obs("search", len(uniq))

    meas = ev.nmed_many(uniq)
    _obs("reeval", len(uniq))
    feasible = [(a, mv) for a, mv in zip(uniq, meas) if mv <= max_nmed]
    if feasible:
        assign, nmed = min(
            feasible, key=lambda am: sum(
                macs[i] * energies[t] for i, t in enumerate(am[0])))
    else:
        # repair: demote the riskiest modules until the measurement fits
        assign = list(uniq[0])
        nmed = float(meas[0])
        while nmed > max_nmed and _repair(assign, sur.table):
            nmed = ev.nmed(assign)
        if nmed > max_nmed:
            raise ValueError(
                f"even the all-exact allocation measures NMED "
                f"{nmed:.3e} > budget {max_nmed:.3e}")
    pred = alpha * _combined_risk(sur.table, assign)
    return _allocation(ev, assign, nmed, pred, max_nmed, evals_start)


def exhaustive_oracle(model, max_nmed: float, *,
                      params=None, tokens=None,
                      candidates: Optional[Sequence[MultiplierSpec]] = None,
                      modules: Optional[Sequence[str]] = None,
                      mode: str = "surrogate", seed: int = 0,
                      evaluator: Optional[MixEvaluator] = None,
                      ) -> Allocation:
    """Brute-force reference: measure EVERY T^L allocation and return the
    cheapest feasible one.  Only viable for tiny models — the correctness
    oracle `autoallocate` is held against."""
    if evaluator is not None:
        ev = evaluator
    else:
        ev = make_evaluator(model, params=params, tokens=tokens,
                            candidates=candidates, modules=modules,
                            mode=mode, seed=seed)
    cands, stats = ev.candidates, ev.modules
    evals_start = ev.n_evals
    L, T = len(stats), len(cands)
    if T ** L > 70_000:
        raise ValueError(f"{T}^{L} allocations is not exhaustible")
    energies = np.array([c.energy_per_mac_j for c in cands])
    macs = np.array([m.macs for m in stats])
    allocs = []
    for idx in range(T ** L):
        a, r = [], idx
        for _ in range(L):
            a.append(r % T)
            r //= T
        allocs.append(a)
    meas = ev.nmed_many(allocs)
    best, best_e, best_nmed = None, None, None
    for a, mv in zip(allocs, meas):
        if mv > max_nmed:
            continue
        e = sum(macs[i] * energies[t] for i, t in enumerate(a))
        if best_e is None or e < best_e:
            best, best_e, best_nmed = a, e, float(mv)
    if best is None:
        raise ValueError(f"no allocation meets NMED<={max_nmed}")
    return _allocation(ev, best, best_nmed, best_nmed, max_nmed,
                       evals_start)
