"""Per-lane accuracy sentinels: online drift detection and a circuit
breaker for the serving engine (the JAX package's DESIGN.md §14).

The DSE characterization bounds each tier's error at the multiplier
(NMED over the operand distribution); `core/faults.py` models what a
defective die does to that bound.  The sentinel closes the loop at the
logit level: every ``period``-th decode round it shadow-scores the lane's
own state on an exact reference, ``LM.decode_multi`` at width 1 over the
same KV caches, tokens and positions the lane is about to decode (the
spec-decode verifier, serving/spec.py), and keeps rolling argmax-
agreement and logit-NMED statistics over a fixed window.

When the rolling drift leaves the tier's envelope the breaker trips:

    healthy --trip()--> tripped --cooldown--> half_open
       ^                   ^                     |
       |                   +---- probe fails ----+
       +------------------------ probe passes ---+

The engine quarantines a tripped lane (no admission, no decode),
re-enqueues its in-flight requests on the exact lane and, once the
cooldown expires, runs the half-open verification burst: a synthetic
prompt admitted into a free slot, ``probe_rounds`` decode rounds each
shadow-scored, every one required to agree.  Only a clean burst
re-admits the lane.

The port's ``decode_multi`` writes its K/V into the caches it is given,
in place (the reference's jit does not donate, so its score is
read-only): the shadow scores a copy of the lane's K/V, and the lane's
caches stay bitwise as they were.  Everything else here is host-side
numpy.  `LaneSentinel.warmup` runs the scorer once before the engine
arms its plan-miss probe, so trip, probe and recovery build no plan.

On a mesh (a data-parallel pool, serving/engine.py) the reference LM is
built on the lane's mesh: each rank shadow-scores its own slots on a copy
of its own K/V, and a sample's agreement count, NMED sum and slot count
are summed over the data axes before any threshold is applied, so every
rank takes the same trip, probe and recovery on the same round (its
scheduler replicated, a decision of one rank alone would leave the
others waiting in a collective).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch


class LaneHealthError(RuntimeError):
    """A lane produced numerically invalid output (non-finite logits).

    Raised by the sampling path instead of emitting argmax-of-garbage;
    the engine treats it as an immediate trip on sentinel-guarded lanes
    and re-raises it elsewhere."""


# ---------------------------------------------------------------------------
# Configuration and rolling statistics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    """Drift-detection policy for one lane.

    The NMED trip threshold is ``max(nmed_floor, nmed_factor *
    envelope)``, ``envelope`` the tier's characterized multiplier NMED:
    logit error accumulates over K-deep dot products, so the factor maps
    the per-MAC bound to an end-to-end allowance, and the floor keeps
    near-exact tiers (envelope ~ 0) from tripping on quantization dust."""

    period: int = 2          # shadow-score every Nth decode round
    window: int = 4          # rolling window (shadow samples)
    min_samples: int = 2     # no trip before this many samples
    min_agree: float = 0.3   # rolling argmax agreement floor (the log
    #                          tiers flip argmaxes on near ties; NMED is
    #                          the primary signal)
    nmed_factor: float = 10.0
    nmed_floor: float = 0.25
    cooldown_s: float = 0.1  # quarantine time before the half-open probe
    #                          (0 would re-probe a still-faulty lane on
    #                          every scheduler tick)
    probe_rounds: int = 4    # verification-burst length

    def __post_init__(self):
        if self.period < 1:
            raise ValueError("period must be >= 1")
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if self.probe_rounds < 1:
            raise ValueError("probe_rounds must be >= 1")
        if not 0.0 <= self.min_agree <= 1.0:
            raise ValueError("min_agree must be in [0, 1]")

    def nmed_threshold(self, envelope: float) -> float:
        return max(self.nmed_floor, self.nmed_factor * envelope)


class RollingStats:
    """Fixed-window mean of (argmax agreement, logit NMED) samples."""

    def __init__(self, window: int):
        self._agree: deque = deque(maxlen=window)
        self._nmed: deque = deque(maxlen=window)

    def push(self, agree: float, nmed: float) -> None:
        self._agree.append(float(agree))
        self._nmed.append(float(nmed))

    def reset(self) -> None:
        self._agree.clear()
        self._nmed.clear()

    @property
    def n(self) -> int:
        return len(self._agree)

    @property
    def agree(self) -> float:
        return float(np.mean(self._agree)) if self._agree else 1.0

    @property
    def nmed(self) -> float:
        return float(np.mean(self._nmed)) if self._nmed else 0.0


def _row_drift(a: np.ndarray, e: np.ndarray):
    """Per row: argmax agreement (0/1) and the NMED of lane row `a`
    against reference row `e` (float64)."""
    agree = a.argmax(axis=-1) == e.argmax(axis=-1)
    denom = np.abs(e).mean(axis=-1) + 1e-12
    return agree, np.abs(a - e).mean(axis=-1) / denom


def logit_drift(lane_logits: np.ndarray, ref_logits: np.ndarray,
                slots) -> Tuple[float, float]:
    """(argmax agreement, normalized mean logit error) over the live
    slots.  NMED normalizes each row by the reference's mean magnitude,
    so the statistic is scale-free like the multiplier-level NMED it is
    compared against."""
    idx = np.asarray(list(slots), np.int64)
    agree, nmed = _row_drift(np.asarray(lane_logits, np.float64)[idx],
                             np.asarray(ref_logits, np.float64)[idx])
    return float(agree.mean()), float(nmed.mean())


def mesh_logit_drift(lane_logits: np.ndarray, ref_rows: np.ndarray,
                     slots, slot0: int, mesh, axes) -> Tuple[float, float]:
    """`logit_drift` on a data-parallel pool: `lane_logits` the whole
    pool's (every rank holds them), `ref_rows` the reference rows of this
    rank's slots ``[slot0, slot0 + len(ref_rows))``.  Each rank sums the
    agreements and NMEDs of the live slots it owns; the sums and the
    count are added over `axes`, so every rank returns the same pair."""
    n = len(ref_rows)
    own = np.asarray([s for s in slots if slot0 <= s < slot0 + n], np.int64)
    agree, nmed = _row_drift(np.asarray(lane_logits, np.float64)[own],
                             np.asarray(ref_rows, np.float64)[own - slot0])
    t = torch.tensor([float(agree.sum()), float(nmed.sum()), float(len(own))],
                     dtype=torch.float64)
    a_sum, n_sum, count = mesh.all_reduce(t, "sum", axes).tolist()
    return a_sum / count, n_sum / count


# ---------------------------------------------------------------------------
# Breaker state machine
# ---------------------------------------------------------------------------

HEALTHY = "healthy"
TRIPPED = "tripped"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """healthy -> tripped -> half_open -> healthy | tripped."""

    def __init__(self, cooldown_s: float = 0.0):
        self.cooldown_s = float(cooldown_s)
        self.state = HEALTHY
        self.tripped_at: Optional[float] = None
        self.n_trips = 0
        self.n_recoveries = 0

    def trip(self, now: float) -> None:
        self.state = TRIPPED
        self.tripped_at = now
        self.n_trips += 1

    def should_probe(self, now: float) -> bool:
        return (self.state == TRIPPED
                and now - self.tripped_at >= self.cooldown_s)

    def probe_started(self) -> None:
        if self.state != TRIPPED:
            raise RuntimeError(f"cannot probe from state {self.state!r}")
        self.state = HALF_OPEN

    def probe_passed(self) -> None:
        self.state = HEALTHY
        self.tripped_at = None
        self.n_recoveries += 1

    def probe_failed(self, now: float) -> None:
        self.state = TRIPPED
        self.tripped_at = now


# ---------------------------------------------------------------------------
# The lane sentinel
# ---------------------------------------------------------------------------


def _copy_kv(caches):
    """The caches with every layer's K and V copied (pos shared: the
    decode replaces it, never writes into it)."""
    return {**caches,
            "layers": [{**layer, "k": layer["k"].clone(),
                        "v": layer["v"].clone()}
                       for layer in caches["layers"]]}


class LaneSentinel:
    """Shadow-scoring drift detector and breaker for one approximate lane.

    `lm` is the exact reference model (the spec-decode verifier's config:
    exact family, ``per_token=True``, so the width-1 scoring is the
    sequential exact decode's) over the lane's weights `params` (on a
    mesh: built on the lane's mesh, over the rank's shards);
    `envelope` is the lane tier's characterized NMED.

    Engine protocol, per decode round on a live lane:

      1. ``due()``            — count the round; True every period-th
      2. ``shadow(backend)``  — exact logits for the lane's *current*
                                state, before the lane's own decode
                                (which advances its caches)
      3. ``observe(...)``     — push drift stats, True on a trip

    Quarantine protocol: ``breaker.should_probe(now)`` then
    ``probe(backend, slot, now)``, the half-open verification burst."""

    def __init__(self, lm, params, envelope: float,
                 cfg: Optional[SentinelConfig] = None):
        self.lm, self.params = lm, params
        self.envelope = float(envelope)
        self.cfg = cfg or SentinelConfig()
        self.stats = RollingStats(self.cfg.window)
        self.breaker = CircuitBreaker(self.cfg.cooldown_s)
        self._round = 0
        self._slot0 = 0               # the first slot of the last shadow
        self.rounds_since_reset = 0
        self.n_checks = 0
        self.last_detection_rounds: Optional[int] = None
        self.last_trip_reason: Optional[str] = None
        # the most recent drift sample, and the rolling stats at the trip
        # (before the post-trip reset clears them)
        self.last_agree: Optional[float] = None
        self.last_nmed: Optional[float] = None
        self.last_trip_stats: Optional[Tuple[float, float]] = None

    # -- shadow scoring ----------------------------------------------------
    def shadow(self, backend) -> np.ndarray:
        """Exact next-token logits (B, V) f32 for the lane's current
        state (on a mesh: of this rank's slots, the backend's
        ``[slot0, slot0 + n_local)``).  ``decode_multi`` writes its K/V
        in place, so it scores a copy of the lane's K/V:
        ``backend.caches`` is left bitwise as it was (its fill levels
        too: the decode replaces ``pos``)."""
        dev = backend.device
        mine = slice(backend.slot0, backend.slot0 + backend.n_local)
        self._slot0 = backend.slot0
        tok = torch.as_tensor(backend.slot_tokens[mine, None], device=dev)
        pos = torch.as_tensor(backend.slot_pos[mine].astype(np.int32),
                              device=dev)
        with torch.inference_mode():
            logits, _ = self.lm.decode_multi(
                self.params, _copy_kv(backend.caches), tok, pos,
                data_parallel=backend.mesh is not None)
            return logits[:, 0, :].to(torch.float32).cpu().numpy()

    def _drift(self, lane_logits, ref_logits, slots) -> Tuple[float, float]:
        """`logit_drift` of the lane's logits against the last `shadow`'s
        over the live `slots`, the same on every rank of a mesh."""
        mesh = getattr(self.lm, "mesh", None)
        if mesh is None:
            return logit_drift(lane_logits, ref_logits, slots)
        return mesh_logit_drift(lane_logits, ref_logits, slots, self._slot0,
                                mesh, self.lm.row_axes)

    # -- the observation protocol ------------------------------------------
    def due(self) -> bool:
        self._round += 1
        self.rounds_since_reset += 1
        return self._round % self.cfg.period == 0

    def observe(self, lane_logits, ref_logits, slots, now: float) -> bool:
        """Push one drift sample; True if the lane just tripped."""
        self.n_checks += 1
        lane = np.asarray(lane_logits)
        if not np.isfinite(lane).all():
            self._trip(now, "non-finite lane logits")
            return True
        agree, nmed = self._drift(lane, ref_logits, slots)
        self.last_agree, self.last_nmed = agree, nmed
        self.stats.push(agree, nmed)
        if self.stats.n < self.cfg.min_samples:
            return False
        thresh = self.cfg.nmed_threshold(self.envelope)
        if self.stats.agree < self.cfg.min_agree:
            self._trip(now, f"argmax agreement {self.stats.agree:.3f} < "
                            f"{self.cfg.min_agree:.3f}")
            return True
        if self.stats.nmed > thresh:
            self._trip(now, f"logit NMED {self.stats.nmed:.3g} > "
                            f"{thresh:.3g}")
            return True
        return False

    def record_failure(self, now: float, reason: str) -> None:
        """Immediate trip on a diagnostic failure (LaneHealthError)."""
        self._trip(now, reason)

    def _trip(self, now: float, reason: str) -> None:
        self.last_trip_reason = reason
        self.last_trip_stats = (self.stats.agree, self.stats.nmed)
        self.last_detection_rounds = self.rounds_since_reset
        self.breaker.trip(now)
        self._reset()

    def _reset(self) -> None:
        self.stats.reset()
        self._round = 0
        self.rounds_since_reset = 0

    @property
    def tripped(self) -> bool:
        return self.breaker.state != HEALTHY

    # -- half-open verification burst --------------------------------------
    def probe(self, backend, slot: int, now: float) -> bool:
        """Admit a synthetic prompt into `slot` and shadow-score
        ``probe_rounds`` decode rounds; every round must agree (argmax
        equal, NMED within the envelope) for the lane to be re-admitted.
        Only warmed shapes run: the smallest (1, prompt-bucket) prefill
        and the pool decode; the probe slot is free afterwards, and the
        next admission overwrites its rows."""
        self.breaker.probe_started()
        plen = min(backend.prompt_buckets)
        vocab = backend.lm.cfg.vocab
        prompt = np.arange(1, plen + 1, dtype=np.int64) % vocab
        thresh = self.cfg.nmed_threshold(self.envelope)
        ok = True
        try:
            backend.admit([prompt], [slot])
            for _ in range(self.cfg.probe_rounds):
                ref = self.shadow(backend)
                backend.decode_round()
                agree, nmed = self._drift(backend.last_decode_logits, ref,
                                         [slot])
                if agree < 1.0 or nmed > thresh:
                    ok = False
                    break
        except LaneHealthError:
            ok = False
        if ok:
            self.breaker.probe_passed()
        else:
            self.breaker.probe_failed(now)
        self._reset()
        return ok

    # -- warmup ------------------------------------------------------------
    def warmup(self, backend) -> int:
        """Run the shadow scorer at the lane's pool shape, so the first
        real score and the probe build no plan.  Runs before the engine
        arms its plan-miss probe."""
        self.shadow(backend)
        return 1


def reference_lm(cfg, exact_cim, device=None, mesh=None):
    """The sentinel's exact reference model over shared weights: the
    ladder's exact rung with per-token activation scales, the
    spec-decode verifier's construction (tiers.spec_pair); on the lanes'
    `mesh`, if they have one."""
    from repro_torch.models.transformer import LM

    ref = dataclasses.replace(exact_cim, per_token=True)
    return LM(dataclasses.replace(cfg, cim=ref), device, mesh=mesh)
