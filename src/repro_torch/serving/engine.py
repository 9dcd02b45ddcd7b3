"""Continuous-batching serving engine over the CiM dispatch stack.

Three cooperating pieces:

  * **Slot pool** — per accuracy tier, a fixed-batch KV-cache pool
    (``LM.init_caches(per_slot=True)``): every batch row is an
    independent sequence with its own (B,) fill level.  New requests
    *prefill into slots* of a running batch (a batched ragged prefill,
    then a copy of the group caches into the pool rows) and finished
    ones are evicted in place — decode never stops, restarts, or changes
    shape.

  * **Scheduler** — FIFO arrival queues per tier, token-budget
    admission (a request reserves ``prompt_len + max_new`` tokens until
    eviction; the queue head blocks rather than being skipped, so no
    request starves), slot assignment, and eviction on EOS/max-gen.

  * **Tier lanes** — one slot pool per accuracy tier over the *shared*
    weights.  Prompt lengths and admission group sizes are bucketed to
    pre-warmed sets and the decode batch is always the full pool, so
    `warmup()` touches every GEMM shape the lane will run, and
    `steady_plan_misses()` (the dispatch engine's plan-cache misses
    since warmup) must stay 0 afterwards.

With a mesh (``build_engine(mesh=...)``, launch.mesh) every rank of a
("data", "model") process mesh runs the same engine: the weights are
tensor-parallel over "model", each lane's slot pool is data-parallel
(each data rank owns a contiguous block of ``n_slots / data`` slots and
their caches), prefill groups run replicated on every data rank (each
inserts only the rows of the slots it owns), and a decode round runs the
local slots and hands every rank the whole pool's logits, so the
replicated scheduler makes the same decisions everywhere.  With an
integer-mode or `surrogate` ladder the approximate lanes' logits equal
the unsharded engine's bit for bit (the float lanes' are allclose).  A
spec lane and the sentinels run on the mesh too (serving/spec.py,
serving/sentinel.py): each rank drafts, verifies and shadow-scores its
own slots, and what steers the scheduler (the spec call's counts, a
sentinel sample) is exchanged over the data axes first.  Faults do not
compose with a mesh.

`build_engine(spec_decode=k)` makes the exact lane speculative
(serving/spec.py): a cheaper tier drafts k tokens a round and the exact
rung with per-token activation scales verifies them in one pass; the
output is the per-token exact lane's.

`build_engine(fault=..., sentinel=True)` serves an as-fabricated ladder
(core/faults.py: stuck-at defects in every approximate tier's stored
tables and weight words, never the exact tier's) with a sentinel on each
approximate lane (serving/sentinel.py).  A lane whose drift leaves its
envelope trips before its round's tokens are emitted: it is quarantined,
its queued requests re-route, its in-flight ones restart from their
prompts on the safest healthy lane (within `retry_budget` restarts each,
then "failed"), and a half-open probe re-admits it once it verifies
clean.

`build_engine(telemetry=EngineTelemetry())` (obs/) records the serving
telemetry: per-request lifecycle spans (queue, prefill, decode, retry)
and per-lane round spans on the run's clock, token, request, trip and
breaker counters, sentinel drift gauges, and each lane's estimated
energy per token from MAC profiles its warmup takes.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .sentinel import LaneHealthError


class AdmissionRejected(RuntimeError):
    """Structured backpressure signal: the admission queue is full."""

    def __init__(self, rid: int, queued: int, limit: int):
        super().__init__(
            f"request {rid} rejected: {queued} requests queued >= "
            f"admission limit {limit}")
        self.rid, self.queued, self.limit = rid, queued, limit


@dataclasses.dataclass
class Request:
    """One inference request.  `tier` pins an SLA class by name;
    otherwise `tolerance` (max NMED) is routed through the TierRouter.
    `arrival` is seconds on the engine clock (workload time)."""

    rid: int
    prompt: np.ndarray
    max_new: int
    tolerance: Optional[float] = None
    tier: Optional[str] = None
    arrival: float = 0.0
    eos_id: Optional[int] = None

    @property
    def cost(self) -> int:
        """Token-budget reservation: worst-case KV footprint."""
        return len(self.prompt) + self.max_new


@dataclasses.dataclass
class RequestResult:
    rid: int
    tier: str
    prompt_len: int
    arrival: float
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    logits: Optional[List[np.ndarray]] = None   # record_logits engines
    retries: int = 0         # restarts after a sentinel trip
    status: str = "ok"       # "ok" | "failed" (retry budget exhausted)

    @property
    def done(self) -> bool:
        return self.t_done is not None

    @property
    def ms_per_token(self) -> float:
        """End-to-end per-token latency (queueing included)."""
        return 1e3 * (self.t_done - self.arrival) / max(len(self.tokens), 1)


@dataclasses.dataclass
class EngineStats:
    n_requests: int
    total_tokens: int
    duration_s: float
    tokens_per_s: float
    p50_ms_per_token: float
    p95_ms_per_token: float
    p50_ttft_ms: float
    p95_ttft_ms: float
    n_failed: int = 0        # retry budget exhausted

    @classmethod
    def from_results(cls, results: Dict[int, "RequestResult"],
                     duration_s: float) -> "EngineStats":
        """Goodput: only requests that finished "ok" count."""
        n_failed = sum(1 for r in results.values()
                       if r.done and r.status != "ok")
        done = [r for r in results.values() if r.done and r.status == "ok"]
        tot = sum(len(r.tokens) for r in done)
        lat = np.asarray([r.ms_per_token for r in done]) if done else \
            np.zeros(1)
        ttft = np.asarray([1e3 * (r.t_first - r.arrival) for r in done]) \
            if done else np.zeros(1)
        return cls(n_requests=len(done), total_tokens=tot,
                   duration_s=duration_s,
                   tokens_per_s=tot / max(duration_s, 1e-9),
                   p50_ms_per_token=float(np.percentile(lat, 50)),
                   p95_ms_per_token=float(np.percentile(lat, 95)),
                   p50_ttft_ms=float(np.percentile(ttft, 50)),
                   p95_ttft_ms=float(np.percentile(ttft, 95)),
                   n_failed=n_failed)


@dataclasses.dataclass
class TripEvent:
    """One sentinel trip: engine-clock time, the tripped lane, the
    reason, the tokens the lane emitted since its last trip or recovery
    (the detection latency), the in-flight requests it displaced, the
    sentinel's rolling (agreement, NMED) at detection (None on a lane
    without a sentinel) and the breaker state on either side.  Dict-style
    access (``ev["lane"]``, ``ev.get(...)``) reads the fields."""

    lane: str
    t: float
    reason: str
    tokens_before_trip: int
    in_flight_displaced: int
    trigger_agree: Optional[float] = None
    trigger_nmed: Optional[float] = None
    breaker_before: str = "healthy"
    breaker_after: str = "tripped"

    def __getitem__(self, key: str):
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def get(self, key: str, default=None):
        return getattr(self, key, default)

    def keys(self):
        return [f.name for f in dataclasses.fields(self)]


def _bucket_up(v: int, buckets: Sequence[int], what: str) -> int:
    for b in buckets:
        if b >= v:
            return b
    raise ValueError(f"{what} {v} exceeds the largest configured bucket "
                     f"{max(buckets)}")


def check_engine_arch(cfg) -> None:
    """Continuous batching needs every layer's state to be a positional
    KV cache: dense full-attention stacks only."""
    from repro_torch.models import config as C

    kinds = set(cfg.prefix_layers) | set(cfg.period)
    if (cfg.mla is not None or cfg.vision is not None
            or cfg.encoder is not None or not kinds <= {C.ATTN}):
        raise ValueError(
            f"arch {cfg.name!r} is not servable by the slot-pool engine "
            f"(layer kinds {sorted(kinds)}); dense full-attention stacks "
            "only")


def servable_archs(smoke: bool = True) -> List[str]:
    """Registry archs the slot-pool engine can serve."""
    from repro_torch.configs import arch_names, get_config

    out = []
    for name in arch_names():
        try:
            check_engine_arch(get_config(name, smoke=smoke))
        except ValueError:
            continue
        out.append(name)
    return out


# ---------------------------------------------------------------------------
# The LM lane backend: one slot pool on one CiM tier
# ---------------------------------------------------------------------------


class LMLaneBackend:
    """Slot-pool execution for one (LM, CiM tier): ragged group prefill,
    cache insert, and full-pool decode, on the LM's device.

    With `mesh` (the LM's, which must be built on it, with `params` this
    rank's shards) the pool is data-parallel: this rank owns the slots
    ``[slot0, slot0 + n_local)`` and holds only their caches."""

    def __init__(self, lm, params, *, n_slots: int, max_len: int,
                 prompt_buckets: Sequence[int] = (16, 32),
                 group_buckets: Sequence[int] = (1, 2, 4), mesh=None):
        check_engine_arch(lm.cfg)
        if mesh is not lm.mesh:
            raise ValueError("the lane's mesh must be its LM's")
        self.lm, self.params = lm, params
        self.mesh = mesh
        self.device = lm.device
        self.n_slots, self.max_len = int(n_slots), int(max_len)
        self.prompt_buckets = tuple(sorted(set(int(p) for p in
                                               prompt_buckets)))
        self.group_buckets = tuple(sorted(set(int(g) for g in
                                              group_buckets)))
        if max(self.prompt_buckets) > self.max_len:
            raise ValueError("prompt bucket exceeds max_len")
        self.n_local, self.slot0 = self.n_slots, 0
        if mesh is not None:
            n_data = mesh.axes_size(lm.row_axes)
            if self.n_slots % n_data:
                raise ValueError(f"{self.n_slots} slots do not split over "
                                 f"the {n_data} data ranks")
            self.n_local = self.n_slots // n_data
            self.slot0 = mesh.index(lm.row_axes) * self.n_local
        self.caches = lm.init_caches(self.n_local, self.max_len,
                                     per_slot=True)
        self.slot_tokens = np.zeros(self.n_slots, np.int64)
        self.slot_pos = np.zeros(self.n_slots, np.int64)
        self.last_prefill_logits: Optional[np.ndarray] = None
        self.last_decode_logits: Optional[np.ndarray] = None

    # -- shape vocabulary --------------------------------------------------
    def prompt_bucket(self, plen: int) -> int:
        return _bucket_up(plen, self.prompt_buckets, "prompt length")

    @property
    def max_group(self) -> int:
        return max(self.group_buckets)

    # -- execution ---------------------------------------------------------
    def _greedy(self, logits) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side greedy sampling; non-finite logits raise
        `LaneHealthError` instead of emitting argmax-of-garbage."""
        lg = logits[:, -1, :].to(torch.float32).cpu().numpy()
        if not np.isfinite(lg).all():
            bad = int((~np.isfinite(lg)).sum())
            raise LaneHealthError(
                f"lane produced non-finite logits ({bad}/{lg.size} "
                "entries NaN/inf)")
        return np.argmax(lg, axis=-1), lg

    def _insert(self, grp, rows: List[int], slots: List[int]) -> None:
        """Copy group-cache rows into the pool rows named by `slots`."""
        if not rows:
            return
        src = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        dst = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
        for pool, g in zip(self.caches["layers"], grp["layers"]):
            for name in ("k", "v", "pos"):
                pool[name][dst] = g[name][src].to(pool[name].dtype)

    def admit(self, prompts: List[np.ndarray],
              slots: List[int]) -> np.ndarray:
        """Ragged group prefill into the named pool slots; returns the
        first sampled (greedy) token per prompt."""
        g = len(prompts)
        p_bkt = self.prompt_bucket(max(len(p) for p in prompts))
        g_bkt = _bucket_up(g, self.group_buckets, "admission group")
        toks = np.zeros((g_bkt, p_bkt), np.int64)
        lens = np.ones(g_bkt, np.int32)       # padding rows: 1-token stubs
        for i, pr in enumerate(prompts):
            toks[i, :len(pr)] = pr
            lens[i] = len(pr)
        # this rank's slots (all of them without a mesh): the group runs
        # whole on every data rank, each keeping the rows it owns
        own = [(i, sl - self.slot0) for i, sl in enumerate(slots)
               if self.slot0 <= sl < self.slot0 + self.n_local]
        with torch.inference_mode():
            logits, grp = self.lm.prefill(self.params, {
                "tokens": torch.as_tensor(toks, device=self.device),
                "lengths": torch.as_tensor(lens, device=self.device),
                "max_len": self.max_len})
            self._insert(grp, [i for i, _ in own], [j for _, j in own])
        first, lg = self._greedy(logits)
        self.last_prefill_logits = lg[:g]
        for i, sl in enumerate(slots):
            self.slot_tokens[sl] = first[i]
            self.slot_pos[sl] = lens[i]
        return first[:g]

    def decode_round(self) -> np.ndarray:
        """One greedy decode step for the whole pool (idle slots ride
        along masked by their own fill level; their output is ignored).
        On a mesh this rank runs its own slots and gets every slot's
        logits back."""
        mine = slice(self.slot0, self.slot0 + self.n_local)
        tok = torch.as_tensor(self.slot_tokens[mine, None],
                              device=self.device)
        pos = torch.as_tensor(self.slot_pos[mine].astype(np.int32),
                              device=self.device)
        with torch.inference_mode():
            logits, self.caches = self.lm.decode_step(
                self.params, self.caches, tok, pos,
                data_parallel=self.mesh is not None)
        nxt, lg = self._greedy(logits)
        self.slot_tokens = nxt.astype(np.int64)
        self.slot_pos += 1
        self.last_decode_logits = lg
        return nxt

    def reset(self) -> None:
        """Return every slot to the state a fresh pool starts in: token 0
        at position 0 in the scheduler's view, zero fill levels AND zero
        K/V rows.  Idle slots ride along in each decode round and enter
        the per-tensor activation scale; with CiM attention an idle
        slot's attention also reads its stale rows past the fill level
        (the per-head scales span the whole cache, as in the reference),
        so a pool reused from an earlier workload must clear both to
        serve a workload exactly as a fresh pool would."""
        self.slot_tokens[:] = 0
        self.slot_pos[:] = 0
        with torch.inference_mode():
            for layer in self.caches["layers"]:
                for name in ("k", "v", "pos"):
                    layer[name].zero_()

    def warmup(self) -> int:
        """Run every steady-state shape once: each (G, P) prefill (its
        rows dropped, never inserted) and the pool decode, so each GEMM
        plan exists before traffic; then `reset()`."""
        n = 0
        for p_bkt in self.prompt_buckets:
            for g_bkt in self.group_buckets:
                toks = torch.zeros((g_bkt, p_bkt), dtype=torch.int64,
                                   device=self.device)
                lens = torch.full((g_bkt,), p_bkt, dtype=torch.int32,
                                  device=self.device)
                with torch.inference_mode():
                    logits, _ = self.lm.prefill(self.params, {
                        "tokens": toks, "lengths": lens,
                        "max_len": self.max_len})
                self._greedy(logits)
                n += 1
        self.decode_round()
        self.reset()
        return n + 1


# ---------------------------------------------------------------------------
# Scheduler + engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Running:
    req: Request
    result: RequestResult


class _Lane:
    def __init__(self, name: str, backend):
        self.name = name
        self.backend = backend
        self.queue: deque = deque()
        self.free: List[int] = list(range(backend.n_slots))
        self.running: Dict[int, _Running] = {}
        self.sentinel = None          # LaneSentinel (serving/sentinel.py)
        self.quarantined = False      # breaker open: no admit, no decode
        self.emitted = 0              # tokens since the last trip/recovery
        self.total_emitted = 0        # tokens ever (never reset)
        self.n_retries = 0            # restarts this lane's trips caused


class ServingEngine:
    """Continuous-batching scheduler over per-tier slot-pool lanes.

    `lanes` maps tier name -> backend (LMLaneBackend in production; the
    tests drive the scheduler with a fake backend).  `continuous=False`
    degrades admission to static batching — a lane only admits when it
    is fully drained (the lockstep baseline); everything else is shared.
    `sentinels` maps a lane name to its LaneSentinel; `retry_budget`
    bounds the restarts of one request after trips, `retry_backoff_s`
    delays the n-th restart by ``retry_backoff_s * 2^(n-1)``.
    `telemetry` (an `obs.EngineTelemetry`) hears the scheduler's events.
    """

    def __init__(self, lanes: Dict[str, object], router, *,
                 continuous: bool = True,
                 token_budget: Optional[int] = None,
                 record_logits: bool = False,
                 check_invariants: bool = False,
                 max_queued: Optional[int] = None,
                 sentinels: Optional[Dict[str, object]] = None,
                 retry_budget: int = 3,
                 retry_backoff_s: float = 0.0,
                 telemetry=None):
        if not lanes:
            raise ValueError("need at least one lane")
        self.lanes = {name: _Lane(name, b) for name, b in lanes.items()}
        self.router = router
        self.continuous = continuous
        self.token_budget = token_budget
        self.record_logits = record_logits
        self.check_invariants = check_invariants
        self.max_queued = max_queued
        self.retry_budget = int(retry_budget)
        self.retry_backoff_s = float(retry_backoff_s)
        for name, sen in (sentinels or {}).items():
            self.lanes[name].sentinel = sen
        self.telemetry = telemetry               # obs.EngineTelemetry
        self.results: Dict[int, RequestResult] = {}
        self.active_tokens = 0
        self.peak_running = 0
        self.trip_log: List[TripEvent] = []      # one entry per trip
        self.last_run_s: Optional[float] = None  # engine-clock duration
        self._deferred: List[Tuple[float, Request]] = []   # backoff queue
        self._expected: Dict[str, int] = {}
        self._plan_mark: Optional[int] = None
        self._clock = None                       # set by run()

    # -- warmup / plan-miss probe ------------------------------------------
    def warmup(self) -> int:
        """Run every (tier x bucket) shape once, and each sentinel's
        shadow scorer; with telemetry, profile each lane's MACs; reset
        the pools; then arm the plan-miss probe (so trip, probe and
        recovery build no plan)."""
        n = sum(lane.backend.warmup() for lane in self.lanes.values()
                if hasattr(lane.backend, "warmup"))
        n += sum(lane.sentinel.warmup(lane.backend)
                 for lane in self.lanes.values()
                 if lane.sentinel is not None)
        if self.telemetry is not None:
            # the profiled decodes write K/V into the pools: the resets
            # below return them to a fresh pool's state
            self.telemetry.on_warmup(self)
        for lane in self.lanes.values():
            if hasattr(lane.backend, "reset"):
                lane.backend.reset()
        from repro_torch.core.approx_gemm import plan_misses

        self._plan_mark = plan_misses()
        return n

    def steady_plan_misses(self) -> int:
        """Dispatch-engine plan-cache misses since warmup(); 0 in steady
        state."""
        if self._plan_mark is None:
            raise RuntimeError("call warmup() first")
        from repro_torch.core.approx_gemm import plan_misses

        return plan_misses() - self._plan_mark

    # -- submission --------------------------------------------------------
    def _route_name(self, req: Request) -> str:
        """Route around quarantined lanes: they go to the router as
        `avoid`, so a pinned request demotes to the next feasible rung
        (quarantine arises only on sentinel-guarded lanes, which
        build_engine pairs with a TierRouter)."""
        avoid = {n for n, lane in self.lanes.items() if lane.quarantined}
        if avoid:
            tier = self.router.route(req.tolerance, req.tier, avoid=avoid)
        else:
            tier = self.router.route(req.tolerance, req.tier)
        return tier.name if hasattr(tier, "name") else str(tier)

    def submit(self, req: Request) -> str:
        """Route + enqueue; returns the tier name it was routed to.  A
        rid may be reused only after its previous request completed.
        With `max_queued` set, submission is bounded (AdmissionRejected)."""
        prev = self.results.get(req.rid)
        if prev is not None and not prev.done:
            raise ValueError(
                f"request id {req.rid} is already queued or running")
        if self.max_queued is not None:
            queued = (sum(len(l.queue) for l in self.lanes.values())
                      + len(self._deferred))
            if queued >= self.max_queued:
                raise AdmissionRejected(req.rid, queued, self.max_queued)
        name = self._route_name(req)
        lane = self.lanes[name]
        b = lane.backend
        if hasattr(b, "max_len") and req.cost > b.max_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new = {req.cost} exceeds "
                f"lane max_len {b.max_len}")
        if hasattr(b, "prompt_bucket"):
            b.prompt_bucket(len(req.prompt))    # raises if unbucketable
        if self.token_budget is not None and req.cost > self.token_budget:
            raise ValueError(
                f"request {req.rid}: cost {req.cost} exceeds the engine "
                f"token budget {self.token_budget}")
        lane.queue.append(req)
        if self._expected.get(name, 0) > 0:
            self._expected[name] -= 1
        self.results[req.rid] = RequestResult(
            rid=req.rid, tier=name, prompt_len=len(req.prompt),
            arrival=req.arrival,
            logits=[] if self.record_logits else None)
        return name

    # -- scheduling --------------------------------------------------------
    def _budget_ok(self, req: Request) -> bool:
        return (self.token_budget is None
                or self.active_tokens + req.cost <= self.token_budget)

    def _admit_lane(self, lane: _Lane, now: float) -> None:
        if not lane.queue or not lane.free:
            return
        if not self.continuous:
            # static batching: wait for a full drain, then (if more
            # traffic for this tier is still inbound) a full batch
            if lane.running:
                return
            if (len(lane.queue) < lane.backend.n_slots
                    and self._expected.get(lane.name, 0) > 0):
                return
        taken: List[Tuple[Request, int]] = []
        while lane.queue and lane.free:
            req = lane.queue[0]
            if not self._budget_ok(req):
                break                  # FIFO head blocks: no starvation
            lane.queue.popleft()
            slot = lane.free.pop(0)
            self.active_tokens += req.cost
            taken.append((req, slot))
        if not taken:
            return
        for req, slot in taken:
            rr = self.results[req.rid]
            rr.t_admit = now
            lane.running[slot] = _Running(req, rr)
        # group by prompt bucket (one shape per admit call), chunked to
        # the largest pre-warmed group bucket
        groups: Dict[int, List[Tuple[Request, int]]] = {}
        for req, slot in taken:
            pb = (lane.backend.prompt_bucket(len(req.prompt))
                  if hasattr(lane.backend, "prompt_bucket")
                  else len(req.prompt))
            groups.setdefault(pb, []).append((req, slot))
        max_g = getattr(lane.backend, "max_group", lane.backend.n_slots)
        for pb, members in groups.items():
            for i in range(0, len(members), max_g):
                chunk = members[i:i + max_g]
                first = lane.backend.admit([r.prompt for r, _ in chunk],
                                           [s for _, s in chunk])
                if self.telemetry is not None:
                    self.telemetry.on_prefill(
                        lane.name, len(chunk), pb,
                        [r.rid for r, _ in chunk], now)
                pre_lg = getattr(lane.backend, "last_prefill_logits",
                                 None)
                for j, (req, slot) in enumerate(chunk):
                    lg = (pre_lg[j] if self.record_logits
                          and pre_lg is not None else None)
                    self._emit(lane, slot, int(first[j]), now, lg)
        self.peak_running = max(self.peak_running,
                                sum(len(l.running) for l in
                                    self.lanes.values()))

    def _emit(self, lane: _Lane, slot: int, tok: int, now: float,
              logits_row=None) -> None:
        run = lane.running[slot]
        rr = run.result
        rr.tokens.append(tok)
        lane.emitted += 1
        lane.total_emitted += 1
        if self.telemetry is not None:
            self.telemetry.on_token(lane.name)
        if rr.t_first is None:
            rr.t_first = now
        if rr.logits is not None and logits_row is not None:
            rr.logits.append(logits_row)
        if (len(rr.tokens) >= run.req.max_new
                or (run.req.eos_id is not None
                    and tok == run.req.eos_id)):
            rr.t_done = now
            self.active_tokens -= run.req.cost
            del lane.running[slot]
            bisect.insort(lane.free, slot)     # eviction frees capacity
            if self.telemetry is not None:
                self.telemetry.on_request_done(rr, lane.name)

    def _now_fine(self, now: float) -> float:
        """Sub-tick timestamp for span durations: the run() clock when
        one is live, else the tick's own `now` (durations are 0 under
        direct step() driving, as in deterministic tests)."""
        return self._clock.now() if self._clock is not None else now

    def step(self, now: Optional[float] = None) -> List[RequestResult]:
        """One scheduler tick: release the due backoff restarts, probe
        quarantined lanes whose cooldown expired, admit, then one decode
        round per lane with live slots (a speculative call on a spec
        lane).  On a sentinel-guarded lane the round is shadow-scored
        every period-th tick, and a trip (drift out of the envelope, or a
        LaneHealthError at admission or decode) is handled BEFORE the
        round's tokens are emitted: a tripped round's output never
        reaches a result.  Returns results completed this tick."""
        now = 0.0 if now is None else now
        done_before = {rid for rid, r in self.results.items() if r.done}
        if self._deferred:
            due = [d for d in self._deferred if d[0] <= now]
            if due:
                self._deferred = [d for d in self._deferred if d[0] > now]
                for _, req in due:
                    self._requeue(req)
        for lane in self.lanes.values():
            if lane.quarantined:
                self._maybe_probe(lane, now)
                continue
            try:
                self._admit_lane(lane, now)
            except LaneHealthError as e:
                if lane.sentinel is None:
                    raise
                self._trip(lane, now, str(e))
        for lane in self.lanes.values():
            if lane.quarantined or not lane.running:
                continue
            if hasattr(lane.backend, "spec_round"):
                self._spec_round(lane, now)
                continue
            sen = lane.sentinel
            shadow = None
            if sen is not None and sen.due():
                # the exact reference for the CURRENT state: before the
                # lane's own decode advances its caches
                shadow = sen.shadow(lane.backend)
            t0 = self._now_fine(now)
            try:
                nxt = lane.backend.decode_round()
            except LaneHealthError as e:
                if sen is None:
                    raise
                self._trip(lane, now, str(e))
                continue
            if self.telemetry is not None:
                self.telemetry.on_decode_round(
                    lane.name, [r.result.rid for r in lane.running.values()],
                    t0, self._now_fine(now) - t0)
            if shadow is not None:
                tripped = sen.observe(lane.backend.last_decode_logits,
                                      shadow, sorted(lane.running), now)
                if (self.telemetry is not None
                        and sen.last_agree is not None):
                    self.telemetry.on_sentinel(lane.name, sen.last_agree,
                                               sen.last_nmed)
                if tripped:
                    self._trip(lane, now, sen.last_trip_reason,
                               breaker_tripped=True)
                    continue                   # trip before emit
            dec_lg = getattr(lane.backend, "last_decode_logits", None)
            for slot in sorted(lane.running):
                lg = (dec_lg[slot] if self.record_logits
                      and dec_lg is not None else None)
                self._emit(lane, slot, int(nxt[slot]), now, lg)
        if self.check_invariants:
            self._check()
        return [r for rid, r in self.results.items()
                if r.done and rid not in done_before]

    # -- fault containment --------------------------------------------------
    def _safest_lane(self) -> str:
        """The healthy lane with the tightest characterized NMED (the
        exact lane on the default ladder)."""
        ok = [n for n, lane in self.lanes.items() if not lane.quarantined]
        if not ok:
            raise RuntimeError("every lane is quarantined")
        tiers = getattr(self.router, "tiers", None)
        if tiers:
            ok.sort(key=lambda n: tiers[n].nmed if n in tiers
                    else float("inf"))
            return ok[0]
        return "exact" if "exact" in ok else ok[0]

    def _requeue(self, req: Request) -> None:
        """Re-enqueue a displaced request on the safest healthy lane,
        bypassing `submit` (its RequestResult, retry count included,
        survives the restart)."""
        name = self._safest_lane()
        self.results[req.rid].tier = name
        self.lanes[name].queue.append(req)

    def _trip(self, lane: _Lane, now: float, reason: str,
              breaker_tripped: bool = False) -> None:
        """Quarantine `lane` and displace its work: queued requests
        re-route untouched (they never ran on it); in-flight requests
        RESTART: their tokens are discarded (fault-suspect) and they
        prefill again from the prompt on the safest healthy lane, so the
        output is what an exact-lane-only run gives.  Each restart spends
        one unit of the retry budget; past it the result is "failed"."""
        sen = lane.sentinel
        if sen is not None and not breaker_tripped:
            sen.record_failure(now, reason)
        lane.quarantined = True
        trigger = sen.last_trip_stats if sen is not None else None
        after = sen.breaker.state if sen is not None else "tripped"
        ev = TripEvent(
            lane=lane.name, t=now, reason=reason,
            tokens_before_trip=lane.emitted,
            in_flight_displaced=len(lane.running),
            trigger_agree=trigger[0] if trigger else None,
            trigger_nmed=trigger[1] if trigger else None,
            breaker_after=after)
        self.trip_log.append(ev)
        if self.telemetry is not None:
            self.telemetry.on_trip(ev)
            self.telemetry.on_breaker(lane.name, "healthy", after, now)
        lane.emitted = 0
        while lane.queue:
            self._requeue(lane.queue.popleft())
        for slot in sorted(lane.running):
            run = lane.running.pop(slot)
            bisect.insort(lane.free, slot)
            self.active_tokens -= run.req.cost
            rr = run.result
            lane.n_retries += 1
            if self.telemetry is not None:
                self.telemetry.on_request_retry(rr, lane.name, now)
            rr.tokens.clear()
            if rr.logits is not None:
                rr.logits.clear()
            rr.t_admit = rr.t_first = None
            rr.retries += 1
            if rr.retries > self.retry_budget:
                rr.status = "failed"
                rr.t_done = now
                if self.telemetry is not None:
                    self.telemetry.on_request_done(rr, lane.name)
                continue
            delay = self.retry_backoff_s * (2 ** (rr.retries - 1))
            if delay > 0:
                self._deferred.append((now + delay, run.req))
            else:
                self._requeue(run.req)

    def _maybe_probe(self, lane: _Lane, now: float) -> None:
        """Half-open re-admission: once the cooldown has expired (and the
        lane is drained), run the sentinel's verification burst in a free
        slot; a clean burst lifts the quarantine."""
        sen = lane.sentinel
        if (sen is None or lane.running or not lane.free
                or not sen.breaker.should_probe(now)):
            return
        if self.telemetry is not None:
            self.telemetry.on_breaker(lane.name, "tripped", "half_open",
                                      now)
        ok = sen.probe(lane.backend, lane.free[0], now)
        if self.telemetry is not None:
            self.telemetry.on_breaker(
                lane.name, "half_open", "healthy" if ok else "tripped", now)
        if ok:
            lane.quarantined = False
            lane.emitted = 0

    def _spec_round(self, lane: _Lane, now: float) -> None:
        """One spec call: up to rounds_per_call draft + verify rounds, up
        to k + 1 tokens each, a live slot.  The backend cuts each slot's
        tokens at its remaining budget and first EOS (a slot that finishes
        mid-call idles for the rounds left), so each slot's tokens come in
        the order sequential decoding gives them."""
        b = lane.backend
        remaining = np.zeros(b.n_slots, np.int64)
        eos = np.full(b.n_slots, -1, np.int64)
        for slot, run in lane.running.items():
            remaining[slot] = run.req.max_new - len(run.result.tokens)
            if run.req.eos_id is not None:
                eos[slot] = run.req.eos_id
        tel = self.telemetry
        pre = (b.n_rounds, b.n_drafted, b.n_accepted, b.n_emitted)
        t0 = self._now_fine(now)
        toks, counts = b.spec_round(remaining, eos)
        if tel is not None:
            tel.on_spec_round(
                lane.name, b.draft_k, b.n_rounds - pre[0],
                b.n_drafted - pre[1], b.n_accepted - pre[2],
                b.n_emitted - pre[3],
                [r.result.rid for r in lane.running.values()],
                t0, self._now_fine(now) - t0)
        lg = getattr(b, "last_spec_logits", None)
        slots = sorted(lane.running)
        for r in range(counts.shape[1]):
            for slot in slots:
                for i in range(int(counts[slot, r])):
                    row = (lg[slot, r, i] if self.record_logits
                           and lg is not None else None)
                    self._emit(lane, slot, int(toks[slot, r, i]), now, row)

    def _check(self) -> None:
        total = 0
        for lane in self.lanes.values():
            free, busy = set(lane.free), set(lane.running)
            assert not free & busy, f"lane {lane.name}: slot both free+busy"
            assert free | busy == set(range(lane.backend.n_slots)), \
                f"lane {lane.name}: slot leak"
            total += sum(r.req.cost for r in lane.running.values())
        assert total == self.active_tokens, "token budget drifted"
        assert self.active_tokens >= 0
        assert (self.token_budget is None
                or self.active_tokens <= self.token_budget), \
            "admission exceeded the token budget"

    # -- the serving loop --------------------------------------------------
    def run(self, requests: Sequence[Request], clock=None,
            max_steps: int = 1_000_000) -> Dict[int, RequestResult]:
        """Serve a workload to completion against a clock (RealClock by
        default; SimClock for deterministic tests).  Returns the results
        of *this* workload (the engine is reusable across runs)."""
        if clock is None:
            from .workload import RealClock

            clock = RealClock()
        self._clock = clock              # one time source per run: spans
        t_run0 = clock.now()             # and stats stay coherent
        submitted = [r.rid for r in requests]
        pending = deque(sorted(requests, key=lambda r: r.arrival))
        self.peak_running = sum(len(l.running) for l in self.lanes.values())
        self._expected = {}
        for r in pending:
            name = self._route_name(r)
            self._expected[name] = self._expected.get(name, 0) + 1
        for _ in range(max_steps):
            now = clock.now()
            while pending and pending[0].arrival <= now:
                try:
                    self.submit(pending[0])
                except AdmissionRejected:
                    break          # backpressure: hold further arrivals
                pending.popleft()
            self.step(now)
            busy = any(l.running for l in self.lanes.values())
            queued = any(l.queue for l in self.lanes.values())
            if not (pending or busy or queued or self._deferred):
                self.last_run_s = clock.now() - t_run0
                return {rid: self.results[rid] for rid in submitted}
            if not busy and (pending or self._deferred):
                clock.wait_until(min(
                    [r.arrival for r in list(pending)[:1]]
                    + [t for t, _ in self._deferred]))
        raise RuntimeError("engine did not drain the workload "
                           f"within {max_steps} steps")

    def metrics(self) -> dict:
        """Per-lane tokens and throughput over `last_run_s`, sentinel
        trips and the restarts they caused, quarantine, a spec lane's
        acceptance rate, tokens a round and draft depth, and, with an
        `EngineTelemetry` whose meter profiled the lane, its estimated
        energy, energy per token and MACs (None, or no "macs", else)."""
        dur = self.last_run_s
        lanes = {}
        for name, lane in self.lanes.items():
            b = lane.backend
            d = {"tokens": lane.total_emitted,
                 "tokens_per_s": (lane.total_emitted / dur
                                  if dur else None),
                 "trips": sum(1 for t in self.trip_log if t.lane == name),
                 "retries": lane.n_retries,
                 "quarantined": lane.quarantined,
                 "energy_j": None,
                 "energy_per_token_j": None,
                 "acceptance_rate": None,
                 "tokens_per_round": None,
                 "draft_k": None}
            if hasattr(b, "acceptance_rate"):
                d["acceptance_rate"] = b.acceptance_rate
                d["tokens_per_round"] = b.tokens_per_round
                d["draft_k"] = b.draft_k
            if self.telemetry is not None:
                m = self.telemetry.meters.get(name)
                if m is not None and m.profiled:
                    d["energy_j"] = m.energy_j
                    d["energy_per_token_j"] = m.energy_per_token_j
                    d["macs"] = m.macs
            lanes[name] = d
        return {"duration_s": dur,
                "n_requests": sum(1 for r in self.results.values()
                                  if r.done),
                "n_failed": sum(1 for r in self.results.values()
                                if r.done and r.status != "ok"),
                "total_tokens": sum(d["tokens"] for d in lanes.values()),
                "peak_concurrency": self.peak_running,
                "steady_plan_misses": (self.steady_plan_misses()
                                       if self._plan_mark is not None
                                       else None),
                "lanes": lanes}


# ---------------------------------------------------------------------------
# Production assembly
# ---------------------------------------------------------------------------


def build_engine(cfg, params=None, *, tiers=None, slots_per_tier: int = 4,
                 max_len: int = 128,
                 prompt_buckets: Sequence[int] = (16, 32),
                 group_buckets: Sequence[int] = (1, 2, 4),
                 continuous: bool = True,
                 token_budget: Optional[int] = None,
                 record_logits: bool = False,
                 max_queued: Optional[int] = None,
                 spec_decode: Optional[int] = None,
                 spec_drafter: Optional[str] = None,
                 spec_ks: Optional[Sequence[int]] = None,
                 spec_rounds: int = 4,
                 fault=None,
                 sentinel: bool = False,
                 sentinel_cfg=None,
                 retry_budget: int = 3,
                 retry_backoff_s: float = 0.0,
                 telemetry=None,
                 seed: int = 0, device=None, mesh=None) -> ServingEngine:
    """One lane per accuracy tier over shared weights, on `device` (CUDA
    unless ``device="cpu"``).

    `cfg` is a ModelConfig (its own `cim` field is ignored — each lane
    replaces it with its tier's CiMConfig); `params` defaults to a
    seeded random init on the device (weights are tier-independent, so
    every lane shares them).  `tiers` defaults to the DSE ladder.

    With `mesh` (every rank of it calls this alike, with the same full
    `params` or seed) the weights are cut to this rank's shards and each
    lane's pool is data-parallel (see the module docstring); every rank
    then drives the engine with the same workload.

    `spec_decode=k` makes the exact lane speculative (serving/spec.py):
    a `SpecDecodeBackend` pairs `spec_drafter` (by default the
    cheapest-energy approximate rung) with the exact rung upgraded to
    per-token activation scales (`tiers.spec_pair`), which replaces the
    exact rung; `spec_ks` are more draft depths warmup runs, so that
    `set_draft_k` builds no plan, and `spec_rounds` the rounds of one
    call.  The verify logits go to the host only with `record_logits`.

    `fault` (a `core.faults.FaultConfig`) puts as-fabricated stuck-at
    defects into every approximate tier's stored tables and weight words
    (their mode must be one of `faults.FAULT_MODES`); the exact tier
    stays clean, the containment target.  `sentinel=True` (or a
    `SentinelConfig` as `sentinel_cfg`) arms a sentinel on each
    approximate lane, which needs an `exact` tier (its per-token rung is
    the shadow reference); `retry_budget` and `retry_backoff_s` bound the
    restarts (see `ServingEngine`).  Sentinels run on a mesh, faults do
    not (the shard kernels quantize their words on load).
    `telemetry` (an `obs.EngineTelemetry`) records the serving telemetry
    (see the module docstring)."""
    from repro_torch.device import resolve_device
    from repro_torch.models.bridge import shard_params
    from repro_torch.models.transformer import LM

    from .tiers import TierRouter, build_tiers, spec_pair

    check_engine_arch(cfg)
    if fault is not None and mesh is not None:
        raise ValueError(
            "fault injection does not compose with a mesh: the shard "
            "kernels quantize their words on load and cannot see the "
            "defect map; drop the mesh or the fault config")
    armed = sentinel or sentinel_cfg is not None
    dev = resolve_device(device)
    if tiers is None:
        tiers = build_tiers()
    if fault is not None:
        tiers = tuple(
            t if t.name == "exact" or t.cim is None
            else dataclasses.replace(
                t, cim=dataclasses.replace(t.cim, fault=fault))
            for t in tiers)
    d_tier = None
    if spec_decode is not None:
        d_tier, v_tier = spec_pair(tiers, spec_drafter)
        tiers = tuple(v_tier if t.name == "exact" else t for t in tiers)
    if params is None:
        params = LM(cfg, dev).init(seed)
    if mesh is not None:
        params = shard_params(params, cfg, mesh)
    lanes = {}
    for tier in tiers:
        lm = LM(dataclasses.replace(cfg, cim=tier.cim), dev, mesh=mesh)
        if d_tier is not None and tier.name == "exact":
            from .spec import SpecDecodeBackend

            lanes[tier.name] = SpecDecodeBackend(
                lm, LM(dataclasses.replace(cfg, cim=d_tier.cim), dev,
                       mesh=mesh),
                params, draft_k=spec_decode, draft_ks=spec_ks,
                rounds_per_call=spec_rounds, keep_logits=record_logits,
                n_slots=slots_per_tier, max_len=max_len,
                prompt_buckets=prompt_buckets, group_buckets=group_buckets,
                mesh=mesh)
            continue
        lanes[tier.name] = LMLaneBackend(
            lm, params, n_slots=slots_per_tier, max_len=max_len,
            prompt_buckets=prompt_buckets, group_buckets=group_buckets,
            mesh=mesh)
    sentinels = None
    if armed:
        from .sentinel import LaneSentinel, reference_lm

        by_name = {t.name: t for t in tiers}
        if "exact" not in by_name:
            raise ValueError("sentinels need an 'exact' tier as the "
                             "shadow-scoring reference and demotion "
                             f"target; configured: {sorted(by_name)}")
        ref_lm = reference_lm(cfg, by_name["exact"].cim, dev, mesh=mesh)
        sentinels = {t.name: LaneSentinel(ref_lm, params, t.nmed,
                                          sentinel_cfg)
                     for t in tiers
                     if t.name != "exact" and t.cim is not None}
    return ServingEngine(lanes, TierRouter(tiers), continuous=continuous,
                         token_budget=token_budget,
                         record_logits=record_logits, max_queued=max_queued,
                         sentinels=sentinels, retry_budget=retry_budget,
                         retry_backoff_s=retry_backoff_s,
                         telemetry=telemetry)
