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

Speculative decoding, sentinels, fault injection, telemetry and mesh
execution are later slices of the port.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class LaneHealthError(RuntimeError):
    """A lane produced non-finite logits."""


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

    @classmethod
    def from_results(cls, results: Dict[int, "RequestResult"],
                     duration_s: float) -> "EngineStats":
        done = [r for r in results.values() if r.done]
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
                   p95_ttft_ms=float(np.percentile(ttft, 95)))


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
    cache insert, and full-pool decode, on the LM's device."""

    def __init__(self, lm, params, *, n_slots: int, max_len: int,
                 prompt_buckets: Sequence[int] = (16, 32),
                 group_buckets: Sequence[int] = (1, 2, 4)):
        check_engine_arch(lm.cfg)
        self.lm, self.params = lm, params
        self.device = lm.device
        self.n_slots, self.max_len = int(n_slots), int(max_len)
        self.prompt_buckets = tuple(sorted(set(int(p) for p in
                                               prompt_buckets)))
        self.group_buckets = tuple(sorted(set(int(g) for g in
                                              group_buckets)))
        if max(self.prompt_buckets) > self.max_len:
            raise ValueError("prompt bucket exceeds max_len")
        self.caches = lm.init_caches(self.n_slots, self.max_len,
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
        with torch.inference_mode():
            logits, grp = self.lm.prefill(self.params, {
                "tokens": torch.as_tensor(toks, device=self.device),
                "lengths": torch.as_tensor(lens, device=self.device),
                "max_len": self.max_len})
            self._insert(grp, list(range(g)), list(slots))
        first, lg = self._greedy(logits)
        self.last_prefill_logits = lg[:g]
        for i, sl in enumerate(slots):
            self.slot_tokens[sl] = first[i]
            self.slot_pos[sl] = lens[i]
        return first[:g]

    def decode_round(self) -> np.ndarray:
        """One greedy decode step for the whole pool (idle slots ride
        along masked by their own fill level; their output is ignored)."""
        tok = torch.as_tensor(self.slot_tokens[:, None], device=self.device)
        pos = torch.as_tensor(self.slot_pos.astype(np.int32),
                              device=self.device)
        with torch.inference_mode():
            logits, self.caches = self.lm.decode_step(self.params,
                                                      self.caches, tok, pos)
        nxt, lg = self._greedy(logits)
        self.slot_tokens = nxt.astype(np.int64)
        self.slot_pos += 1
        self.last_decode_logits = lg
        return nxt

    def reset(self) -> None:
        """Return every slot to the idle state a fresh pool starts in:
        token 0 at position 0 in the scheduler's view AND in the caches'
        fill levels.  Idle slots ride along in each decode round and
        enter the per-tensor activation scale, so a pool reused from an
        earlier workload must restart them here to serve a workload
        exactly as a fresh pool would."""
        self.slot_tokens[:] = 0
        self.slot_pos[:] = 0
        with torch.inference_mode():
            for layer in self.caches["layers"]:
                layer["pos"].zero_()

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
        self.total_emitted = 0


class ServingEngine:
    """Continuous-batching scheduler over per-tier slot-pool lanes.

    `lanes` maps tier name -> backend (LMLaneBackend in production; the
    tests drive the scheduler with a fake backend).  `continuous=False`
    degrades admission to static batching — a lane only admits when it
    is fully drained (the lockstep baseline); everything else is shared.
    """

    def __init__(self, lanes: Dict[str, object], router, *,
                 continuous: bool = True,
                 token_budget: Optional[int] = None,
                 record_logits: bool = False,
                 check_invariants: bool = False,
                 max_queued: Optional[int] = None):
        if not lanes:
            raise ValueError("need at least one lane")
        self.lanes = {name: _Lane(name, b) for name, b in lanes.items()}
        self.router = router
        self.continuous = continuous
        self.token_budget = token_budget
        self.record_logits = record_logits
        self.check_invariants = check_invariants
        self.max_queued = max_queued
        self.results: Dict[int, RequestResult] = {}
        self.active_tokens = 0
        self.peak_running = 0
        self.last_run_s: Optional[float] = None  # engine-clock duration
        self._expected: Dict[str, int] = {}
        self._plan_mark: Optional[int] = None

    # -- warmup / plan-miss probe ------------------------------------------
    def warmup(self) -> int:
        """Run every (tier x bucket) shape once, then arm the plan-miss
        probe."""
        n = sum(lane.backend.warmup() for lane in self.lanes.values()
                if hasattr(lane.backend, "warmup"))
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
            queued = sum(len(l.queue) for l in self.lanes.values())
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
        for members in groups.values():
            for i in range(0, len(members), max_g):
                chunk = members[i:i + max_g]
                first = lane.backend.admit([r.prompt for r, _ in chunk],
                                           [s for _, s in chunk])
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
        lane.total_emitted += 1
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

    def step(self, now: Optional[float] = None) -> List[RequestResult]:
        """One scheduler tick: admit, then one decode round per lane with
        live slots.  Returns results completed this tick."""
        now = 0.0 if now is None else now
        done_before = {rid for rid, r in self.results.items() if r.done}
        for lane in self.lanes.values():
            self._admit_lane(lane, now)
        for lane in self.lanes.values():
            if not lane.running:
                continue
            nxt = lane.backend.decode_round()
            dec_lg = getattr(lane.backend, "last_decode_logits", None)
            for slot in sorted(lane.running):
                lg = (dec_lg[slot] if self.record_logits
                      and dec_lg is not None else None)
                self._emit(lane, slot, int(nxt[slot]), now, lg)
        if self.check_invariants:
            self._check()
        return [r for rid, r in self.results.items()
                if r.done and rid not in done_before]

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
        t_run0 = clock.now()
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
            if not pending and not busy and not queued:
                self.last_run_s = clock.now() - t_run0
                return {rid: self.results[rid] for rid in submitted}
            if not busy and pending:
                clock.wait_until(pending[0].arrival)
        raise RuntimeError("engine did not drain the workload "
                           f"within {max_steps} steps")

    def metrics(self) -> dict:
        """Per-lane tokens and throughput over `last_run_s`."""
        dur = self.last_run_s
        lanes = {name: {"tokens": lane.total_emitted,
                        "tokens_per_s": (lane.total_emitted / dur
                                         if dur else None)}
                 for name, lane in self.lanes.items()}
        return {"duration_s": dur,
                "n_requests": sum(1 for r in self.results.values()
                                  if r.done),
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
                 seed: int = 0, device=None) -> ServingEngine:
    """One lane per accuracy tier over shared weights, on `device` (CUDA
    unless ``device="cpu"``).

    `cfg` is a ModelConfig (its own `cim` field is ignored — each lane
    replaces it with its tier's CiMConfig); `params` defaults to a
    seeded random init on the device (weights are tier-independent, so
    every lane shares them).  `tiers` defaults to the DSE ladder."""
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import LM

    from .tiers import TierRouter, build_tiers

    check_engine_arch(cfg)
    dev = resolve_device(device)
    if tiers is None:
        tiers = build_tiers()
    if params is None:
        params = LM(cfg, dev).init(seed)
    lanes = {}
    for tier in tiers:
        lm = LM(dataclasses.replace(cfg, cim=tier.cim), dev)
        lanes[tier.name] = LMLaneBackend(
            lm, params, n_slots=slots_per_tier, max_len=max_len,
            prompt_buckets=prompt_buckets, group_buckets=group_buckets)
    return ServingEngine(lanes, TierRouter(tiers), continuous=continuous,
                         token_budget=token_budget,
                         record_logits=record_logits, max_queued=max_queued)
