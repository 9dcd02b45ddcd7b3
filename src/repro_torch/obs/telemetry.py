"""EngineTelemetry: the serving engine's obs hub (the JAX package's
DESIGN.md §15), with the reference's counters, gauges, histograms, span
names and trace-row (tid) scheme.

One object wires the whole telemetry spine together:

  * installs itself as the **dispatch-boundary sink** of all four port
    modules that have one (`core/approx_gemm`, `core/autotune`,
    `core/error_model`, `core/allocate`): frontend-call and MAC counters
    by kernel family, plan misses (the port's retraces), attention block
    resolutions, characterization-cache outcomes and allocation-search
    spend;
  * owns one `LaneEnergyMeter` per lane (profiled at engine warmup,
    before the plan-miss probe arms) and attributes estimated Joules to
    lanes *and* live requests per scheduler event;
  * records per-request lifecycle spans (queue-wait -> prefill ->
    decode, plus retry spans on sentinel trips) and per-lane engine
    spans (decode/spec rounds) into the registry's span ring —
    `obs/export.chrome_trace` renders them for Perfetto;
  * folds sentinel scores, breaker transitions, and structured
    `TripEvent`s into gauges/counters and the event ring.

Every hook is a host-side dict update gated on ``registry.enabled``.
The port runs eagerly, so the dispatch hook fires on every GEMM call,
not only on traces as in the reference: `launch/obs.py` measures what
that costs in serving tokens/s (the reference's contract: at most 3%,
and no plan built in steady state while recording).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from .energy import LaneEnergyMeter
from .metrics import MetricsRegistry, label_key

# span-duration histogram buckets (seconds): microseconds to minutes
_TIME_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0,
                 3.0, 10.0, 30.0, 120.0)


class EngineTelemetry:
    """Telemetry hub for one `ServingEngine` (pass as its `telemetry=`).

    `energy=False` skips the MAC profiling (and all Joule attribution);
    `attach=False` leaves the global sinks untouched (scoped tests).
    Call `detach()` when discarding a telemetry object that was attached
    — the sinks are global.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 energy: bool = True, attach: bool = True,
                 span_capacity: int = 8192, event_capacity: int = 4096):
        self.registry = registry or MetricsRegistry(
            span_capacity=span_capacity, event_capacity=event_capacity)
        r = self.registry
        self.dispatch_calls = r.counter(
            "repro_dispatch_calls_total",
            "dispatch-frontend invocations (every eager call)")
        self.dispatch_macs = r.counter(
            "repro_dispatch_macs_total",
            "MACs announced at dispatch boundaries")
        self.retraces = r.counter(
            "repro_dispatch_retraces_total",
            "plans built (the plan_misses probe)")
        self.autotune_c = r.counter(
            "repro_autotune_resolutions_total",
            "autotune block resolutions by cache outcome")
        self.char_cache_c = r.counter(
            "repro_char_cache_resolutions_total",
            "multiplier characterizations by cache outcome")
        self.alloc_search_c = r.counter(
            "repro_alloc_search_evals_total",
            "allocation-search evaluator spend by stage")
        self.requests_c = r.counter(
            "repro_serving_requests_total", "completed requests")
        self.tokens_c = r.counter(
            "repro_serving_tokens_total", "emitted tokens")
        self.prefills_c = r.counter(
            "repro_serving_prefills_total", "grouped prefill calls")
        self.decode_rounds_c = r.counter(
            "repro_serving_decode_rounds_total", "pool decode rounds")
        self.retries_c = r.counter(
            "repro_serving_retries_total",
            "request restarts after sentinel trips")
        self.trips_c = r.counter(
            "repro_serving_sentinel_trips_total", "sentinel trips")
        self.breaker_c = r.counter(
            "repro_serving_breaker_transitions_total",
            "circuit-breaker state transitions")
        self.spec_rounds_c = r.counter(
            "repro_serving_spec_subrounds_total",
            "executed speculative draft+verify sub-rounds")
        self.spec_drafted_c = r.counter(
            "repro_serving_spec_drafted_total", "drafted tokens")
        self.spec_accepted_c = r.counter(
            "repro_serving_spec_accepted_total",
            "drafted tokens the verifier accepted")
        self.queue_wait_h = r.histogram(
            "repro_serving_queue_wait_seconds", _TIME_BUCKETS,
            "arrival -> admission wait")
        self.ttft_h = r.histogram(
            "repro_serving_ttft_seconds", _TIME_BUCKETS,
            "arrival -> first token")
        self.decode_h = r.histogram(
            "repro_serving_decode_round_seconds", _TIME_BUCKETS,
            "wall time of one pool decode / spec call")
        self.agree_g = r.gauge(
            "repro_serving_sentinel_agree",
            "rolling argmax agreement per sentinel lane")
        self.nmed_g = r.gauge(
            "repro_serving_sentinel_nmed",
            "rolling logit NMED per sentinel lane")
        self.energy_g = r.gauge(
            "repro_serving_energy_joules",
            "estimated energy attributed per lane")
        self.ept_g = r.gauge(
            "repro_serving_energy_per_token_joules",
            "estimated energy per emitted token per lane")
        self.energy_enabled = bool(energy)
        self.meters: Dict[str, LaneEnergyMeter] = {}
        self.request_energy_j: Dict[int, float] = {}
        self._tids: Dict[str, int] = {}
        self._dispatch_keys: Dict[tuple, tuple] = {}
        self._attached = False
        if attach:
            self.attach()

    # -- global sink management --------------------------------------------
    def attach(self) -> None:
        from repro_torch.core import (allocate, approx_gemm, autotune,
                                      error_model)

        approx_gemm.set_obs_sink(self)
        autotune.set_obs_sink(self)
        error_model.set_obs_sink(self)
        allocate.set_obs_sink(self)
        self._attached = True

    def detach(self) -> None:
        from repro_torch.core import (allocate, approx_gemm, autotune,
                                      error_model)

        if self._attached:
            approx_gemm.set_obs_sink(None)
            autotune.set_obs_sink(None)
            error_model.set_obs_sink(None)
            allocate.set_obs_sink(None)
            self._attached = False

    # -- dispatch sink protocol (approx_gemm / autotune) -------------------
    def dispatch(self, op: str, family: str, mode: str, bits: int,
                 macs: float, cache_hit: bool) -> None:
        # every GEMM call of the eager port lands here: the two label
        # keys are built once per (op, family, mode, bits, hit)
        keys = self._dispatch_keys.get((op, family, mode, bits, cache_hit))
        if keys is None:
            keys = self._dispatch_keys[(op, family, mode, bits,
                                        cache_hit)] = (
                label_key({"op": op, "family": family, "mode": mode,
                           "bits": bits,
                           "cache": "hit" if cache_hit else "miss"}),
                label_key({"op": op, "family": family, "bits": bits}))
        self.dispatch_calls.inc_key(keys[0], 1)
        self.dispatch_macs.inc_key(keys[1], macs)

    def retrace(self) -> None:
        self.retraces.inc(1)

    def autotune(self, key: str, outcome: str) -> None:
        self.autotune_c.inc(1, outcome=outcome)

    def char_cache(self, key: str, outcome: str) -> None:
        self.char_cache_c.inc(1, outcome=outcome)

    def alloc_search(self, event: str, count: int) -> None:
        self.alloc_search_c.inc(count, event=event)

    # -- engine lifecycle ---------------------------------------------------
    def _tid(self, lane: str) -> int:
        """Stable negative trace row per lane (request rows are >= 0)."""
        tid = self._tids.get(lane)
        if tid is None:
            tid = -(len(self._tids) + 1)
            self._tids[lane] = tid
        return tid

    @property
    def tid_names(self) -> Dict[int, str]:
        return {tid: f"lane {name}" for name, tid in self._tids.items()}

    def on_warmup(self, engine) -> None:
        """Build the per-lane energy meters (one run of each profiled
        call, at warmed shapes).  Runs inside the engine's warmup, which
        then resets the backends (the profiled decodes write K/V) and
        only then arms its plan-miss probe."""
        tiers = getattr(engine.router, "tiers", {}) or {}
        for name, lane in engine.lanes.items():
            fallback = None
            t = tiers.get(name)
            if t is not None:
                fallback = getattr(t, "energy_per_mac_j", None)
            meter = LaneEnergyMeter(name, fallback_j_per_mac=fallback)
            if self.energy_enabled:
                meter.build(lane.backend)
            self.meters[name] = meter
            self._tid(name)

    def _share(self, j: float, rids: Sequence[int]) -> None:
        if not rids or j == 0.0:
            return
        share = j / len(rids)
        for rid in rids:
            self.request_energy_j[rid] = \
                self.request_energy_j.get(rid, 0.0) + share

    def on_prefill(self, lane: str, n_prompts: int, prompt_len: int,
                   rids: Sequence[int], now: float) -> None:
        if not self.registry.enabled:
            return
        self.prefills_c.inc(1, tier=lane)
        m = self.meters.get(lane)
        if m is not None:
            self._share(m.on_prefill(n_prompts, prompt_len), rids)
            self._update_energy(lane, m)

    def on_decode_round(self, lane: str, rids: Sequence[int],
                        t0: float, dur: float) -> None:
        if not self.registry.enabled:
            return
        self.decode_rounds_c.inc(1, tier=lane)
        self.decode_h.observe(dur, tier=lane)
        self.registry.span("decode_round", t0, dur, tid=self._tid(lane),
                           lane=lane, n_live=len(rids))
        m = self.meters.get(lane)
        if m is not None:
            self._share(m.on_decode(), rids)
            self._update_energy(lane, m)

    def on_spec_round(self, lane: str, k: int, d_rounds: int,
                      d_drafted: int, d_accepted: int, d_emitted: int,
                      rids: Sequence[int], t0: float,
                      dur: float) -> None:
        if not self.registry.enabled:
            return
        self.decode_h.observe(dur, tier=lane)
        self.spec_rounds_c.inc(d_rounds, tier=lane, k=k)
        self.spec_drafted_c.inc(d_drafted, tier=lane, k=k)
        self.spec_accepted_c.inc(d_accepted, tier=lane, k=k)
        self.registry.span("spec_round", t0, dur, tid=self._tid(lane),
                           lane=lane, k=k, rounds=d_rounds,
                           emitted=d_emitted)
        m = self.meters.get(lane)
        if m is not None:
            self._share(m.on_spec_rounds(k, d_rounds), rids)
            self._update_energy(lane, m)

    def on_token(self, lane: str, n: int = 1) -> None:
        if not self.registry.enabled:
            return
        self.tokens_c.inc(n, tier=lane)
        m = self.meters.get(lane)
        if m is not None:
            m.add_tokens(n)

    def on_request_done(self, rr, lane: str) -> None:
        """Request lifecycle spans, emitted once at completion from the
        result's own engine-clock timestamps (tid = rid)."""
        if not self.registry.enabled:
            return
        self.requests_c.inc(1, tier=lane, status=rr.status)
        if rr.status != "ok" or rr.t_admit is None:
            self.registry.event("request_failed", rr.t_done or 0.0,
                                rid=rr.rid, tier=lane,
                                retries=rr.retries)
            return
        r = self.registry
        wait = max(rr.t_admit - rr.arrival, 0.0)
        self.queue_wait_h.observe(wait, tier=lane)
        r.span("queue", rr.arrival, wait, tid=rr.rid, tier=lane,
               rid=rr.rid)
        if rr.t_first is not None:
            self.ttft_h.observe(max(rr.t_first - rr.arrival, 0.0),
                                tier=lane)
            r.span("prefill", rr.t_admit,
                   max(rr.t_first - rr.t_admit, 0.0), tid=rr.rid,
                   tier=lane, rid=rr.rid)
            if rr.t_done is not None:
                r.span("decode", rr.t_first,
                       max(rr.t_done - rr.t_first, 0.0), tid=rr.rid,
                       tier=lane, rid=rr.rid,
                       tokens=len(rr.tokens), retries=rr.retries)

    def on_request_retry(self, rr, lane: str, now: float) -> None:
        """One displaced in-flight attempt: a `retry` span covering the
        discarded attempt, recorded at trip time (before the result's
        timestamps reset for the restart)."""
        if not self.registry.enabled:
            return
        self.retries_c.inc(1, tier=lane)
        t0 = rr.t_admit if rr.t_admit is not None else now
        self.registry.span("retry", t0, max(now - t0, 0.0), tid=rr.rid,
                           tier=lane, rid=rr.rid, attempt=rr.retries + 1)

    def on_trip(self, ev) -> None:
        if not self.registry.enabled:
            return
        self.trips_c.inc(1, tier=ev.lane)
        fields = dataclasses.asdict(ev)
        fields.pop("t")                  # positional timestamp already
        self.registry.event("sentinel_trip", ev.t, **fields)

    def on_breaker(self, lane: str, frm: str, to: str,
                   now: float) -> None:
        if not self.registry.enabled:
            return
        self.breaker_c.inc(1, tier=lane, frm=frm, to=to)
        self.registry.event("breaker_transition", now, lane=lane,
                            frm=frm, to=to)

    def on_sentinel(self, lane: str, agree: float, nmed: float) -> None:
        self.agree_g.set(agree, tier=lane)
        self.nmed_g.set(nmed, tier=lane)

    def _update_energy(self, lane: str, m: LaneEnergyMeter) -> None:
        self.energy_g.set(m.energy_j, tier=lane)
        self.ept_g.set(m.energy_per_token_j, tier=lane)
