"""PyTorch port, lane sentinels and fault containment
(serving/sentinel.py and the engine's trip, restart and probe), ported
from tests/test_sentinel.py and tests/test_faults.py:

  * host-side units against the JAX package's: the config, the rolling
    stats, the breaker, the drift statistic, LaneSentinel.observe;
  * the scheduler against fake lanes: a trip quarantines the lane,
    discards its tokens and restarts its in-flight requests on the
    safest healthy lane within the retry budget and backoff, the probe
    re-admits it, pinned routing demotes around it, admission is bounded;
  * the real smoke LM: the shadow score leaves the lane's caches bitwise
    as they were, and chip_smoke.py's phase 12 (a clean armed ladder, a
    faulted one at the Table V rate, the exact-only run, the recovery
    drill, faulted convs) passes on the CPU."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from repro.serving import sentinel as jsen
from repro_torch.configs import get_config
from repro_torch.models.transformer import LM
from repro_torch.serving import (AdmissionRejected, CircuitBreaker,
                                 EngineStats, FaultConfig, LaneHealthError,
                                 LaneSentinel, RollingStats, SentinelConfig,
                                 ServingEngine, SimClock, TripEvent,
                                 build_engine, build_tiers)
from repro_torch.serving import engine as tengine
from repro_torch.serving.engine import LMLaneBackend
from repro_torch.serving.sentinel import (HALF_OPEN, HEALTHY, TRIPPED,
                                          logit_drift, reference_lm)
from repro_torch.serving.tiers import AccuracyTier, TierRouter

from test_torch_serving import FakeLane, _fake_tiers, _req

ARCH = "qwen3-1.7b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's small torch ops, restored
    after it (beside the other test workers torch's default pool waits
    for cores they hold)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------------- units ----


@pytest.mark.parametrize("kw", [{"period": 0}, {"window": 0},
                                {"probe_rounds": 0}, {"min_agree": 1.5}])
def test_sentinel_config_validation(kw):
    with pytest.raises(ValueError):
        SentinelConfig(**kw)
    with pytest.raises(ValueError):
        jsen.SentinelConfig(**kw)


def test_sentinel_config_thresholds_match_the_reference():
    ours, theirs = SentinelConfig(), jsen.SentinelConfig()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for env in (0.0, 0.004, 0.0273, 0.1):
        assert ours.nmed_threshold(env) == theirs.nmed_threshold(env)


def test_rolling_stats_window():
    st = RollingStats(window=3)
    assert st.agree == 1.0 and st.nmed == 0.0
    for a in (0.0, 0.0, 0.0, 1.0, 1.0, 1.0):
        st.push(a, 0.5)
    assert st.n == 3 and st.agree == 1.0
    st.reset()
    assert st.n == 0 and st.agree == 1.0


def test_breaker_state_machine():
    br = CircuitBreaker(cooldown_s=1.0)
    assert br.state == HEALTHY
    with pytest.raises(RuntimeError):
        br.probe_started()
    br.trip(now=10.0)
    assert br.state == TRIPPED and br.n_trips == 1
    assert not br.should_probe(10.5) and br.should_probe(11.0)
    br.probe_started()
    assert br.state == HALF_OPEN
    br.probe_failed(now=11.0)
    assert br.state == TRIPPED and not br.should_probe(11.5)
    br.probe_started()
    br.probe_passed()
    assert br.state == HEALTHY and br.n_recoveries == 1


def test_logit_drift_equals_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(4):
        lane, ref = rng.standard_normal((2, 5, 40))
        slots = sorted(rng.choice(5, 3, replace=False))
        assert logit_drift(lane, ref, slots) == jsen.logit_drift(lane, ref,
                                                                 slots)
    ref = np.array([[1.0, 2.0, 4.0], [1.0, 2.0, 4.0]])
    lane = np.array([[4.0, 2.0, 1.0], [1.0, 2.0, 4.0]])
    agree, nmed = logit_drift(lane, ref, [0, 1])
    assert agree == 0.5 and nmed == pytest.approx(0.5 * 6 / 7)


def _sentinel(envelope=0.02, **kw):
    cfg = SentinelConfig(period=1, window=2, min_samples=2, **kw)
    return LaneSentinel(lm=None, params=None, envelope=envelope, cfg=cfg)


@pytest.mark.parametrize("case", ["nmed", "agreement", "nonfinite"])
def test_observe_trips(case):
    sen = _sentinel(min_agree=0.9 if case == "agreement" else 0.3)
    if case == "nmed":
        ref, bad = np.ones((1, 8)), np.full((1, 8), 50.0)
    elif case == "agreement":
        ref, bad = np.array([[0.0, 1.0]]), np.array([[1.0, 0.999]])
    else:
        ref, bad = np.ones((1, 4)), np.array([[1.0, np.nan, 1.0, 1.0]])
    assert sen.due()
    first = sen.observe(bad, ref, [0], now=0.0)
    assert first == (case == "nonfinite")     # no min_samples wait there
    if case != "nonfinite":
        assert sen.due() and sen.observe(bad, ref, [0], now=0.1)
        assert sen.last_detection_rounds == 2
    assert sen.tripped
    assert {"nmed": "NMED", "agreement": "agreement",
            "nonfinite": "non-finite"}[case] in sen.last_trip_reason


def test_greedy_guard_raises_lane_health_error():
    lg = torch.zeros((2, 1, 4))
    lg[1, 0, 2] = float("inf")
    with pytest.raises(LaneHealthError, match="non-finite"):
        LMLaneBackend._greedy(None, lg)
    assert tengine.LaneHealthError is LaneHealthError


# ----------------------------------------- scheduler integration --------


class FakeSentinel:
    """LaneSentinel double: a scripted trip after `trip_at` checks and a
    scripted probe verdict."""

    def __init__(self, trip_at=2, probe_ok=True):
        self.trip_at, self.probe_ok = trip_at, probe_ok
        self.checks = 0
        self.breaker = CircuitBreaker(cooldown_s=0.0)
        self.last_trip_reason = None
        self.last_trip_stats = None

    def warmup(self, backend):
        return 0

    def due(self):
        return True

    def shadow(self, backend):
        return np.zeros(1)

    def observe(self, lane_logits, ref, slots, now):
        self.checks += 1
        if self.checks == self.trip_at:
            self.last_trip_reason = "scripted drift"
            self.last_trip_stats = (0.0, 9.0)
            self.breaker.trip(now)
            return True
        return False

    def record_failure(self, now, reason):
        self.last_trip_reason = reason
        self.breaker.trip(now)

    def probe(self, backend, slot, now):
        self.breaker.probe_started()
        if self.probe_ok:
            self.breaker.probe_passed()
        else:
            self.breaker.probe_failed(now)
        return self.probe_ok


def _guarded_engine(trip_at=2, probe_ok=False, **kw):
    tiers = _fake_tiers(("a", "b"))           # a: nmed 0.000, b: 0.001
    lanes = {t.name: FakeLane(3) for t in tiers}
    for lane in lanes.values():
        lane.last_decode_logits = None
    sen = FakeSentinel(trip_at=trip_at, probe_ok=probe_ok)
    eng = ServingEngine(lanes, TierRouter(tiers), check_invariants=True,
                        sentinels={"b": sen}, **kw)
    return eng, sen


def test_trip_restarts_in_flight_on_safest_lane():
    eng, _ = _guarded_engine(trip_at=2, probe_ok=False)
    res = eng.run([_req(i, tier="b", max_new=5) for i in range(2)],
                  clock=SimClock())
    assert len(eng.trip_log) == 1
    t = eng.trip_log[0]
    assert isinstance(t, TripEvent)
    assert t["lane"] == "b" and t["in_flight_displaced"] == 2
    assert t["tokens_before_trip"] == 4       # 2 slots x 2 emitted rounds
    assert (t.trigger_agree, t.trigger_nmed) == (0.0, 9.0)
    for r in res.values():
        assert r.done and r.status == "ok" and r.tier == "a"
        assert r.retries == 1 and len(r.tokens) == 5
        # the fault-suspect tokens are gone: one fresh counter run
        assert r.tokens == list(range(r.tokens[0], r.tokens[0] + 5))
    assert eng.lanes["b"].quarantined and eng.active_tokens == 0
    m = eng.metrics()
    assert m["lanes"]["b"]["trips"] == 1 and m["lanes"]["b"]["retries"] == 2
    assert m["n_failed"] == 0


def test_queued_requests_reroute_without_retry_penalty():
    eng, _ = _guarded_engine(trip_at=1, probe_ok=False)
    reqs = [_req(0, tier="b", max_new=4)] + [
        _req(i, tier="b", max_new=2) for i in range(1, 6)]
    res = eng.run(reqs, clock=SimClock())
    assert all(r.done and r.status == "ok" for r in res.values())
    assert any(r.retries for r in res.values())
    assert any(not r.retries for r in res.values())
    assert all(r.tier == "a" for r in res.values())


def test_probe_readmits_lane():
    eng, sen = _guarded_engine(trip_at=2, probe_ok=True)
    res = eng.run([_req(0, tier="b", max_new=6)], clock=SimClock())
    assert res[0].done and res[0].tier == "a"
    assert not eng.lanes["b"].quarantined and sen.breaker.n_recoveries == 1
    assert eng.submit(_req(7, tier="b")) == "b"


@pytest.mark.parametrize("budget,backoff", [(0, 0.0), (3, 0.5)])
def test_retry_budget_and_backoff(budget, backoff):
    eng, _ = _guarded_engine(trip_at=2, probe_ok=False,
                             retry_budget=budget, retry_backoff_s=backoff)
    clock = SimClock()
    res = eng.run([_req(0, tier="b", max_new=5)], clock=clock)
    assert res[0].done and res[0].retries == 1
    if budget == 0:
        assert res[0].status == "failed"
        stats = EngineStats.from_results(res, 1.0)
        assert stats.n_failed == 1 and stats.total_tokens == 0
    else:
        assert res[0].status == "ok" and len(res[0].tokens) == 5
        assert clock.t >= backoff and res[0].t_admit >= backoff


@pytest.mark.parametrize("guarded", [True, False])
def test_lane_health_error_trips_guarded_lanes_only(guarded):
    class SickLane(FakeLane):
        def decode_round(self):
            raise LaneHealthError("non-finite logits (test)")

    tiers = _fake_tiers(("a", "b"))
    lanes = {"a": FakeLane(3), "b": SickLane(3)}
    lanes["a"].last_decode_logits = None
    sen = FakeSentinel(trip_at=10 ** 9)
    eng = ServingEngine(lanes, TierRouter(tiers), check_invariants=True,
                        sentinels={"b": sen} if guarded else None)
    if not guarded:
        with pytest.raises(LaneHealthError):
            eng.run([_req(0, tier="b")], clock=SimClock())
        return
    res = eng.run([_req(0, tier="b", max_new=3)], clock=SimClock())
    assert res[0].done and res[0].tier == "a" and res[0].retries == 1
    assert "non-finite" in eng.trip_log[0]["reason"]
    assert sen.breaker.n_trips == 1


def test_router_demotes_pinned_tier_around_quarantine():
    tiers = [AccuracyTier("exact", None, 0.0, 3.0),
             AccuracyTier("balanced", None, 0.01, 2.0),
             AccuracyTier("economy", None, 0.05, 1.0)]
    router = TierRouter(tiers)
    assert router.route(None, "economy", avoid={"economy"}).name == \
        "balanced"
    assert router.route(None, "balanced",
                        avoid={"balanced", "economy"}).name == "exact"
    with pytest.raises(ValueError):
        router.route(None, "exact", avoid={"exact"})
    assert router.route(0.1, None, avoid={"economy"}).name == "balanced"
    assert router.route(0.1, None).name == "economy"


def test_admission_backpressure():
    eng, _ = _guarded_engine(trip_at=10 ** 9, max_queued=2)
    eng.submit(_req(0, tier="b"))
    eng.submit(_req(1, tier="b"))
    with pytest.raises(AdmissionRejected) as ei:
        eng.submit(_req(2, tier="b"))
    assert (ei.value.rid, ei.value.queued, ei.value.limit) == (2, 2, 2)
    assert 2 not in eng.results
    eng2, _ = _guarded_engine(trip_at=10 ** 9, max_queued=1)
    res = eng2.run([_req(i, tier="a", max_new=2) for i in range(8)],
                   clock=SimClock())
    assert len(res) == 8 and all(r.done and r.status == "ok"
                                 for r in res.values())


def test_build_engine_refusals():
    cfg = get_config(ARCH, smoke=True)
    f = FaultConfig(p_sa0=0.01)
    with pytest.raises(ValueError, match="mesh"):
        build_engine(cfg, fault=f, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="mesh"):   # armed or not
        build_engine(cfg, fault=f, sentinel=True, mesh=object(),
                     device="cpu")
    no_exact = tuple(t for t in build_tiers(mode="hardware")
                     if t.name != "exact")
    with pytest.raises(ValueError, match="exact"):
        build_engine(cfg, tiers=no_exact, sentinel=True, device="cpu")
    with pytest.raises(ValueError, match="integer storage"):
        build_engine(cfg, tiers=build_tiers(mode="surrogate_fast"), fault=f,
                     device="cpu")
    eng = build_engine(cfg, tiers=build_tiers(mode="hardware"), fault=f,
                       sentinel=True, slots_per_tier=2, max_len=16,
                       prompt_buckets=(8,), group_buckets=(1,), device="cpu")
    # faults go into every approximate tier and never into exact
    faults = {n: lane.backend.lm.cim.fault for n, lane in eng.lanes.items()}
    assert faults == {"exact": None, "balanced": f, "economy": f}
    assert set(n for n, lane in eng.lanes.items() if lane.sentinel) == {
        "balanced", "economy"}
    ref = eng.lanes["balanced"].sentinel.lm
    assert ref.cim.per_token and ref.cim.family == "exact"


# ------------------------------------------------------------ real LM ---


def test_shadow_leaves_the_lane_caches_bitwise_unchanged():
    """decode_multi writes K/V in place: the shadow scores a copy, so the
    lane's caches (K, V and fill levels) and its next decode are exactly
    what they would be without it; the score is the exact rung's."""
    cfg = get_config(ARCH, smoke=True)
    tiers = {t.name: t for t in build_tiers(mode="hardware")}
    params = LM(cfg, "cpu").init(0)
    lane = LMLaneBackend(LM(dataclasses.replace(cfg,
                                                cim=tiers["balanced"].cim),
                            "cpu"), params, n_slots=2, max_len=16,
                         prompt_buckets=(8,), group_buckets=(1, 2))
    rng = np.random.default_rng(1)
    lane.admit([rng.integers(0, cfg.vocab, (n,)) for n in (7, 3)], [0, 1])
    lane.decode_round()
    ref_lm = reference_lm(cfg, tiers["exact"].cim, "cpu")
    sen = LaneSentinel(ref_lm, params, tiers["balanced"].nmed)
    before = [{n: t.clone() for n, t in layer.items()}
              for layer in lane.caches["layers"]]
    tok, pos = lane.slot_tokens.copy(), lane.slot_pos.copy()
    shadow = sen.shadow(lane)
    for layer, old in zip(lane.caches["layers"], before):
        for n in ("k", "v", "pos"):
            assert torch.equal(layer[n], old[n])
    assert (lane.slot_tokens == tok).all() and (lane.slot_pos == pos).all()
    # the score is the exact rung's own decode of the same state
    copy = {"layers": [{n: t.clone() for n, t in layer.items()}
                       for layer in before]}
    with torch.inference_mode():
        want, _ = ref_lm.decode_step(
            params, copy, torch.as_tensor(tok[:, None]),
            torch.as_tensor(pos.astype(np.int32)))
    assert np.array_equal(shadow, want[:, -1].float().numpy())
    assert shadow.shape == (2, cfg.vocab) and shadow.dtype == np.float32


def test_chip_smoke_phase_12_rehearsed_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 12 end to end on the CPU at the smoke config
    (the kernels' plain versions, narrow GEMM shapes): the magnitude-table
    kernel's checks, the clean ladder's drift measured, the faulted ladder
    at the Table V rate (every approximate lane trips within 8 tokens and
    stays quarantined, no request fails, the exact lane's tokens the
    exact-only run's), the
    clean armed ladder (0 trips, the unarmed ladder's tokens), the recovery
    drill and the faulted convs all pass,
    and every launch check expects the card's counts while the CPU
    launches nothing.  The timer and the profiler stand in for the
    card's."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_p12", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    shapes = ((64, 64), (128, 64))
    monkeypatch.setattr(cs, "WEIGHT_SHAPES", shapes)
    monkeypatch.setattr(cs, "MAIN_SHAPES",
                        [(m, k, n) for m in (4, 64) for (k, n) in shapes])
    monkeypatch.setattr(cs, "FAULT_DEVICE", "cpu")
    monkeypatch.setattr(cs, "FAULT_CONV_BATCH", 2)
    monkeypatch.setattr(cs, "_fault_config",
                        lambda: get_config(ARCH, smoke=True))
    monkeypatch.setattr(cs, "_timed_ms",
                        lambda torch, fn, reps, flush: (fn(), 1.0)[1])
    profiled = []
    monkeypatch.setattr(cs, "_profile", lambda torch, lane, run, s, **kw: (
        profiled.append(lane), run()))
    checks = []
    monkeypatch.setattr(cs, "_expect_launches",
                        lambda where, got, want: checks.append(
                            (where, got, want)))
    path_launches, check_launches, rows = cs.fault_phase(torch, "cpu", 132,
                                                         1.98e9)
    assert path_launches == {} and check_launches == {}
    assert [r["shape"] for r in rows] == cs.MAIN_SHAPES
    assert all(got == {} for _, got, _ in checks)
    wants = {where: want for where, _, want in checks}
    per_fwd = cs.GEMMS_PER_LAYER * get_config(ARCH, smoke=True).n_layers
    faulted = wants["phase 12 (b) faulted ladder"]
    assert set(faulted) == set(cs.FAULT_INT.values())
    assert all(v > 0 and v % per_fwd == 0 for v in faulted.values())
    assert wants["phase 12 (b) exact-only"] == {}
    for fam in ("exact", "appro42"):
        assert wants[f"phase 12 (d) {fam}"] == {"lut_matmul_mag": 1}
    for fam in ("mitchell", "log_our"):
        assert wants[f"phase 12 (d) {fam}"] == {"mitchell_matmul": 1}
    assert profiled == [f"faulted {n}" for n in cs.FAULT_INT]
    out = capsys.readouterr().out
    assert "the clean armed ladder 0 trips, its tokens the unarmed" in out
    assert "clean balanced at full width" in out
    assert "identical to the exact-only run" in out
    assert "every faulted lane still quarantined" in out
    assert "probe passed" in out and "phase 12 took" in out
    # the faulted ladder's probe cooldown: its measured round and the
    # cooldown it gave (printed to 3 and 2 places), each faulted lane's
    # forwards in probes and else
    m = re.search(r"the ladder's round ([0-9.]+) s .* a probe cooldown of "
                  r"([0-9.]+) s", out)
    rnd, cooldown = float(m.group(1)), float(m.group(2))
    assert abs(cooldown - max(cs.FAULT_COOLDOWN_S,
                              cs.FAULT_COOLDOWN_ROUNDS * rnd)) < 0.02
    for name in cs.FAULT_INT:
        assert re.search(rf"{name} \d+ \(\d+ in \d+ probes, \d+ else\)",
                         out), name


def test_chip_smoke_counts_probes_from_the_quarantine():
    """chip_smoke.py's phase 12 splits a faulted lane's forwards into its
    half-open probes and the rest by the lane's quarantine: on the smoke
    LM the forwards before a trip are not counted, and a forced trip and
    one passing probe are one probe of a prefill and probe_rounds decode
    rounds."""
    import importlib.util
    import os

    from repro_torch.serving import Request

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_probes", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = get_config(ARCH, smoke=True)
    eng = build_engine(cfg, LM(cfg, "cpu").init(0), tiers=cs._fault_tiers(),
                       sentinel_cfg=SentinelConfig(cooldown_s=0.0),
                       **cs._fault_engine_kw("cpu"))
    eng.warmup()
    probes = cs._quarantined_forwards(eng, ["balanced"])
    rng = np.random.default_rng(5)
    for i in range(2):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, (6,)),
                           max_new=8, tier="balanced"))
    eng.step(0.0)
    lane = eng.lanes["balanced"]
    assert lane.running and probes == {"balanced": [0, 0]}
    eng._trip(lane, 0.01, "forced")
    eng.step(0.02)                      # the half-open probe fires here
    assert not lane.quarantined
    assert probes == {"balanced": [1, 1 + SentinelConfig().probe_rounds]}
