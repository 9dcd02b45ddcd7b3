"""PyTorch port, telemetry (obs/) held to the JAX package on the CPU.

  * the metrics core: the JAX package's own cases, run on both packages'
    classes;
  * the exporters: for the same instrument calls, `prometheus_text`,
    `chrome_trace` and `events_jsonl` byte-equal to the reference's;
  * the serving hooks: the reference's engine and the port's on
    equivalent fake lanes, the same SimClock workload and a forced trip,
    give identical spans (name, t0, dur, tid, labels), events and
    serving metrics;
  * the dispatch sink: each frontend's op, labels and MAC count as the
    reference announces them; the attention block's autotune outcomes;
    `detach()` restores all four sinks;
  * energy: the port's meters, which profile by running each call, equal
    the reference's `eval_shape` profiles on the smoke LM (decode, every
    prefill bucket, a k = 2 spec sub-round) on the hardware and
    surrogate_fast ladders, MACs exactly and Joules to 1e-12 relative;
  * a CPU engine with the telemetry on serves the tokens and logits of
    one without, bitwise, builds no plan after warmup, and its live
    dispatch MACs equal its meters'; the launcher's --metrics /
    --trace-out write files that parse.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.obs.metrics as jmetrics
import repro_torch.obs as tobs
import repro_torch.obs.metrics as tmetrics
from repro.configs import get_config as jget_config
from repro.serving import ServingEngine as JServingEngine
from repro.serving import SimClock as JSimClock
from repro.serving import TripEvent as JTripEvent
from repro.serving import build_engine as jbuild_engine
from repro.serving import build_tiers as jbuild_tiers
from repro.serving.tiers import TierRouter as JTierRouter
from repro_torch.configs import get_config
from repro_torch.core import allocate, approx_gemm, autotune, error_model
from repro_torch.serving import (ServingEngine, SimClock, TripEvent,
                                 build_engine, build_tiers, poisson_workload)
from repro_torch.serving.tiers import TierRouter
from test_serving import FakeLane as JFakeLane
from test_serving import _fake_tiers as _jfake_tiers
from test_serving import _req as _jreq
from test_torch_serving import FakeLane, _fake_tiers, _req

ARCH = "qwen3-1.7b"
PKGS = {"jax": jmetrics, "torch": tmetrics}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's small torch ops, restored
    after it (next to other test workers, torch's default pool waits on
    cores they hold)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _no_global_sink():
    """Every test starts and ends with no sink installed anywhere."""
    mods = (approx_gemm, autotune, error_model, allocate)
    prev = [m.set_obs_sink(None) for m in mods]
    yield
    for m, p in zip(mods, prev):
        m.set_obs_sink(p)


# ---------------------------------------------------------------------------
# (1) the metrics core, on both packages' classes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", list(PKGS))
def test_counter_labels_and_total(pkg):
    c = PKGS[pkg].Counter("x_total")
    c.inc()
    c.inc(2, op="gemm", family="appro42")
    c.inc(3, family="appro42", op="gemm")    # label order-insensitive
    assert c.value() == 1
    assert c.value(op="gemm", family="appro42") == 5
    assert c.value(op="conv") == 0.0
    assert c.total == 6


@pytest.mark.parametrize("pkg", list(PKGS))
def test_gauge_last_write_wins(pkg):
    g = PKGS[pkg].Gauge("x")
    g.set(1.5, tier="a")
    g.set(2.5, tier="a")
    assert g.value(tier="a") == 2.5
    assert g.value(tier="b") is None


@pytest.mark.parametrize("pkg", list(PKGS))
def test_histogram_bucketing_inclusive_bounds(pkg):
    h = PKGS[pkg].Histogram("h", buckets=(0.1, 0.3, 1.0))
    for v in (0.05, 0.1, 0.3, 0.7, 5.0):     # bounds are inclusive (le=)
        h.observe(v, tier="a")
    snap = h.snapshot(tier="a")
    assert snap["buckets"] == [(0.1, 2.0), (0.3, 3.0), (1.0, 4.0),
                               (float("inf"), 5.0)]
    assert snap["count"] == 5
    assert snap["sum"] == pytest.approx(6.15)
    assert h.snapshot(tier="b")["count"] == 0


@pytest.mark.parametrize("pkg", list(PKGS))
def test_histogram_rejects_bad_buckets(pkg):
    with pytest.raises(ValueError):
        PKGS[pkg].Histogram("h", buckets=())
    with pytest.raises(ValueError):
        PKGS[pkg].Histogram("h", buckets=(1.0, 0.5))


@pytest.mark.parametrize("pkg", list(PKGS))
def test_ring_wraparound_and_drop_accounting(pkg):
    r = PKGS[pkg].Ring(4)
    for i in range(3):
        r.append(i)
    assert r.items() == [0, 1, 2] and r.dropped == 0
    for i in range(3, 7):
        r.append(i)
    assert len(r) == 4
    assert r.items() == [3, 4, 5, 6]         # oldest dropped, order kept
    assert r.total == 7 and r.dropped == 3
    r.clear()
    assert len(r) == 0 and r.total == 0 and r.items() == []
    with pytest.raises(ValueError):
        PKGS[pkg].Ring(0)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_disabled_registry_is_noop(pkg):
    reg = PKGS[pkg].MetricsRegistry(enabled=False)
    c = reg.counter("c_total")
    h = reg.histogram("h", (1.0,))
    g = reg.gauge("g")
    c.inc(5)
    g.set(1.0)
    h.observe(0.5)
    reg.span("s", 0.0, 1.0)
    reg.event("e", 0.0)
    assert c.total == 0 and g.value() is None
    assert h.snapshot()["count"] == 0
    assert len(reg.spans) == 0 and len(reg.events) == 0


@pytest.mark.parametrize("pkg", list(PKGS))
def test_registry_factories_idempotent(pkg):
    reg = PKGS[pkg].MetricsRegistry()
    assert reg.counter("a") is reg.counter("a")
    assert reg.histogram("h", (1.0,)) is reg.histogram("h", (2.0,))


# ---------------------------------------------------------------------------
# (2) the exporters: byte-equal to the reference's
# ---------------------------------------------------------------------------


def _fill(m):
    """The same instrument calls on a registry of package `m`."""
    reg = m.MetricsRegistry(span_capacity=8, event_capacity=4)
    c = reg.counter("repro_calls_total", "calls")
    c.inc(3, op="gemm", bits=8)
    c.inc(1, op="conv", bits=8)
    c.inc(2.5, op="attn", bits=4)
    reg.counter("repro_empty_total")                # no samples
    reg.gauge("repro_agree", "agreement").set(0.5, tier="a")
    reg.gauge("repro_agree").set(1 / 3, tier="b")
    h = reg.histogram("repro_wait_seconds", (0.1, 1.0), "wait")
    for v in (0.05, 0.5, 7.0, 1e-9, 0.1):
        h.observe(v)
        h.observe(v * 3, tier="x")
    for i in range(11):                             # the ring wraps
        reg.span("decode" if i % 2 else "queue", 0.1 * i, 0.01 * i - 0.02,
                 tid=i % 3 - 1, tier="a", cat="serving" if i % 4 else "x",
                 rid=i)
    for i in range(6):
        reg.event("trip", 0.25 * i, lane="a", n=i)
    return reg


def test_prometheus_text_golden():
    """The reference's own golden text, rendered by the port."""
    reg = tobs.MetricsRegistry()
    c = reg.counter("repro_calls_total", "calls")
    c.inc(3, op="gemm")
    c.inc(1, op="conv")
    reg.gauge("repro_agree", "agreement").set(0.5, tier="a")
    h = reg.histogram("repro_wait_seconds", (0.1, 1.0), "wait")
    h.observe(0.05)
    h.observe(0.5)
    h.observe(7.0)
    assert tobs.prometheus_text(reg) == (
        "# HELP repro_calls_total calls\n"
        "# TYPE repro_calls_total counter\n"
        'repro_calls_total{op="conv"} 1\n'
        'repro_calls_total{op="gemm"} 3\n'
        "# HELP repro_agree agreement\n"
        "# TYPE repro_agree gauge\n"
        'repro_agree{tier="a"} 0.5\n'
        "# HELP repro_wait_seconds wait\n"
        "# TYPE repro_wait_seconds histogram\n"
        'repro_wait_seconds_bucket{le="0.1"} 1\n'
        'repro_wait_seconds_bucket{le="1"} 2\n'
        'repro_wait_seconds_bucket{le="+Inf"} 3\n'
        "repro_wait_seconds_sum 7.55\n"
        "repro_wait_seconds_count 3\n")


def test_exporters_byte_equal_to_the_reference(tmp_path):
    jreg, treg = _fill(jmetrics), _fill(tmetrics)
    assert tobs.prometheus_text(treg) == jobs.prometheus_text(jreg)
    names = {-1: "lane a", 0: "request zero"}
    kw = dict(pid=3, process_name="p", tid_names=names)
    assert json.dumps(tobs.chrome_trace(treg.spans.items(), **kw)) == \
        json.dumps(jobs.chrome_trace(jreg.spans.items(), **kw))
    jobs.write_chrome_trace(jreg.spans.items(), str(tmp_path / "j.json"),
                            tid_names=names)
    tobs.write_chrome_trace(treg.spans.items(), str(tmp_path / "t.json"),
                            tid_names=names)
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert treg.spans.dropped == jreg.spans.dropped == 3
    kw = dict(tokens_before_trip=7, in_flight_displaced=2,
              trigger_agree=0.25, trigger_nmed=None)
    jev = list(jreg.events.items()) + [JTripEvent("a", 1.0, "drift", **kw)]
    tev = list(treg.events.items()) + [TripEvent("a", 1.0, "drift", **kw)]
    assert tobs.events_jsonl(tev, str(tmp_path / "t.jsonl")) == \
        jobs.events_jsonl(jev, str(tmp_path / "j.jsonl"))
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()


def test_chrome_trace_structure():
    spans = [tobs.Span("decode", 1.0, 0.5, tid=3,
                       labels={"tier": "a", "cat": "serving"}),
             tobs.Span("decode_round", 2.0, -0.1, tid=-1, labels={})]
    out = tobs.chrome_trace(spans, tid_names={-1: "lane a"})
    assert out["displayTimeUnit"] == "ms"
    x = [e for e in out["traceEvents"] if e["ph"] == "X"]
    assert x[0]["ts"] == 1e6 and x[0]["dur"] == 5e5
    assert x[0]["args"] == {"tier": "a"}         # cat lifted, not an arg
    assert x[1]["dur"] == 0.0                    # negative dur clamped
    names = {e["tid"]: e["args"]["name"] for e in out["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names == {3: "request 3", -1: "lane a"}


# ---------------------------------------------------------------------------
# (3) the serving hooks on fake lanes, against the reference engine
# ---------------------------------------------------------------------------


def _engines(**kw):
    """The reference's engine and the port's on equivalent fake lanes,
    each with an unattached, energy-less telemetry."""
    jtel = jobs.EngineTelemetry(attach=False, energy=False)
    ttel = tobs.EngineTelemetry(attach=False, energy=False)
    jt, tt = _jfake_tiers(), _fake_tiers()
    jeng = JServingEngine({t.name: JFakeLane(3) for t in jt},
                          JTierRouter(jt), check_invariants=True,
                          telemetry=jtel, **kw)
    teng = ServingEngine({t.name: FakeLane(3) for t in tt},
                         TierRouter(tt), check_invariants=True,
                         telemetry=ttel, **kw)
    jeng.warmup()
    teng.warmup()
    return (jeng, jtel), (teng, ttel)


def _spans(tel):
    return [(s.name, s.t0, s.dur, s.tid, s.labels)
            for s in tel.registry.spans.items()]


def _serving_text(tel, m):
    text = m.prometheus_text(tel.registry)
    return [ln for ln in text.splitlines() if "repro_serving_" in ln]


def _drive(eng, req, clock):
    """A SimClock run, then three requests on lane b, one step, a forced
    trip of b, and steps until its displaced work drains on a."""
    res = eng.run([req(i, tier="ab"[i % 2], max_new=2 + i % 3,
                       arrival=0.01 * i) for i in range(6)], clock=clock)
    assert all(r.done for r in res.values())
    for i in range(3):
        eng.submit(req(10 + i, tier="b", max_new=4))
    eng.step(1.0)
    lane = eng.lanes["b"]
    assert lane.running
    eng._trip(lane, 1.5, "forced (test)")
    for t in range(1, 40):
        eng.step(1.5 + 0.1 * t)
        if all(r.done for r in eng.results.values()):
            break
    assert all(r.done and r.status == "ok" for r in eng.results.values())


def test_fake_lane_spans_events_and_metrics_equal_the_reference():
    (jeng, jtel), (teng, ttel) = _engines(retry_backoff_s=0.0)
    _drive(jeng, _jreq, JSimClock())
    _drive(teng, _req, SimClock())
    assert _spans(ttel) == _spans(jtel)
    names = {s[0] for s in _spans(ttel)}
    assert {"queue", "prefill", "decode", "decode_round", "retry"} <= names
    assert list(ttel.registry.events.items()) == \
        list(jtel.registry.events.items())
    assert [e["kind"] for e in ttel.registry.events.items()] == \
        ["sentinel_trip", "breaker_transition"]
    assert _serving_text(ttel, tobs) == _serving_text(jtel, jobs)
    assert ttel.tid_names == jtel.tid_names
    tm, jm = teng.metrics(), jeng.metrics()
    for name in ("a", "b"):
        for key in ("tokens", "trips", "retries", "quarantined", "energy_j",
                    "energy_per_token_j", "acceptance_rate",
                    "tokens_per_round", "draft_k"):
            assert tm["lanes"][name][key] == jm["lanes"][name][key], key
    assert tm["steady_plan_misses"] == jm["steady_retraces"] == 0


def test_failed_request_is_recorded_as_the_reference_does():
    """A trip past the retry budget: the request fails, and both
    engines record the same request_failed event and counters."""
    (jeng, jtel), (teng, ttel) = _engines(retry_budget=0)
    for eng, req in ((jeng, _jreq), (teng, _req)):
        eng.submit(req(0, tier="b", max_new=4))
        eng.step(0.0)
        eng._trip(eng.lanes["b"], 0.5, "forced (test)")
        assert eng.results[0].status == "failed"
    assert list(ttel.registry.events.items()) == \
        list(jtel.registry.events.items())
    assert _serving_text(ttel, tobs) == _serving_text(jtel, jobs)


# ---------------------------------------------------------------------------
# the dispatch and autotune sinks
# ---------------------------------------------------------------------------


def _capture(fn, *args, **kw):
    with tobs.capture_macs() as cap:
        fn(*args, **kw)
    return cap


@pytest.mark.parametrize("op", ["gemm", "model_gemm", "conv", "attn"])
def test_frontends_announce_the_references_macs(op):
    """Each frontend's op and MAC count, captured live in the port and
    by the reference's eval_shape profile, at a ragged shape."""
    import jax.numpy as jnp

    from repro.core import approx_gemm as jag

    rng = np.random.default_rng(0)
    fam = dict(family="appro42", bits=8, mode="hardware")
    gp, jgp = approx_gemm.GemmParams(**fam), jag.GemmParams(**fam)
    if op in ("gemm", "model_gemm"):
        x = rng.standard_normal((3, 5, 24)).astype(np.float32)
        w = rng.standard_normal((24, 7)).astype(np.float32)
        tf = (approx_gemm.cim_matmul if op == "gemm"
              else approx_gemm.model_matmul)
        jf = jag.cim_matmul if op == "gemm" else jag.model_matmul
        args, jargs = (torch.from_numpy(x), torch.from_numpy(w)), \
            (jnp.asarray(x), jnp.asarray(w))
        kw = {}
    elif op == "conv":
        x = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
        w = rng.standard_normal((5 * 5 * 3, 6)).astype(np.float32)
        tf, jf = approx_gemm.cim_conv2d, jag.cim_conv2d
        args, jargs = (torch.from_numpy(x), torch.from_numpy(w)), \
            (jnp.asarray(x), jnp.asarray(w))
        kw = dict(kh=5, kw=5, stride=2)
    else:
        q = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
        k = rng.standard_normal((2, 11, 2, 8)).astype(np.float32)
        tf, jf = approx_gemm.cim_attention, jag.cim_attention
        args = (torch.from_numpy(q), torch.from_numpy(k),
                torch.from_numpy(k))
        jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(k))
        kw = {}
    got = _capture(tf, *args, gp, **kw)
    want = jobs.profile_macs(lambda *a: jf(*a, jgp, **kw), *jargs)
    assert got.by_op == want.by_op and got.by_family == want.by_family
    assert got.total == want.total > 0


def test_dispatch_counts_every_call_and_plan_misses_as_retraces():
    tel = tobs.EngineTelemetry(energy=False)
    gp = approx_gemm.GemmParams(family="log_our", bits=6, mode="hardware")
    x, w = torch.randn(3, 40), torch.randn(40, 9)
    before = approx_gemm.plan_misses()
    for _ in range(3):
        approx_gemm.cim_matmul(x, w, gp)
    built = approx_gemm.plan_misses() - before
    lab = dict(op="gemm", family="log_our", mode="hardware", bits=6)
    assert tel.dispatch_calls.value(cache="miss", **lab) == built
    assert tel.dispatch_calls.value(cache="hit", **lab) == 3 - built
    assert tel.dispatch_macs.value(op="gemm", family="log_our",
                                   bits=6) == 3 * 3 * 40 * 9
    assert tel.retraces.total == built
    tel.detach()


def test_attention_block_resolution_is_told_to_the_sink():
    tel = tobs.EngineTelemetry(energy=False)
    autotune.clear_memory_cache()
    assert autotune.heuristic_attn_block("pallas_attn_lut", 8, 40) == \
        autotune.heuristic_attn_block("pallas_attn_lut", 8, 40) == (8, 64)
    assert tel.autotune_c.value(outcome="heuristic") == 1
    assert tel.autotune_c.value(outcome="mem_hit") == 1
    tel.detach()


def test_detach_restores_all_four_sinks():
    mods = (approx_gemm, autotune, error_model, allocate)
    tel = tobs.EngineTelemetry(energy=False)           # attaches
    assert all(m._OBS_SINK[0] is tel for m in mods)
    tel.detach()
    assert all(m._OBS_SINK[0] is None for m in mods)
    tel.detach()                                       # idempotent
    tel.attach()
    assert all(m._OBS_SINK[0] is tel for m in mods)
    tel.detach()
    off = tobs.EngineTelemetry(energy=False, attach=False)
    assert all(m._OBS_SINK[0] is None for m in mods)
    assert not off._attached


def test_capture_macs_is_scoped_and_restores_the_sink():
    outer = tobs.MacCapture()
    approx_gemm.set_obs_sink(outer)
    gp = approx_gemm.GemmParams(family="exact", bits=8, mode="exact")
    with tobs.capture_macs() as cap:
        approx_gemm.cim_matmul(torch.zeros(2, 4), torch.zeros(4, 3), gp)
    assert cap.total == 2 * 4 * 3 and cap.by_op == {"gemm": 24.0}
    assert outer.total == 0 and approx_gemm._OBS_SINK[0] is outer


# ---------------------------------------------------------------------------
# (4) energy: the meters against the reference's eval_shape profiles
# ---------------------------------------------------------------------------

ENGINE_KW = dict(slots_per_tier=4, max_len=32, prompt_buckets=(8, 16),
                 group_buckets=(1, 2, 4), spec_decode=2)


@pytest.mark.parametrize("mode", ["hardware", "surrogate_fast"])
def test_meters_equal_the_references_eval_shape_profiles(mode):
    jeng = jbuild_engine(jget_config(ARCH, smoke=True),
                         tiers=jbuild_tiers(mode=mode), **ENGINE_KW)
    teng = build_engine(get_config(ARCH, smoke=True),
                        tiers=build_tiers(mode=mode), device="cpu",
                        **ENGINE_KW)
    assert list(teng.lanes) == list(jeng.lanes)
    for name in teng.lanes:
        fb = jeng.router.tiers[name].energy_per_mac_j
        jm = jobs.LaneEnergyMeter(name, fallback_j_per_mac=fb)
        tm = tobs.LaneEnergyMeter(name, fallback_j_per_mac=fb)
        assert jm.build(jeng.lanes[name].backend)
        assert tm.build(teng.lanes[name].backend)
        assert set(tm._prefill) == set(jm._prefill) and len(tm._prefill) == 6
        assert set(tm._spec) == set(jm._spec) == ({2} if name == "exact"
                                                 else set())
        pairs = ([(tm._decode, jm._decode)]
                 + [(tm._prefill[k], jm._prefill[k]) for k in jm._prefill]
                 + [(tm._spec[k], jm._spec[k]) for k in jm._spec])
        for (tmacs, tj), (jmacs, jj) in pairs:
            assert tmacs == jmacs > 0
            assert tj == pytest.approx(jj, rel=1e-12, abs=0)
    # one call by family, and its energy, directly
    tb, jb = teng.lanes["balanced"].backend, jeng.lanes["balanced"].backend
    got = tobs.profile_macs(tb.lm.decode_step, tb.params, tb.caches,
                            torch.zeros((4, 1), dtype=torch.int64),
                            torch.zeros(4, dtype=torch.int32))
    want = jobs.profile_macs(jb.lm.decode_step, jb.params, jb.caches,
                             np.zeros((4, 1), np.int32),
                             np.zeros(4, np.int32))
    assert got.by_family == want.by_family and got.by_op == want.by_op
    assert tobs.macs_to_energy_j(got.by_family) == pytest.approx(
        jobs.macs_to_energy_j(want.by_family), rel=1e-12, abs=0)


def test_meter_is_inert_on_a_fake_lane():
    m = tobs.LaneEnergyMeter("a")
    assert not m.build(FakeLane(2)) and not m.profiled
    assert m.on_decode() == 0.0 and m.energy_per_token_j == 0.0


# ---------------------------------------------------------------------------
# (5, 6) the CPU engine with the telemetry on and off; the launcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """The smoke LM on the hardware ladder, served on one SimClock
    workload by an engine without telemetry and one with it."""
    cfg = get_config(ARCH, smoke=True)
    wl = poisson_workload(8, 100.0, cfg.vocab, prompt_len=(4, 8),
                          max_new=(3, 6), tier_mix=(("exact", None, 0.3),
                                                    ("balanced", None, 0.4),
                                                    ("economy", None, 0.3)),
                          seed=1)
    out = {}
    for on in (False, True):
        tel = tobs.EngineTelemetry() if on else None
        eng = build_engine(cfg, tiers=build_tiers(mode="hardware"),
                           slots_per_tier=2, max_len=32,
                           prompt_buckets=(8,), group_buckets=(1, 2),
                           record_logits=True, device="cpu", telemetry=tel)
        eng.warmup()
        macs0 = tel.dispatch_macs.total if on else None
        res = eng.run([dataclasses.replace(r) for r in wl], clock=SimClock())
        out[on] = dict(eng=eng, tel=tel, res=res, macs0=macs0,
                       macs=tel.dispatch_macs.total if on else None)
        if on:
            tel.detach()
    return out


def test_telemetry_leaves_tokens_and_logits_bitwise(served):
    off, on = served[False], served[True]
    assert set(on["res"]) == set(off["res"])
    for rid, r in off["res"].items():
        t = on["res"][rid]
        assert r.done and t.done and t.tokens == r.tokens
        assert len(t.logits) == len(r.logits)
        for a, b in zip(t.logits, r.logits):
            assert np.array_equal(a, b)
    assert on["eng"].steady_plan_misses() == 0
    assert off["eng"].steady_plan_misses() == 0
    m = on["eng"].metrics()
    assert m["steady_plan_misses"] == 0
    for name, d in m["lanes"].items():
        assert d["macs"] > 0 and d["energy_j"] > 0
        assert d["energy_per_token_j"] == d["energy_j"] / d["tokens"]
    # the approximate tiers spend less energy a MAC than the exact one
    ept = {n: d["energy_j"] / d["macs"] for n, d in m["lanes"].items()}
    assert ept["balanced"] < ept["exact"]


def test_live_dispatch_macs_equal_the_meters(served):
    on = served[True]
    tel = on["tel"]
    assert on["macs"] - on["macs0"] == sum(m.macs
                                           for m in tel.meters.values())
    assert tel.tokens_c.total == sum(len(r.tokens)
                                     for r in on["res"].values())
    spans = {s.name for s in tel.registry.spans.items()}
    assert {"queue", "prefill", "decode", "decode_round"} <= spans


def test_serve_launcher_writes_metrics_and_trace(tmp_path, monkeypatch,
                                                 capsys):
    from repro_torch.launch import serve

    mpath, tpath = tmp_path / "m.txt", tmp_path / "t.json"
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--n-requests", "4", "--max-new", "2",
        "4", "--metrics", str(mpath), "--trace-out", str(tpath)])
    serve.main()
    out = capsys.readouterr().out
    assert "J/token" in out
    text = mpath.read_text()
    assert "# TYPE repro_serving_tokens_total counter" in text
    for line in text.splitlines():
        if not line.startswith("#"):
            float(line.rsplit(" ", 1)[1].replace("+Inf", "inf"))
    evs = json.loads(tpath.read_text())["traceEvents"]
    assert {e["name"] for e in evs if e["ph"] == "X"} >= {
        "queue", "prefill", "decode", "decode_round"}
    assert all(m._OBS_SINK[0] is None
               for m in (approx_gemm, autotune, error_model, allocate))
    monkeypatch.setattr(sys, "argv", ["serve", "--device", "cpu",
                                      "--no-telemetry", "--metrics", "-"])
    with pytest.raises(SystemExit):
        serve.main()
