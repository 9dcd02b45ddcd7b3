"""The telemetry's contract on one device: its cost in serving tokens/s
and a lifecycle trace (the port's counterpart of the JAX package's
``benchmarks/bench_obs.py``).

    PYTHONPATH=src python -m repro_torch.launch.obs --layers 8
    PYTHONPATH=src python -m repro_torch.launch.obs --device cpu --smoke

Both sections serve qwen3-1.7b at its published widths, cut to
`--layers` of its 28 layers (``--smoke``: the smoke config, the CPU's
size), on the compiler's default mode, ``build_tiers(mode="surrogate")``:
on the card every approximate GEMM runs the fused surrogate kernel
(``cim_gemm_fused``).  BENCH_obs serves ``build_tiers()``'s
surrogate_fast, which routes the plain fake-quant form in both packages
and so would measure the hooks on a path without a CiM kernel.

overhead: BENCH_obs's mix (exact / balanced / economy 0.3 / 0.4 / 0.3,
4-8-token prompts, 8-24 new tokens, 24 requests) served by ONE engine
with an `EngineTelemetry` attached and detached in turn: `PAIRS`
off/on pairs, which arm runs first alternating, every pool reset between
runs (no second warmup).  BENCH_obs draws the arrivals at 600/s; here
all arrive at time 0, so the schedule does not depend on the host clock
and the timed runs are the checked ones: tokens identical in every run,
no plan built after warmup, and, over the telemetry-on runs, the live
``repro_dispatch_macs_total`` equal to the meters' MACs.  Reported: the
median of the per-pair tokens/s ratios (on / off), their spread, and
each lane's estimated energy per token (the FreePDK45 per-MAC model of
core/energy_model.py, not a device number).  Then the hooks' cost where
they run, with less drift between the arms: on each lane `ROUND_PAIRS`
adjacent pairs of pool decode rounds, the dispatch sink attached and
detached in turn, on the host clock; the median of the per-pair ratios.

trace: ``spec_decode=2``, ``spec_rounds=2``, sentinels with period 2 and
one forced trip of the balanced lane as soon as it holds in-flight work
(bench_obs's trace section, 16 Poisson requests at 800/s): the Chrome
trace (`--trace-out`, else a temporary directory) must hold the queue,
prefill, decode, decode_round, spec_round and retry spans and load as
JSON.

Prints a line per section and one JSON object.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import tempfile
import time
from collections import deque

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import LM
from repro_torch.obs import EngineTelemetry, write_chrome_trace
from repro_torch.serving import (RealClock, SentinelConfig, build_engine,
                                 build_tiers, poisson_workload)

MODE = "surrogate"            # the approximate tiers' mode
PAIRS = 5                     # telemetry off/on pairs of the overhead
ROUND_PAIRS = 20              # off/on decode-round pairs a lane
BOUND = 0.03                  # BENCH_obs's overhead contract (reported)
MIX = (("exact", None, 0.3), ("balanced", None, 0.4),
       ("economy", None, 0.3))
TRACE_MIX = (("exact", None, 0.4), ("balanced", None, 0.4),
             ("economy", None, 0.2))
REQUIRED_SPANS = {"queue", "prefill", "decode", "decode_round",
                  "spec_round", "retry"}


def config(layers: int, smoke: bool = False):
    """qwen3-1.7b at its published widths and `layers` of its layers (0:
    all), or its smoke config."""
    cfg = get_config("qwen3-1.7b", smoke=smoke)
    if layers and layers < cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=layers, n_periods=layers)
    return cfg


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def overhead_engine(cfg, params, dev):
    """The overhead section's engine, its telemetry attached and warmed
    (the meters profiled, the pools reset, the plan-miss probe armed)."""
    tel = EngineTelemetry()
    eng = build_engine(cfg, params, tiers=build_tiers(mode=MODE),
                       slots_per_tier=4, max_len=96, prompt_buckets=(8,),
                       group_buckets=(1, 2), telemetry=tel, device=dev)
    eng.warmup()
    return eng, tel


def overhead_workload(cfg, n_requests: int = 24, seed: int = 0):
    wl = poisson_workload(n_requests, 600.0, cfg.vocab, prompt_len=(4, 8),
                          max_new=(8, 24), tier_mix=MIX, seed=seed)
    for r in wl:
        r.arrival = 0.0
    return wl


def _serve(eng, wl, dev):
    """One run from fresh pools: (tokens by rid, tokens/s on the
    engine's clock)."""
    for lane in eng.lanes.values():
        lane.backend.reset()
    res = eng.run(wl)
    _sync(dev)
    if not all(r.done and r.status == "ok" for r in res.values()):
        raise RuntimeError("the overhead workload did not complete")
    toks = {rid: list(r.tokens) for rid, r in res.items()}
    return toks, sum(len(t) for t in toks.values()) / eng.last_run_s


def overhead(eng, tel, wl, dev) -> dict:
    """`PAIRS` interleaved telemetry-off/on runs of `wl` on `eng`.  Fails
    if a run's tokens differ from the first's, if a plan was built after
    warmup, or if the live dispatch MACs of the telemetry-on runs differ
    from the meters'."""
    runs, first = [], None
    live = meters = 0.0
    for i in range(PAIRS):
        pair = {}
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            if on:
                tel.attach()
                eng.telemetry = tel
            else:
                tel.detach()
                eng.telemetry = None
            mac0 = tel.dispatch_macs.total
            met0 = sum(m.macs for m in tel.meters.values())
            toks, tps = _serve(eng, wl, dev)
            live += tel.dispatch_macs.total - mac0
            meters += sum(m.macs for m in tel.meters.values()) - met0
            if first is None:
                first = toks
            elif toks != first:
                raise RuntimeError(f"run {len(runs)} (telemetry "
                                   f"{'on' if on else 'off'}) served other "
                                   "tokens than the first run")
            pair["on" if on else "off"] = tps
        runs.append(pair)
    tel.attach()
    eng.telemetry = tel
    if eng.steady_plan_misses() != 0:
        raise RuntimeError(f"{eng.steady_plan_misses()} plans built after "
                           "warmup")
    if live != meters:
        raise RuntimeError(f"live dispatch MACs {live} != the meters' "
                           f"{meters} over the telemetry-on runs")
    ratios = sorted(p["on"] / p["off"] for p in runs)
    med = statistics.median(ratios)
    lanes = eng.metrics()["lanes"]
    return {"pairs": runs, "ratio_median": med,
            "ratio_spread": [ratios[0], ratios[-1]],
            "overhead_frac": 1.0 - med, "overhead_bound": BOUND,
            "overhead_within_bound": bool(1.0 - med <= BOUND),
            "tokens_per_s_off_median": statistics.median(
                p["off"] for p in runs),
            "tokens_per_s_on_median": statistics.median(
                p["on"] for p in runs),
            "tokens": sum(len(t) for t in first.values()),
            "macs_live": live, "macs_meters": meters,
            "steady_plan_misses": eng.steady_plan_misses(),
            "energy_per_token_j": {n: d["energy_per_token_j"]
                                   for n, d in lanes.items()}}


def round_ab(eng, tel, dev) -> dict:
    """Each lane's pool decode round with the telemetry's sinks detached
    and attached, `ROUND_PAIRS` adjacent pairs (which runs first
    alternating) on the host clock ending in a synchronize: the median
    and spread of the per-pair ratios (on / off) and the median off ms."""
    out = {}
    for name, lane in eng.lanes.items():
        b = lane.backend
        b.reset()
        ratios, off = [], []
        for i in range(ROUND_PAIRS):
            secs = {}
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                if on:
                    tel.attach()
                else:
                    tel.detach()
                t = time.perf_counter()
                b.decode_round()
                _sync(dev)
                secs[on] = time.perf_counter() - t
            ratios.append(secs[True] / secs[False])
            off.append(1e3 * secs[False])
        b.reset()
        ratios.sort()
        out[name] = {"ratio_median": statistics.median(ratios),
                     "ratio_spread": [ratios[0], ratios[-1]],
                     "off_ms_median": statistics.median(off)}
    tel.attach()
    return out


def trace_engine(cfg, params, dev):
    tel = EngineTelemetry()
    eng = build_engine(cfg, params, tiers=build_tiers(mode=MODE),
                       slots_per_tier=2, max_len=64, prompt_buckets=(8,),
                       group_buckets=(1, 2), spec_decode=2, spec_rounds=2,
                       sentinel_cfg=SentinelConfig(period=2), telemetry=tel,
                       device=dev)
    eng.warmup()
    return eng, tel


def trace(eng, tel, cfg, dev, path: str) -> dict:
    """Serve the trace workload with one forced trip of the balanced lane
    (the run loop inlined, as bench_obs's trace section does), write the
    Chrome trace to `path` and check its spans."""
    wl = poisson_workload(16, 800.0, cfg.vocab, prompt_len=(4, 8),
                          max_new=(6, 16), tier_mix=TRACE_MIX, seed=0)
    clock = RealClock()
    eng._clock = clock
    t0 = clock.now()
    pending = deque(sorted(wl, key=lambda r: r.arrival))
    forced = False
    for _ in range(200_000):
        now = clock.now()
        while pending and pending[0].arrival <= now:
            eng.submit(pending.popleft())
        eng.step(now)
        lane = eng.lanes["balanced"]
        if not forced and lane.running:
            eng._trip(lane, clock.now(), "forced (launch/obs.py trace)")
            forced = True
        busy = any(l.running for l in eng.lanes.values())
        queued = any(l.queue for l in eng.lanes.values())
        if not (pending or busy or queued or eng._deferred):
            break
        if not busy and (pending or eng._deferred):
            clock.wait_until(min([r.arrival for r in list(pending)[:1]]
                                 + [t for t, _ in eng._deferred]))
    else:
        raise RuntimeError("the trace workload did not drain")
    _sync(dev)
    eng.last_run_s = clock.now() - t0
    spans = tel.registry.spans.items()
    names = {s.name for s in spans}
    write_chrome_trace(spans, path, tid_names=tel.tid_names)
    with open(path) as f:                 # the file Perfetto will load
        events = json.load(f)["traceEvents"]
    m = eng.metrics()
    missing = sorted(REQUIRED_SPANS - names)
    if not forced:
        raise RuntimeError("the balanced lane never held in-flight work")
    if missing:
        raise RuntimeError(f"the trace lacks the spans {missing}")
    if eng.steady_plan_misses() != 0:
        raise RuntimeError(f"{eng.steady_plan_misses()} plans built after "
                           "warmup")
    return {"trace_path": path, "n_requests": len(wl), "spans": len(spans),
            "spans_dropped": tel.registry.spans.dropped,
            "trace_events": len(events), "span_names": sorted(names),
            "trips": [dict(lane=t.lane, reason=t.reason,
                           tokens_before_trip=t.tokens_before_trip)
                      for t in eng.trip_log],
            "retries": sum(d["retries"] for d in m["lanes"].values()),
            "n_failed": m["n_failed"], "duration_s": eng.last_run_s,
            "energy_per_token_j": {n: d["energy_per_token_j"]
                                   for n, d in m["lanes"].items()},
            "steady_plan_misses": eng.steady_plan_misses()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=8,
                    help="layers of qwen3-1.7b's 28 to serve (0 = all)")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the smoke config (the CPU's size)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="where to write the Chrome trace (default: a "
                         "temporary directory)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = None
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip().splitlines()[0]
        print(f"{card}; torch {torch.__version__}", flush=True)
    cfg = config(args.layers, args.smoke)
    params = LM(cfg, dev).init(0)
    t = time.perf_counter()
    eng, tel = overhead_engine(cfg, params, dev)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}; "
          f"{MODE} ladder built and warmed in {time.perf_counter() - t:.1f}s",
          flush=True)
    ovh = overhead(eng, tel, overhead_workload(cfg), dev)
    print(f"overhead: {PAIRS} pairs, {ovh['tokens']} tokens a run; tokens/s "
          f"off {ovh['tokens_per_s_off_median']:.2f}, on "
          f"{ovh['tokens_per_s_on_median']:.2f}; on/off median "
          f"{ovh['ratio_median']:.4f} (spread {ovh['ratio_spread'][0]:.4f} - "
          f"{ovh['ratio_spread'][1]:.4f}), overhead "
          f"{100 * ovh['overhead_frac']:.2f}% (bound "
          f"{100 * BOUND:.0f}%: {'met' if ovh['overhead_within_bound'] else 'missed'}); "
          f"MACs live {ovh['macs_live']:.0f} = meters; J/token "
          + ", ".join(f"{n} {v:.4e}"
                      for n, v in ovh["energy_per_token_j"].items()),
          flush=True)
    rnd = round_ab(eng, tel, dev)
    tel.detach()
    print(f"decode rounds, {ROUND_PAIRS} off/on pairs a lane: " + "; ".join(
        f"{n} off {d['off_ms_median']:.2f} ms, on/off {d['ratio_median']:.4f} "
        f"({d['ratio_spread'][0]:.4f} - {d['ratio_spread'][1]:.4f})"
        for n, d in rnd.items()), flush=True)
    del eng
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace_out or os.path.join(tmp, "obs.trace.json")
        eng, tel = trace_engine(cfg, params, dev)
        trc = trace(eng, tel, cfg, dev, path)
        tel.detach()
    print(f"trace: {trc['spans']} spans ({trc['span_names']}), "
          f"{trc['trace_events']} trace events, {len(trc['trips'])} trips, "
          f"{trc['retries']} retries, {trc['n_failed']} failed -> "
          f"{trc['trace_path']}", flush=True)
    out = {"device": card or dev.type, "arch": cfg.name,
           "layers": cfg.n_layers, "mode": MODE, "overhead": ovh,
           "rounds": rnd, "trace": trc}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
