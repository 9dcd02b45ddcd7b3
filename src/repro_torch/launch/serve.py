"""Serving launcher: the continuous-batching CiM engine under a synthetic
Poisson arrival workload, on a CUDA device (or ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --mode hardware --slots 4 --n-requests 16

`--mode` sets the approximate tiers' execution mode: surrogate_fast (the
default), surrogate (the compiler's default mode: the fused surrogate
kernel on the card) or hardware (the bit-true kernels).
Builds the per-tier slot-pool engine over the DSE accuracy ladder, runs
every (tier x bucket) shape once (warmup), serves the workload, and
prints throughput, latency and the plan misses after warmup (0).
`--static` degrades admission to lockstep batching.  The smoke config
serves by default; `--full` serves the published widths and depth.

`--mesh MP` serves data-parallel + MP-way tensor-parallel over a
("data", "model") mesh of processes (launch/mesh.py): under ``torchrun``
over its world, else over `--ranks N` processes it starts itself, every
rank on ``cuda:{rank % device_count}`` (or the CPU), for example

    PYTHONPATH=src python -m repro_torch.launch.serve --mesh 2 --ranks 4 \\
        --device cpu --mode surrogate --n-requests 6 --max-new 2 6 \\
        --metrics -

Every `--mode` runs on shards: the integer modes (hardware, bit_exact)
and surrogate on the shard kernels (the approximate lanes' logits equal
one device's bit for bit), the float forms (the exact lane,
surrogate_fast) by tensor-parallel float products (allclose).  Every
rank records the telemetry; rank 0 prints the report and writes
`--metrics` and `--trace-out`, whose MACs are the global products'.

`--spec-decode K` makes the exact lane speculative (serving/spec.py): K
tokens a round drafted on the cheapest approximate tier (or
`--spec-drafter`), all verified in one pass of the exact rung with
per-token scales, `--spec-rounds` rounds a call; the tokens are the
per-token exact lane's.  It does not compose with `--mesh` here, as in
the JAX package's launcher (the engine, `build_engine(spec_decode=k,
mesh=...)`, serves it).

`--fault-rate P` serves an as-fabricated ladder: stuck-at faults at P a
bit cell (half stuck at 0, half at 1; `--fault-seed` picks the defect
map) in the approximate tiers' stored tables and weight words, which
needs an integer `--mode`; `--sentinel` arms a sentinel on each
approximate lane (shadow scores every `--sentinel-period` rounds, trip,
quarantine, restart on the exact lane within `--retry-budget` restarts,
probe), for example

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode hardware --fault-rate 0.02 --sentinel

`--sentinel` composes with `--mesh` (each rank shadow-scores its own
slots; the samples are summed over the data axes before any threshold);
`--fault-rate` does not (the shard kernels quantize their words on
load).  `--max-queued Q` bounds the admission queues (backpressure).

Telemetry (obs/) is on by default: the closing per-tier table carries
each lane's estimated energy per token (the FreePDK45 per-MAC model, not
a device measurement); `--metrics PATH` (``-`` for stdout) writes the
run's Prometheus text and `--trace-out PATH` its Chrome-trace JSON of
the request lifecycle spans (load it in Perfetto), for example

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --metrics - --trace-out build/serve.trace.json

`--no-telemetry` serves without it and refuses `--metrics` and
`--trace-out`.  Under `--mesh` every rank records and rank 0 writes.
"""

from __future__ import annotations

import argparse
import os

from repro_torch.configs import get_config
from repro_torch.core.faults import FAULT_MODES, FaultConfig
from repro_torch.serving import (EngineStats, RealClock, SentinelConfig,
                                 SharedClock, build_engine, build_tiers,
                                 poisson_workload, servable_archs)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b",
                    choices=servable_archs())
    ap.add_argument("--full", action="store_true",
                    help="serve the full-size config (default: smoke)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--slots", type=int, default=4,
                    help="slot-pool size per accuracy tier")
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--n-requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=100.0,
                    help="Poisson arrival rate (requests/s)")
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(8, 16),
                    metavar=("LO", "HI"))
    ap.add_argument("--max-new", type=int, nargs=2, default=(4, 32),
                    metavar=("LO", "HI"))
    ap.add_argument("--mode", default="surrogate_fast",
                    choices=("surrogate_fast", "surrogate", "hardware",
                             "bit_exact"),
                    help="execution mode of the approximate tiers")
    ap.add_argument("--static", action="store_true",
                    help="lockstep (static-batching) admission baseline")
    ap.add_argument("--mesh", type=int, default=0, metavar="MP",
                    help="serve data-parallel + MP-way tensor-parallel "
                         "over a mesh of processes (torchrun's world, or "
                         "--ranks); 0 = one device")
    ap.add_argument("--ranks", type=int, default=0, metavar="N",
                    help="with --mesh outside torchrun: start N ranks")
    ap.add_argument("--spec-decode", type=int, default=0, metavar="K",
                    help="speculative decoding on the exact lane: draft K "
                         "tokens a round on the cheapest approximate tier, "
                         "verify them in one pass of the exact rung with "
                         "per-token scales, which takes the exact rung's "
                         "place: the output is that rung's greedy decode "
                         "(checked on an H100 up to 8 slots x 9 "
                         "positions, serving/spec.py); 0 = off")
    ap.add_argument("--spec-drafter", default=None, metavar="TIER",
                    help="drafter tier for --spec-decode (default: the "
                         "cheapest-energy approximate rung)")
    ap.add_argument("--spec-rounds", type=int, default=4, metavar="R",
                    help="draft + verify rounds in one call (admission "
                         "waits up to R - 1 rounds for a free slot)")
    ap.add_argument("--fault-rate", type=float, default=0.0, metavar="P",
                    help="inject stuck-at faults into the approximate "
                         "tiers' stored tables and weight words at this "
                         "rate a bit cell, split evenly SA0/SA1 (needs an "
                         "integer --mode); 0 = as designed")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="defect-map seed for --fault-rate")
    ap.add_argument("--sentinel", action="store_true",
                    help="arm a sentinel on each approximate lane: shadow "
                         "scores against the exact reference; trip, "
                         "quarantine and restart on the exact lane on "
                         "drift")
    ap.add_argument("--sentinel-period", type=int, default=2, metavar="N",
                    help="shadow-score every Nth decode round")
    ap.add_argument("--max-queued", type=int, default=0, metavar="Q",
                    help="admission-queue bound (backpressure); 0 = "
                         "unbounded")
    ap.add_argument("--retry-budget", type=int, default=3, metavar="R",
                    help="restarts a request gets across sentinel trips "
                         "before it is marked failed")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write a Prometheus text exposition of the run's "
                         "telemetry at shutdown ('-' = stdout)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of the "
                         "per-request lifecycle spans (queue -> prefill -> "
                         "decode, retries, lane rounds)")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="serve without telemetry (the overhead baseline; "
                         "no --metrics/--trace-out and no energy column)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def serve(args, mesh=None, device=None) -> bool:
    """Build, warm and serve; print the report on rank 0 (or without a
    mesh).  Returns whether no plan was built after warmup."""
    fault = None
    if args.fault_rate > 0:
        fault = FaultConfig(p_sa0=args.fault_rate / 2,
                            p_sa1=args.fault_rate / 2, seed=args.fault_seed)
    sentinel_cfg = (SentinelConfig(period=args.sentinel_period)
                    if args.sentinel else None)
    telemetry = None
    if not args.no_telemetry:
        from repro_torch.obs import EngineTelemetry

        telemetry = EngineTelemetry()
    cfg = get_config(args.arch, smoke=not args.full)
    tiers = build_tiers(mode=args.mode)
    pmax = max(args.prompt_len)
    pbkts = tuple(sorted({b for b in (8, 16) if b < pmax} | {pmax}))
    engine = build_engine(
        cfg, tiers=tiers, slots_per_tier=args.slots, max_len=args.max_len,
        prompt_buckets=pbkts,
        group_buckets=(1, 2, args.slots) if args.slots > 2 else (1, 2),
        continuous=not args.static, seed=args.seed,
        device=args.device if device is None else device, mesh=mesh,
        spec_decode=args.spec_decode or None,
        spec_drafter=args.spec_drafter, spec_rounds=args.spec_rounds,
        fault=fault, sentinel_cfg=sentinel_cfg,
        max_queued=args.max_queued or None, retry_budget=args.retry_budget,
        telemetry=telemetry)
    rank0 = mesh is None or mesh.index(mesh.axis_names) == 0
    say = print if rank0 else (lambda *a: None)

    clock = RealClock() if mesh is None else SharedClock(RealClock(), mesh)
    t0 = clock.now()
    n_shapes = engine.warmup()
    where = "" if mesh is None else f" on mesh {mesh.shape}"
    say(f"[{cfg.name}] warmed {n_shapes} shapes over {len(tiers)} tiers"
        f"{where} in {clock.now() - t0:.1f}s")

    mix = (("exact", None, 0.3), ("balanced", None, 0.4),
           ("economy", None, 0.3))
    wl = poisson_workload(args.n_requests, args.rate, cfg.vocab,
                          prompt_len=tuple(args.prompt_len),
                          max_new=tuple(args.max_new), tier_mix=mix,
                          seed=args.seed)
    base = clock.now()
    for r in wl:
        r.arrival += base        # arrivals on the shared engine clock
    results = engine.run(wl, clock=clock)
    stats = EngineStats.from_results(results, engine.last_run_s)

    policy = "static" if args.static else "continuous"
    say(f"[{cfg.name}] {policy}: {stats.n_requests} requests, "
        f"{stats.total_tokens} tokens in {stats.duration_s:.2f}s "
        f"-> {stats.tokens_per_s:.1f} tok/s")
    say(f"  per-token latency p50 {stats.p50_ms_per_token:.1f}ms "
        f"p95 {stats.p95_ms_per_token:.1f}ms; "
        f"ttft p50 {stats.p50_ttft_ms:.1f}ms")
    for t in engine.trip_log:
        say(f"  trip [{t.lane}] {t.reason} after {t.tokens_before_trip} "
            f"tokens ({t.in_flight_displaced} in flight displaced)")
    m = engine.metrics()
    say(f"  peak concurrency {m['peak_concurrency']}; plan misses after "
        f"warmup {m['steady_plan_misses']}; {m['n_failed']} failed")
    say(f"  {'tier':<10} {'tokens':>7} {'tok/s':>8} {'J/token':>10} "
        f"{'accept':>7} {'trips':>6} {'retries':>8}")
    for name, d in m["lanes"].items():
        tps = f"{d['tokens_per_s']:.1f}" if d["tokens_per_s"] else "-"
        ept = (f"{d['energy_per_token_j']:.3e}"
               if d["energy_per_token_j"] is not None else "-")
        acc = (f"{d['acceptance_rate']:.2f}"
               if d["acceptance_rate"] is not None else "-")
        say(f"  {name:<10} {d['tokens']:>7} {tps:>8} {ept:>10} "
            f"{acc:>7} {d['trips']:>6} {d['retries']:>8}")
    if args.spec_decode:
        sb = engine.lanes["exact"].backend
        say(f"  spec-decode k={sb.draft_k} (drafter "
            f"{sb.drafter_lm.cfg.cim.family}): {sb.n_rounds} rounds, "
            f"acceptance rate {sb.acceptance_rate:.3f}, "
            f"{sb.tokens_per_round:.2f} tokens a round")
    if mesh is not None:
        say(f"  rank 0 collectives: {mesh.comm['calls']} calls, "
            f"{mesh.comm['seconds']:.2f}s (host-staged gloo)")
    if rank0 and args.metrics:
        from repro_torch.obs import prometheus_text

        text = prometheus_text(telemetry.registry)
        if args.metrics == "-":
            print(text, end="")
        else:
            with open(args.metrics, "w") as f:
                f.write(text)
            print(f"  metrics -> {args.metrics}")
    if rank0 and args.trace_out:
        from repro_torch.obs import write_chrome_trace

        write_chrome_trace(telemetry.registry.spans.items(), args.trace_out,
                           tid_names=telemetry.tid_names)
        print(f"  trace -> {args.trace_out} "
              f"({len(telemetry.registry.spans)} spans, "
              f"{telemetry.registry.spans.dropped} dropped)")
    if telemetry is not None:
        telemetry.detach()
    return engine.steady_plan_misses() == 0


def _rank_serve(rank, world, device, args, mp):
    from .mesh import make_host_mesh

    return serve(args, make_host_mesh(mp), device)


def main():
    ap = _parser()
    args = ap.parse_args()
    if args.no_telemetry and (args.metrics or args.trace_out):
        ap.error("--no-telemetry contradicts --metrics/--trace-out")
    if args.ranks and not args.mesh:
        ap.error("--ranks needs --mesh")
    if args.fault_rate < 0 or args.fault_rate > 1:
        ap.error("--fault-rate must be in [0, 1]")
    if args.fault_rate > 0 and args.mode not in FAULT_MODES:
        ap.error(f"--fault-rate needs an integer --mode "
                 f"({'/'.join(FAULT_MODES)}): the surrogate modes store no "
                 "words or tables to fault")
    if args.sentinel_period < 1:
        ap.error("--sentinel-period must be >= 1")
    if args.fault_rate > 0 and args.mesh:
        ap.error("--fault-rate does not compose with --mesh: the shard "
                 "kernels quantize their words on load and cannot see the "
                 "defect map")
    if args.spec_decode and args.mesh:
        ap.error("--spec-decode does not compose with --mesh in this "
                 "launcher, as in the JAX package's, whose reason is that "
                 "the verifier's per-token activation scales are "
                 "row-local, which its shard_map global-scale path cannot "
                 "express; build_engine(spec_decode=k, mesh=...) serves it")
    if not args.mesh:
        ok = serve(args)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import datetime

        import torch
        import torch.distributed as dist

        from .mesh import make_host_mesh

        dev = torch.device(args.device or "cuda")
        if dev.type == "cuda":
            idx = int(os.environ.get("LOCAL_RANK", os.environ["RANK"])) \
                % torch.cuda.device_count()
            torch.cuda.set_device(idx)
            dev = torch.device("cuda", idx)
        dist.init_process_group("gloo",
                                timeout=datetime.timedelta(seconds=300))
        ok = serve(args, make_host_mesh(args.mesh), dev)
        dist.destroy_process_group()
    else:
        if args.ranks < 1:
            ap.error("--mesh outside torchrun needs --ranks N")
        from .mesh import spawn

        device = args.device or "cuda"
        threads = (max(1, (os.cpu_count() or 1) // args.ranks)
                   if device == "cpu" else None)
        oks = spawn(_rank_serve, args.ranks, device=device,
                    args=(args, args.mesh), threads=threads)
        ok = all(oks)
    if not ok:
        raise SystemExit("serving built new GEMM plans after warmup")


if __name__ == "__main__":
    main()
