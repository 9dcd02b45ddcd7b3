"""Serving launcher: the continuous-batching CiM engine under a synthetic
Poisson arrival workload, on a CUDA device (or ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --mode hardware --slots 4 --n-requests 16

Builds the per-tier slot-pool engine over the DSE accuracy ladder, runs
every (tier x bucket) shape once (warmup), serves the workload, and
prints throughput, latency and the plan misses after warmup (0).
`--static` degrades admission to lockstep batching.  The smoke config
serves by default; `--full` serves the published widths and depth.
Speculative decoding, faults, sentinels, telemetry and mesh serving are
later slices of the port.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.serving import (EngineStats, RealClock, build_engine,
                                 build_tiers, poisson_workload,
                                 servable_archs)


def main():
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
                    help="execution mode of the approximate tiers")
    ap.add_argument("--static", action="store_true",
                    help="lockstep (static-batching) admission baseline")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=not args.full)
    tiers = build_tiers(mode=args.mode)
    pmax = max(args.prompt_len)
    pbkts = tuple(sorted({b for b in (8, 16) if b < pmax} | {pmax}))
    engine = build_engine(
        cfg, tiers=tiers, slots_per_tier=args.slots, max_len=args.max_len,
        prompt_buckets=pbkts,
        group_buckets=(1, 2, args.slots) if args.slots > 2 else (1, 2),
        continuous=not args.static, seed=args.seed, device=args.device)

    clock = RealClock()
    t0 = clock.now()
    n_shapes = engine.warmup()
    print(f"[{cfg.name}] warmed {n_shapes} shapes over {len(tiers)} tiers "
          f"in {clock.now() - t0:.1f}s")

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
    print(f"[{cfg.name}] {policy}: {stats.n_requests} requests, "
          f"{stats.total_tokens} tokens in {stats.duration_s:.2f}s "
          f"-> {stats.tokens_per_s:.1f} tok/s")
    print(f"  per-token latency p50 {stats.p50_ms_per_token:.1f}ms "
          f"p95 {stats.p95_ms_per_token:.1f}ms; "
          f"ttft p50 {stats.p50_ttft_ms:.1f}ms")
    m = engine.metrics()
    print(f"  peak concurrency {m['peak_concurrency']}; plan misses after "
          f"warmup {m['steady_plan_misses']}")
    for name, d in m["lanes"].items():
        tps = f"{d['tokens_per_s']:.1f}" if d["tokens_per_s"] else "-"
        print(f"  {name:<10} {d['tokens']:>7} tokens {tps:>8} tok/s")
    if engine.steady_plan_misses() != 0:
        raise SystemExit("serving built new GEMM plans after warmup")


if __name__ == "__main__":
    main()
