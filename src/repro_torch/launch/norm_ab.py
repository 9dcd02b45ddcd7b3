"""Time the norm's row-count-invariant sum against one torch.mean in
qwen3-1.7b decode rounds on one card, A/B in one process.

``models/common.rms_norm`` sums each row's squares in an order that does
not depend on the number of rows (``row_mean_square``: two sums and a
division); it used to be one ``torch.mean``.  This builds the full-size
qwen3-1.7b engine on the hardware ladder with seeded weights (as
chip_smoke.py's phase 5 does) and, for each lane, runs pool decode
rounds (4 slots) with each norm in the order mean, fixed, fixed, mean,
so that drift over the call cancels.  Per run: the host ms a round (mean
of 20 rounds ending in a synchronize), and three profiled
rounds: the kernels the device ran and their busy ms (union of the
kernels' intervals).

    PYTHONPATH=src python -m repro_torch.launch.norm_ab \\
        --out chiprun_out/norm_ab

Writes ``<out>/norm_ab.json`` and prints a line per lane and run, then
per lane each norm's means and the change.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import common
from repro_torch.serving import build_engine, build_tiers

ORDER = ("mean", "fixed", "fixed", "mean")
ROUNDS = 20


def _mean_square_by_mean(x32: torch.Tensor) -> torch.Tensor:
    """The norm's sum before it was made row-count invariant."""
    return torch.mean(x32 * x32, dim=-1, keepdim=True)


NORMS = {"mean": _mean_square_by_mean, "fixed": common.row_mean_square}


def _profiled(run):
    """(kernels, busy ms) of one call of `run` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return len(spans), busy_us / 1e3


def _run(backend):
    backend.reset()
    for _ in range(3):                    # warm the allocator and plans
        backend.decode_round()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(ROUNDS):
        backend.decode_round()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t) / ROUNDS
    prof = [_profiled(backend.decode_round) for _ in range(3)]
    backend.reset()
    return {"host_ms": host_ms, "kernels": [k for k, _ in prof],
            "busy_ms": [b for _, b in prof]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    cfg = get_config("qwen3-1.7b")
    eng = build_engine(cfg, tiers=build_tiers(mode="hardware"),
                       slots_per_tier=4, max_len=32, prompt_buckets=(16,),
                       group_buckets=(1, 2, 4), seed=0)
    eng.warmup()
    print(f"{cfg.name}, {cfg.n_layers} layers, hardware ladder, decode "
          f"rounds of 4 slots on {torch.cuda.get_device_name(0)}; norms in "
          f"the order {ORDER}", flush=True)
    out = {}
    for name, lane in eng.lanes.items():
        runs = out[name] = []
        for norm in ORDER:
            common.row_mean_square = NORMS[norm]
            r = dict(norm=norm, **_run(lane.backend))
            common.row_mean_square = NORMS["fixed"]
            runs.append(r)
            print(f"  {name:<9} {norm:<5} host {r['host_ms']:.3f} ms a round; "
                  f"profiled rounds: kernels {r['kernels']}, busy "
                  f"{[round(b, 3) for b in r['busy_ms']]} ms", flush=True)
        summary = {}
        for norm in ("mean", "fixed"):
            rs = [r for r in runs if r["norm"] == norm]
            summary[norm] = {
                "host_ms": statistics.mean(r["host_ms"] for r in rs),
                "kernels": max(k for r in rs for k in r["kernels"]),
                "busy_ms": statistics.median(b for r in rs
                                             for b in r["busy_ms"])}
        m, f = summary["mean"], summary["fixed"]
        print(f"  {name:<9} torch.mean: host {m['host_ms']:.3f} ms, "
              f"{m['kernels']} kernels, busy {m['busy_ms']:.3f} ms; fixed "
              f"order: host {f['host_ms']:.3f} ms, {f['kernels']} kernels, "
              f"busy {f['busy_ms']:.3f} ms; change host "
              f"{f['host_ms'] - m['host_ms']:+.3f} ms, kernels "
              f"{f['kernels'] - m['kernels']:+d}, busy "
              f"{f['busy_ms'] - m['busy_ms']:+.3f} ms", flush=True)
        out[name + "_summary"] = summary
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "norm_ab.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
