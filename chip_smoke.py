#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--layers N]

Phases, each of which must pass (the script exits nonzero otherwise):

  1. device: the card's name and count, and ``nvidia-smi``'s name and
     power limit;
  2. build: both CUDA sources (src/repro_torch/kernels/csrc) compiled by
     ``nvcc`` for sm_90a in parallel, with the ``-Xptxas -v`` report;
  3. kernels: each of the four kernels (LUT gather and log-domain GEMM,
     int and fused forms) against its plain PyTorch version on the card,
     bitwise, at the shapes the qwen3-1.7b serving path gives them (M = 4
     for a decode round of 4 slots, M = 64 for a 4 x 16 prefill, times
     the model's four (K, N) weight shapes) plus one ragged shape; each
     timed with CUDA events (L2 flushed before every launch, as the
     serving path finds its weights cold), beside its plain version's
     time and the least time the card could take (the larger of bytes
     over 3.35 TB/s and gathers or int32 operations over the SMs' peak
     rate at the card's maximum SM clock);
  4. reference: the LM on the card against the same LM on the CPU (the
     kernels' plain versions) on the smoke config, every tier, to a
     stated tolerance with greedy-token agreement;
  5. serve: ``build_engine`` over the hardware-mode ladder (exact /
     balanced / economy) on full-size qwen3-1.7b with seeded random
     weights, warmup, then a Poisson workload served twice under a
     simulated clock (identical tokens, every request complete, both
     fused kernels launched, no plan misses after warmup) and once under
     the real clock (tokens/s and per-token p50 per tier); then one
     decode round and one prefill per lane on the host clock, and one
     decode round per lane under torch.profiler (kernels, device busy
     time and idle share, device time by kernel class).

It prints one ``{"kernels": [...]}`` JSON line and, last, one
``{"ok": true, "device": {...}}`` line.  Without a CUDA device it exits
nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
GATHERS_PER_SM_CLOCK = 32          # shared-memory words a clock
INT32_LANES_PER_SM = 64            # int32 ALU lanes a clock
# int32 operations per log-domain product, counted from log_product and
# the inner loop of csrc/log_gemm.cu (keyed by `compensated`)
LOG_OPS = {False: 11, True: 28}
LUT_BYTES = (1 << 16) * 2          # the 8-bit int16 product table

WEIGHT_SHAPES = ((2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048))
MAIN_SHAPES = [(m, k, n) for m in (4, 64) for (k, n) in WEIGHT_SHAPES]
RAGGED = (33, 70, 17)
MIX = (("exact", None, 0.3), ("balanced", None, 0.4), ("economy", None, 0.3))
# the served workload: seed 1 draws all three tiers from MIX (6 balanced,
# 4 economy, 2 exact of 12 requests), which phase 5 checks
N_REQUESTS, WORKLOAD_SEED = 12, 1
REF_TOL = {"exact": 1e-2, "balanced": 4e-2, "economy": 4e-2}

SOURCES = {
    "lut_matmul": ("src/repro_torch/kernels/csrc/lut_gemm.cu",
                   "src/repro/kernels/approx_matmul.py:137"),
    "lut_matmul_fused": ("src/repro_torch/kernels/csrc/lut_gemm.cu",
                         "src/repro/kernels/approx_matmul.py:230"),
    "mitchell_matmul": ("src/repro_torch/kernels/csrc/log_gemm.cu",
                        "src/repro/kernels/mitchell_gemm.py:88"),
    "mitchell_matmul_fused": ("src/repro_torch/kernels/csrc/log_gemm.cu",
                              "src/repro/kernels/mitchell_gemm.py:173"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _timed_ms(torch, fn, reps: int, flush) -> float:
    """Mean device time of `fn` over `reps` launches, each after an L2
    flush, from CUDA events."""
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def _bound(name: str, m: int, k: int, n: int, sms: int, clock_hz: float):
    """(bound_ms, bound_by) for one call: bytes each input read once and
    each output written once, against gathers or int32 operations at the
    SMs' peak rate."""
    fused = name.endswith("fused")
    lut = name.startswith("lut")
    nbytes = (m * k * 2 + k * n * 2 + 4 + n * 4 + m * n * 4 if fused
              else m * k + k * n + m * n * 4)
    if lut:
        nbytes += LUT_BYTES
        ops_s = m * k * n / (sms * GATHERS_PER_SM_CLOCK * clock_hz)
    else:
        ops_s = m * k * n * LOG_OPS[False] / (sms * INT32_LANES_PER_SM
                                              * clock_hz)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(bytes_s, ops_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def check_kernels(torch, sms: int, clock_hz: float):
    from repro_torch.core.multipliers import MultiplierSpec
    from repro_torch.kernels import approx_matmul as am
    from repro_torch.kernels import mitchell_gemm as mg
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    # the balanced tier's multiplier (appro42, orplane cells, 10 columns)
    lut = ops.lut_table(MultiplierSpec("appro42", 8, True, "orplane", 10),
                        dev)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    rows = {name: [] for name in SOURCES}
    for shape in MAIN_SHAPES + [RAGGED]:
        m, k, n = shape
        g = torch.Generator(device=dev).manual_seed(m * 7 + k + n)
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        xq = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-128, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        sx, sw = ops._scales(x, w, 8)
        calls = {
            "lut_matmul": (lambda: am.lut_matmul(xq, wq, lut),
                           lambda: ref.lut_matmul_ref(xq, wq, lut)),
            "lut_matmul_fused": (
                lambda: am.lut_matmul_fused(x, w, lut, sx, sw),
                lambda: am.lut_matmul_fused_plain(x, w, lut, sx, sw)),
        }
        for comp in (False, True):   # mitchell (the economy tier), log_our
            sfx = "" if not comp else "[log_our]"
            calls["mitchell_matmul" + sfx] = (
                lambda c=comp: mg.mitchell_matmul(xq, wq, compensated=c),
                lambda c=comp: ref.mitchell_matmul_ref(xq, wq,
                                                       compensated=c))
            calls["mitchell_matmul_fused" + sfx] = (
                lambda c=comp: mg.mitchell_matmul_fused(x, w, sx, sw,
                                                        compensated=c),
                lambda c=comp: mg.mitchell_matmul_fused_plain(
                    x, w, sx, sw, compensated=c))
        for name, (kern, plain) in calls.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            if not torch.equal(got, want):
                fail(f"{name} {shape}: kernel != plain version "
                     f"(max |diff| {err})")
            if name not in rows:
                continue                     # log_our: correctness only
            row = {"shape": shape, "max_abs_err": err}
            if shape != RAGGED:
                row["ms"] = _timed_ms(torch, kern, 10, flush)
                row["plain_ms"] = _timed_ms(torch, plain, 1, flush)
                row["bound_ms"], row["bound_by"] = _bound(name, m, k, n,
                                                          sms, clock_hz)
            rows[name].append(row)
        print(f"  {shape}: all kernels bitwise equal to their plain "
              f"versions (mitchell and log_our)", flush=True)
    print(f"  {'kernel':<22} {'M,K,N':>16} {'ms':>9} {'bound_ms':>9} "
          f"{'by':>10} {'plain_ms':>9}")
    for name, rs in rows.items():
        for r in rs:
            if "ms" in r:
                print(f"  {name:<22} {str(r['shape']):>16} {r['ms']:9.4f} "
                      f"{r['bound_ms']:9.4f} {r['bound_by']:>10} "
                      f"{r['plain_ms']:9.3f}")
    return rows


# ---------------------------------------------------------------------------
# phase 4: the LM on the card against the LM on the CPU (small input)
# ---------------------------------------------------------------------------


def check_reference(torch):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serving import build_tiers

    cfg = get_config("qwen3-1.7b", smoke=True)
    params_cpu = LM(cfg, device="cpu").init(0)
    params_gpu = _to(torch, params_cpu, "cuda")
    rng_tokens = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=rng_tokens)
    for tier in build_tiers(mode="hardware"):
        c = dataclasses.replace(cfg, cim=tier.cim)
        cpu, gpu = LM(c, device="cpu"), LM(c, device="cuda")
        tol = REF_TOL[tier.name]
        with torch.inference_mode():
            lc, cc = cpu.prefill(params_cpu, {"tokens": toks, "max_len": 16})
            lg, cg = gpu.prefill(params_gpu, {"tokens": toks.cuda(),
                                              "max_len": 16})
            worst, close = 0.0, 0
            for step in range(4):
                a = lc[:, -1].float()
                b = lg[:, -1].float().cpu()
                if not torch.isfinite(b).all():
                    fail(f"reference {tier.name}: non-finite logits")
                worst = max(worst, float((a - b).abs().max()))
                if worst > tol:
                    fail(f"reference {tier.name} step {step}: max |card - "
                         f"cpu| {worst} > {tol}")
                top2 = a.topk(2, dim=-1).values
                for i in range(a.shape[0]):
                    if top2[i, 0] - top2[i, 1] > tol:
                        if int(b[i].argmax()) != int(a[i].argmax()):
                            fail(f"reference {tier.name}: greedy token "
                                 f"differs at step {step} row {i}")
                    else:
                        close += 1
                if step == 3:
                    break
                tok = a.argmax(-1, keepdim=True)
                lc, cc = cpu.decode_step(params_cpu, cc, tok, 8 + step)
                lg, cg = gpu.decode_step(params_gpu, cg, tok.cuda(),
                                         8 + step)
        print(f"  {tier.name:<9} card vs cpu: max |logit diff| {worst:.3e} "
              f"<= {tol} ; greedy tokens equal ({close} near-ties under "
              f"the gap rule)", flush=True)


def _to(torch, tree, device):
    if isinstance(tree, dict):
        return {k: _to(torch, v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(torch, v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# phase 5: serve full-size qwen3-1.7b on the hardware ladder
# ---------------------------------------------------------------------------


def _launch_counts(am, mg):
    return {n: k.launches for n, k in {**am.KERNELS, **mg.KERNELS}.items()}


def _reset_counts(am, mg):
    for k in list(am.KERNELS.values()) + list(mg.KERNELS.values()):
        k.launches = 0


def serve(torch, layers, power):
    from repro_torch.configs import get_config
    from repro_torch.kernels import approx_matmul as am
    from repro_torch.kernels import mitchell_gemm as mg
    from repro_torch.serving import (EngineStats, RealClock, SimClock,
                                     build_engine, build_tiers,
                                     poisson_workload)

    cfg = get_config("qwen3-1.7b")
    if layers and layers < cfg.n_layers:
        print(f"  CUT: {layers} of {cfg.n_layers} layers (widths unchanged)")
        cfg = dataclasses.replace(cfg, n_layers=layers, n_periods=layers)
    print(f"  {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} x {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {cfg.n_layers} layers", flush=True)
    tiers = build_tiers(mode="hardware")
    t0 = time.perf_counter()
    eng = build_engine(cfg, tiers=tiers, slots_per_tier=4, max_len=32,
                       prompt_buckets=(16,), group_buckets=(1, 2, 4),
                       seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.lanes["exact"]
                                               .backend.params))
    print(f"  engine built in {time.perf_counter() - t0:.1f}s: {n_params} "
          f"parameters (bf16, seeded), "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
          flush=True)
    t0 = time.perf_counter()
    n = eng.warmup()
    torch.cuda.synchronize()
    print(f"  warmup ran {n} shapes in {time.perf_counter() - t0:.1f}s",
          flush=True)
    wl = poisson_workload(N_REQUESTS, rate=20.0, vocab=cfg.vocab,
                          prompt_len=(8, 16), max_new=(4, 16), tier_mix=MIX,
                          seed=WORKLOAD_SEED)

    def run_sim():
        t = time.perf_counter()
        res = eng.run(wl, clock=SimClock())
        torch.cuda.synchronize()
        for r in wl:
            rr = res[r.rid]
            if not rr.done or len(rr.tokens) != r.max_new:
                fail(f"request {r.rid} got {len(rr.tokens)} of "
                     f"{r.max_new} tokens")
        if eng.steady_plan_misses() != 0:
            fail(f"{eng.steady_plan_misses()} plan misses after warmup")
        return res, time.perf_counter() - t

    _reset_counts(am, mg)
    res_a, secs = run_sim()
    launches = _launch_counts(am, mg)
    tiers_used = sorted({r.tier for r in res_a.values()})
    if tiers_used != sorted(t.name for t in tiers):
        fail(f"the workload reached only the tiers {tiers_used}")
    print(f"  simulated-clock run: {len(wl)} requests ({', '.join(tiers_used)}"
          f"), {sum(len(r.tokens) for r in res_a.values())} tokens in "
          f"{secs:.1f}s; kernel launches {launches}", flush=True)
    for name in ("lut_matmul_fused", "mitchell_matmul_fused"):
        if launches[name] <= 0:
            fail(f"{name} was not launched while serving")
    eng.warmup()                      # same start state for the rerun
    res_b, _ = run_sim()
    if any(res_a[r.rid].tokens != res_b[r.rid].tokens for r in wl):
        fail("the same workload served twice gave different tokens")
    print("  rerun under the simulated clock: identical tokens", flush=True)

    eng.warmup()
    res = eng.run(wl, clock=RealClock())
    torch.cuda.synchronize()
    stats = EngineStats.from_results(res, eng.last_run_s)
    print(f"  real-clock run on {power}: {stats.total_tokens} tokens in "
          f"{stats.duration_s:.2f}s = {stats.tokens_per_s:.1f} tokens/s, "
          f"per-token p50 {stats.p50_ms_per_token:.1f} ms", flush=True)
    for t in tiers:
        sub = {k: r for k, r in res.items() if r.tier == t.name}
        if not sub:
            continue
        st = EngineStats.from_results(sub, eng.last_run_s)
        print(f"    {t.name:<9} {st.n_requests} requests, {st.total_tokens} "
              f"tokens, {st.tokens_per_s:.1f} tokens/s, per-token p50 "
              f"{st.p50_ms_per_token:.1f} ms, ttft p50 "
              f"{st.p50_ttft_ms:.1f} ms", flush=True)

    # where the time goes: one pool decode round and one 4 x 16 prefill
    # per lane, host clock around work that ends in a synchronize
    for name, lane in eng.lanes.items():
        b = lane.backend
        toks = torch.zeros((4, 16), dtype=torch.int64, device=b.device)
        lens = torch.full((4,), 16, dtype=torch.int32, device=b.device)
        b.reset()
        t = time.perf_counter()
        for _ in range(3):
            b.decode_round()
        dec = (time.perf_counter() - t) / 3
        t = time.perf_counter()
        with torch.inference_mode():
            b.lm.prefill(b.params, {"tokens": toks, "lengths": lens,
                                    "max_len": b.max_len})
        torch.cuda.synchronize()
        pre = time.perf_counter() - t
        b.reset()
        print(f"    {name:<9} decode round (4 slots) {1e3 * dec:.1f} ms, "
              f"prefill (4 x 16) {1e3 * pre:.1f} ms", flush=True)
        _profile_round(torch, name, b, dec)
        b.reset()
    return launches


# PyTorch ops whose kernels count as torch.matmul (cuBLAS names its
# kernels in several ways, so they are told by the op that launched them)
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def _kernel_class(name: str, matmul_kernels) -> str:
    low = name.lower()
    if "lut_gemm" in low:
        return "CiM LUT kernel"
    if "log_gemm" in low:
        return "CiM log kernel"
    if name in matmul_kernels:
        return "torch.matmul"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other"


def _profile_round(torch, lane: str, backend, unprofiled_s: float) -> None:
    """One pool decode round under torch.profiler: the Python-level
    PyTorch ops it dispatched, the kernels it launched, the union of their
    device intervals against the round's time (the device's idle share),
    and device time by kernel class and by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        backend.decode_round()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    n_ops = sum(1 for e in events if e.device_type == DeviceType.CPU
                and e.cpu_parent is None and e.name.startswith("aten::"))
    if not kern:
        print(f"    {lane:<9} profiled round: {wall_ms:.1f} ms, {n_ops} "
              f"top-level ops; device time not measured (the profiler "
              f"recorded no kernels)", flush=True)
        return
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in kern):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    matmul_kernels = {k.name for e in events if e.name in MATMUL_OPS
                      for k in e.kernels}
    by_class, by_name = {}, {}
    for e in kern:
        us = e.time_range.elapsed_us()
        c = _kernel_class(e.name, matmul_kernels)
        by_class[c] = by_class.get(c, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy_ms = busy_us / 1e3
    print(f"    {lane:<9} profiled round: {wall_ms:.1f} ms host clock "
          f"({1e3 * unprofiled_s:.1f} ms unprofiled), {n_ops} top-level "
          f"ops, {len(kern)} kernels; device busy {busy_ms:.2f} ms = idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% of the profiled round, "
          f"{100 * max(0.0, 1 - busy_ms / (1e3 * unprofiled_s)):.1f}% of "
          f"the unprofiled one", flush=True)
    print("      by class (ms): " + ", ".join(
        f"{c} {us / 1e3:.2f}" for c, us in
        sorted(by_class.items(), key=lambda kv: -kv[1])), flush=True)
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        print(f"      {us / 1e3:8.3f} ms  {n[:110]}", flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="serve only this many layers (0 = all 28)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import build

    print("[1] device", flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    power = nvidia_smi("name,power.limit")
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"  {kind} x{count}; {sms} SMs, max SM clock "
          f"{clock_hz / 1e6:.0f} MHz; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(f"  nvidia-smi: {power}", flush=True)

    print("[2] build", flush=True)
    t0 = time.perf_counter()
    for name, (secs, report) in build.build(["lut_gemm", "log_gemm"]).items():
        print(f"  {name}.cu: {secs:.1f}s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"    {line.strip()}")
    print(f"  both sources built in {time.perf_counter() - t0:.1f}s",
          flush=True)

    print("[3] kernels against their plain versions", flush=True)
    rows = check_kernels(torch, sms, clock_hz)

    print("[4] reference: the LM on the card against the CPU", flush=True)
    check_reference(torch)

    print("[5] serve", flush=True)
    launches = serve(torch, args.layers, power)

    kernels = []
    for name, rs in rows.items():
        timed = [r for r in rs if "ms" in r]
        ops_ms = sum(r["bound_ms"] for r in timed
                     if r["bound_by"] == "operations")
        bytes_ms = sum(r["bound_ms"] for r in timed
                       if r["bound_by"] == "bytes")
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "shapes": [list(r["shape"]) for r in timed],
        })
    print(f"  total {time.perf_counter() - t_start:.1f}s", flush=True)
    print(power)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
