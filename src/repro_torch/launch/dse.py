"""The allocation DSE's contract on one device: the batched
characterization against the serial one, and `autoallocate` against the
exhaustive oracle on one warm evaluator (the port's counterpart of the
JAX package's ``benchmarks/bench_dse.py``, its characterization and
search sections).

    PYTHONPATH=src python -m repro_torch.launch.dse --out build/dse

characterization: the serial numpy Monte Carlo (`characterize`) against
`characterize_batch` on the device over BENCH_dse's six 12-bit specs at
the same sample count, both with ``cache=False``: cold and median-of-3
steady seconds, the steady speedup, and whether the metrics are
byte-equal (they must be).

search: qwen3-1.7b-smoke with seeded weights and a seeded (2, 16) token
batch, ONE `make_evaluator` in surrogate mode (the compiler's default:
every approximate module draws its calibrated noise from a fixed key)
over the seven projections (4^7 = 16,384 allocations), then
`autoallocate` at NMED 1e-2 once cold and three times steady, and
`exhaustive_oracle` once: seconds, evaluations, measured NMED and
energy per MAC (the FreePDK45 model of core/energy_model.py, not a
device number) of both, the steady speedup and the energy ratio.

Prints a line per section and one JSON object, and writes it to
``<out>/dse.json`` with ``--out``.  Runs on the card unless ``--device
cpu`` (there, ``--modules wq wv mlp_wo`` keeps the oracle at 64
evaluations).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import allocate
from repro_torch.core import error_model as erm
from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.device import resolve_device
from repro_torch.models.transformer import LM

CHAR_SPECS = ([("appro42", 12, False, "yang1", n) for n in (4, 8)]
              + [("appro42", 12, False, "orplane", n) for n in (6, 10)]
              + [("log_our", 12, False, "yang1", None),
                 ("mitchell", 12, False, "yang1", None)])
MODULES = ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wg", "mlp_wo")
BUDGET = 1e-2                 # the NMED budget of the search
MODE = "surrogate"            # the evaluator's mode, the compiler's default
REPS = 3                      # steady runs, their median


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def characterization(dev, n_samples: int) -> dict:
    specs = [MultiplierSpec(*k) for k in CHAR_SPECS]
    t = time.perf_counter()
    serial = [erm.characterize(s, n_samples=n_samples, cache=False)
              for s in specs]
    serial_s = time.perf_counter() - t
    t = time.perf_counter()
    cold = erm.characterize_batch(specs, n_samples=n_samples, cache=False,
                                  device=dev)
    cold_s = time.perf_counter() - t
    steady, equal = [], cold == serial
    for _ in range(REPS):
        t = time.perf_counter()
        got = erm.characterize_batch(specs, n_samples=n_samples,
                                     cache=False, device=dev)
        steady.append(time.perf_counter() - t)
        equal = equal and got == serial
    steady_s = statistics.median(steady)
    return {"n_specs": len(specs), "n_samples": n_samples,
            "serial_s": serial_s, "batched_cold_s": cold_s,
            "batched_steady_s": steady_s, "steady_runs_s": steady,
            "speedup_cold": serial_s / cold_s,
            "speedup_steady": serial_s / steady_s,
            "byte_equal": bool(equal)}


def _record(r, secs=None) -> dict:
    out = {"evals": r.evals, "nmed": r.nmed,
           "nmed_predicted": r.nmed_predicted,
           "energy_per_mac_j": r.energy_per_mac_j,
           "energy_saving_vs_exact": r.energy_saving,
           "tier_map": [list(t) for t in r.tier_map]}
    if secs is not None:
        out["time_s"] = secs
    return out


def search(dev, modules, seed: int = 0) -> dict:
    cfg = get_config("qwen3-1.7b", smoke=True)
    lm = LM(cfg, dev)
    params = lm.init(seed)
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(seed + 1))
    t = time.perf_counter()
    ev = allocate.make_evaluator(lm, params=params, tokens=tokens,
                                 modules=modules, mode=MODE, seed=seed)
    _sync(dev)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    a_cold = allocate.autoallocate(lm, BUDGET, evaluator=ev, seed=seed)
    cold_s = time.perf_counter() - t
    steady = []
    for _ in range(REPS):
        t = time.perf_counter()
        a = allocate.autoallocate(lm, BUDGET, evaluator=ev, seed=seed)
        steady.append(time.perf_counter() - t)
        if a.tier_map != a_cold.tier_map:
            raise RuntimeError("autoallocate is not deterministic on one "
                               f"evaluator: {a.tier_map} vs "
                               f"{a_cold.tier_map}")
    steady_s = statistics.median(steady)
    t = time.perf_counter()
    o = allocate.exhaustive_oracle(lm, BUDGET, evaluator=ev)
    oracle_s = time.perf_counter() - t
    auto = _record(a)
    auto.update(cold_time_s=cold_s, steady_time_s=steady_s,
                steady_runs_s=steady)
    return {"arch": cfg.name, "mode": MODE,
            "modules": [m.name for m in ev.modules],
            "tiers": [c.short_name() for c in ev.candidates],
            "budget_nmed": BUDGET, "evaluator_build_s": build_s,
            "oracle": _record(o, oracle_s), "autoallocate": auto,
            "oracle_s_per_eval": oracle_s / o.evals,
            "speedup_steady": oracle_s / steady_s,
            "energy_ratio_vs_oracle": (a.energy_per_mac_j
                                       / o.energy_per_mac_j),
            "both_within_budget": bool(a.nmed <= BUDGET
                                       and o.nmed <= BUDGET)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--modules", nargs="+", default=list(MODULES))
    ap.add_argument("--samples", type=int, default=200_000,
                    help="Monte Carlo samples of the characterization")
    ap.add_argument("--out", default=None,
                    help="directory for dse.json")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = None
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip().splitlines()[0]
        print(f"{card}; torch {torch.__version__}", flush=True)
    char = characterization(dev, args.samples)
    print(f"characterization: {char['n_specs']} specs x "
          f"{char['n_samples']} samples, byte-equal {char['byte_equal']}; "
          f"serial {char['serial_s']:.3f}s, batched cold "
          f"{char['batched_cold_s']:.3f}s, steady "
          f"{char['batched_steady_s']:.4f}s: {char['speedup_steady']:.1f}x",
          flush=True)
    srch = search(dev, tuple(args.modules))
    o, a = srch["oracle"], srch["autoallocate"]
    print(f"search ({srch['arch']}, {len(srch['modules'])} modules x "
          f"{len(srch['tiers'])} tiers, {MODE}, budget "
          f"{BUDGET}): evaluator {srch['evaluator_build_s']:.2f}s; "
          f"oracle {o['evals']} evaluations in {o['time_s']:.2f}s "
          f"({1e3 * srch['oracle_s_per_eval']:.3f} ms each), NMED "
          f"{o['nmed']:.6e}, {o['energy_per_mac_j'] * 1e12:.4f} pJ/MAC; "
          f"autoallocate {a['evals']} evaluations, cold "
          f"{a['cold_time_s']:.3f}s, steady {a['steady_time_s']:.3f}s, "
          f"NMED {a['nmed']:.6e}, {a['energy_per_mac_j'] * 1e12:.4f} "
          f"pJ/MAC; speedup {srch['speedup_steady']:.1f}x, energy "
          f"{srch['energy_ratio_vs_oracle']:.4f}x the oracle's", flush=True)
    out = {"device": card or dev.type, "characterization": char,
           "search": srch}
    text = json.dumps(out, default=lambda v: float(v)
                      if isinstance(v, np.floating) else str(v))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "dse.json"), "w") as fh:
            fh.write(text)
    print(text, flush=True)
    return out


if __name__ == "__main__":
    main()
