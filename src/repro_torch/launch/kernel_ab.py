"""Time the GEMM and conv kernels of several checkouts on one card, A/B.

Each root is a checkout of this repository (a ``git archive`` unpacked
anywhere).  For each root, in the order given, one process imports that
root's ``chip_smoke.py``, builds its kernels into its own ``build/`` and
runs its phase-3 checks (``check_kernels`` and, where the root has
them, ``check_conv``, ``check_partials``, ``check_attention``,
``check_surrogate``, ``check_slstm``): every kernel against its plain
version, then timed per shape with the root's own timer (``_timed_ms``:
a mean of launches, each after an L2 flush).  Then, the same in every
root, the int GEMMs the per-token and faulted lanes serve
(``lut_matmul`` over the balanced tier's table, ``lut_matmul_mag`` over
it faulted at phase 12's rate, ``mitchell_matmul``,
``nibble_lut_matmul`` over the sub-tables of the balanced/4 lane,
appro42/orplane/4) at M = 1, 2, 4, 8, 16, 20 and 64 times the four LM
(K, N), each checked against its plain version, keyed ``int <name>``.  ``--spin CYCLES`` times
every root with one timer instead: the L2 flush, then the card spun for
CYCLES SM clocks (``torch.cuda._sleep``; 0 spins not at all) so that a
launch's host work is queued before the start event, then the launch
between two CUDA events.  Give the roots in a balanced order, e.g.
parent, change, change, parent, so that drift over the call cancels;
runs of one root are summarized by their median (the mean of two runs;
with more, one run's spike, a launch whose host work outlasted the spin,
moves nothing).

    python3 src/repro_torch/launch/kernel_ab.py --out build/ab/out \
        --spin 500000 parent=build/ab/parent change=. change=. \
        parent=build/ab/parent

It writes ``<out>/ab.json`` ({label: {kernel: {shape: [ms, ...]}}}) and
prints, per kernel and shape, each label's median ms and its ratio to
the first label's, with each kernel's sums over the shapes every label
timed.  Needs a CUDA device; ``--report AB_JSON`` prints the table of a
saved ab.json again, anywhere (``--rows M [M ...]``: only the shapes of
those leading dimensions, e.g. ``--rows 4 64`` for the eight LM shapes).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import statistics
import subprocess
import sys
from collections import defaultdict

# run inside each root: its chip_smoke's phase 3, rows as JSON on the last
# line (everything chip_smoke prints goes to the run's log)
_CHILD = r"""
import contextlib, json, os, sys
root = os.getcwd()
sys.path[:0] = [root, os.path.join(root, "src")]
import torch
import chip_smoke as cs
from repro_torch.kernels import build
spin = None if sys.argv[2] == "-" else int(sys.argv[2])


def timed_ms(torch, fn, reps, flush):
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if spin:
            torch.cuda._sleep(spin)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


if spin is not None:
    cs._timed_ms = timed_ms


def int_forms(out):
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.multipliers import MultiplierSpec
    from repro_torch.kernels import approx_matmul as am
    from repro_torch.kernels import mitchell_gemm as mg
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    spec = MultiplierSpec("appro42", 8, True, "orplane", 10)
    lut = ops.lut_table(spec, dev)
    mag = ops.magnitude_lut(spec, FaultConfig.from_yield(rows=32, scale=1.0),
                            dev)
    subs = ops.nibble_table(MultiplierSpec("appro42", 8, True, "orplane", 4),
                            dev)
    for m in (1, 2, 4, 8, 16, 20, 64):
        for k, n in cs.WEIGHT_SHAPES:
            g = torch.Generator(device=dev).manual_seed(m * 13 + k + n)
            xq = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                               dtype=torch.int8)
            wq = torch.randint(-128, 128, (k, n), generator=g, device=dev,
                               dtype=torch.int8)
            for name, fn, plain in (
                    ("lut_matmul", lambda: am.lut_matmul(xq, wq, lut),
                     lambda: ref.lut_matmul_ref(xq, wq, lut)),
                    ("lut_matmul_mag", lambda: am.lut_matmul_mag(xq, wq, mag),
                     lambda: am.lut_matmul_mag_plain(xq, wq, mag)),
                    ("mitchell_matmul",
                     lambda: mg.mitchell_matmul(xq, wq, compensated=False),
                     lambda: ref.mitchell_matmul_ref(xq, wq,
                                                     compensated=False)),
                    ("nibble_lut_matmul",
                     lambda: am.nibble_lut_matmul(xq, wq, subs),
                     lambda: ref.nibble_matmul_ref(xq, wq, subs))):
                if not torch.equal(fn(), plain()):
                    sys.exit(f"int {name} {(m, k, n)}: != plain version")
                out.setdefault("int " + name, {})[str((m, k, n))] = \
                    cs._timed_ms(torch, fn, 10, flush)


log = open(sys.argv[1], "w")
with contextlib.redirect_stdout(log):
    build.build(build.SOURCES)
    if hasattr(cs, "log_clocks"):      # the log bounds read the SASS
        cs.log_clocks(build)
    clock = float(cs.nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for check in ("check_kernels", "check_conv", "check_partials",
                  "check_attention", "check_surrogate", "check_slstm"):
        if not hasattr(cs, check):
            continue
        for name, rs in getattr(cs, check)(torch, sms, clock).items():
            for r in rs:
                if "ms" not in r:
                    continue
                where = r.get("path") or r.get("variant")
                key = f"{name}[{where}]" if where else name
                dims = r["shape"] if "shape" in r else r["geometry"]
                shape = str(tuple(dims))
                while shape in out.setdefault(key, {}):
                    shape += "'"
                out[key][shape] = r["ms"]
    int_forms(out)
print(json.dumps(out))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("runs", nargs="*", metavar="LABEL=ROOT",
                    help="a label and a checkout, run in the order given")
    ap.add_argument("--out", default="build/ab/out",
                    help="directory for ab.json and the runs' logs")
    ap.add_argument("--spin", type=int, default=None, metavar="CYCLES",
                    help="time every root with one timer that spins the "
                    "card CYCLES SM clocks before each start event "
                    "(default: each root's own chip_smoke timer)")
    ap.add_argument("--report", metavar="AB_JSON", default=None,
                    help="print the table of a saved ab.json and run "
                    "nothing")
    ap.add_argument("--rows", type=int, nargs="+", default=None,
                    metavar="M", help="with --report: only the shapes "
                    "whose leading dimension is one of these")
    args = ap.parse_args()
    if args.report:
        with open(args.report) as f:
            saved = json.load(f)
        report(saved, list(saved), args.rows)
        return
    if not args.runs:
        ap.error("give LABEL=ROOT runs, or --report AB_JSON")
    os.makedirs(args.out, exist_ok=True)
    times = defaultdict(lambda: defaultdict(lambda: defaultdict(list)))
    labels = []
    for i, run in enumerate(args.runs):
        label, root = run.split("=", 1)
        if label not in labels:
            labels.append(label)
        log = os.path.abspath(os.path.join(args.out, f"run{i}-{label}.log"))
        spin = "-" if args.spin is None else str(args.spin)
        proc = subprocess.run([sys.executable, "-c", _CHILD, log, spin],
                              cwd=os.path.abspath(root), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            sys.exit(f"{label} ({root}) failed, see {log}:\n"
                     f"{proc.stderr[-4000:]}")
        for name, shapes in json.loads(
                proc.stdout.strip().splitlines()[-1]).items():
            for shape, ms in shapes.items():
                times[label][name][shape].append(ms)
        print(f"run {i}: {label} ({root}) done", flush=True)
    with open(os.path.join(args.out, "ab.json"), "w") as f:
        json.dump(times, f, indent=1)
    report(times, labels)


def report(times, labels, rows=None) -> None:
    """Print each kernel's median ms a shape per label, the ratio to the
    first label, and the sums over the shapes that every label timed
    (with `rows`, only shapes whose leading dimension is one of them)."""
    base = labels[0]
    names = sorted({n for lab in labels for n in times[lab]})
    print(f"{'kernel':<34} {'shape':<26} "
          + " ".join(f"{lab:>12}" for lab in labels)
          + "  ratio to " + base)
    for name in names:
        shapes = sorted({s for lab in labels for s in times[lab].get(name,
                                                                     {})})
        if rows is not None:
            shapes = [s for s in shapes
                      if ast.literal_eval(s.rstrip("'"))[0] in rows]
        sums = defaultdict(float)
        for shape in shapes:
            meds = {}
            for lab in labels:
                ms = times[lab].get(name, {}).get(shape)
                if ms:
                    meds[lab] = statistics.median(ms)
            if len(meds) == len(labels):
                for lab, v in meds.items():
                    sums[lab] += v
            cells = " ".join(f"{meds[lab]:12.4f}" if lab in meds
                             else f"{'-':>12}" for lab in labels)
            ratios = " ".join(f"{meds[lab] / meds[base]:.3f}"
                              for lab in labels[1:]
                              if lab in meds and base in meds)
            print(f"{name:<34} {shape:<26} {cells}  {ratios}")
        if len(shapes) > 1:
            cells = " ".join(f"{sums[lab]:12.4f}" if lab in sums
                             else f"{'-':>12}" for lab in labels)
            ratios = " ".join(f"{sums[lab] / sums[base]:.3f}"
                              for lab in labels[1:]
                              if sums[lab] and sums[base])
            print(f"{name:<34} {'sum':<26} {cells}  {ratios}")


if __name__ == "__main__":
    main()
