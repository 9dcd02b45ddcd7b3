"""Time the GEMM and conv kernels of several checkouts on one card, A/B.

Each root is a checkout of this repository (a ``git archive`` unpacked
anywhere).  For each root, in the order given, one process imports that
root's ``chip_smoke.py``, builds its kernels into its own ``build/`` and
runs its phase-3 checks (``check_kernels`` and, where the root has it,
``check_conv``): every kernel bitwise against its plain version, then
timed per shape (mean of 10 launches, each after an L2 flush).  Give
the roots in a balanced order, e.g. parent, change, change, parent, so
that drift over the call cancels; runs of one root are averaged.

    python3 src/repro_torch/launch/kernel_ab.py --out build/ab/out \
        parent=build/ab/parent change=. change=. parent=build/ab/parent

It writes ``<out>/ab.json`` ({label: {kernel: {shape: [ms, ...]}}}) and
prints, per kernel and shape, each label's mean ms and its ratio to the
first label's.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
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
log = open(sys.argv[1], "w")
with contextlib.redirect_stdout(log):
    build.build(build.SOURCES)
    if hasattr(cs, "log_clocks"):      # the log bounds read the SASS
        cs.log_clocks(build)
    clock = float(cs.nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name, rs in cs.check_kernels(torch, sms, clock).items():
        for r in rs:
            if "ms" in r:
                out.setdefault(name, {})[str(tuple(r["shape"]))] = r["ms"]
    if hasattr(cs, "check_conv"):
        for name, rs in cs.check_conv(torch, sms, clock).items():
            for r in rs:
                if "ms" in r:
                    key = f"{name}[{r['variant']}]"
                    out.setdefault(key, {})[str(tuple(r["geometry"][:5]))] \
                        = r["ms"]
print(json.dumps(out))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("runs", nargs="+", metavar="LABEL=ROOT",
                    help="a label and a checkout, run in the order given")
    ap.add_argument("--out", default="build/ab/out",
                    help="directory for ab.json and the runs' logs")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    times = defaultdict(lambda: defaultdict(lambda: defaultdict(list)))
    labels = []
    for i, run in enumerate(args.runs):
        label, root = run.split("=", 1)
        if label not in labels:
            labels.append(label)
        log = os.path.abspath(os.path.join(args.out, f"run{i}-{label}.log"))
        proc = subprocess.run([sys.executable, "-c", _CHILD, log],
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
    base = labels[0]
    names = sorted({n for lab in labels for n in times[lab]})
    print(f"{'kernel':<34} {'shape':<26} "
          + " ".join(f"{lab:>12}" for lab in labels)
          + "  ratio to " + base)
    for name in names:
        shapes = sorted({s for lab in labels for s in times[lab][name]})
        sums = defaultdict(float)
        for shape in shapes:
            means = {}
            for lab in labels:
                ms = times[lab][name].get(shape)
                if ms:
                    means[lab] = sum(ms) / len(ms)
                    sums[lab] += means[lab]
            cells = " ".join(f"{means[lab]:12.4f}" if lab in means
                             else f"{'-':>12}" for lab in labels)
            ratios = " ".join(f"{means[lab] / means[base]:.3f}"
                              for lab in labels[1:]
                              if lab in means and base in means)
            print(f"{name:<34} {shape:<26} {cells}  {ratios}")
        if len(shapes) > 1:
            cells = " ".join(f"{sums[lab]:12.4f}" if lab in sums
                             else f"{'-':>12}" for lab in labels)
            print(f"{name:<34} {'sum':<26} {cells}")


if __name__ == "__main__":
    main()
