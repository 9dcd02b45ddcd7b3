"""Time the split-K cluster GEMM at every K split, beside its plan's.

``kernels/csrc/cluster_gemm.cuh`` (``lut_matmul_fused``,
``mitchell_matmul_fused``) splits K over a thread-block cluster;
``approx_matmul.cluster_plan`` picks the split from the clusters of each
size that the device holds at once (``cudaOccupancyMaxActiveClusters``).
This times both kernels (the balanced tier's LUT, mitchell) at
chip_smoke.py's eight qwen3-1.7b shapes (M = 4 and 64, bf16) at every
split from 1 to 8 that leaves no slice empty, with chip_smoke.py's timer
(L2 flushed, the card spun before each start event), and prints each
split's ms, the device's cluster capacity and the plan's choice against
the fastest.

    PYTHONPATH=src python -m repro_torch.launch.cluster_sweep \\
        --out build/cluster_sweep

Writes ``<out>/sweep.json``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.kernels import approx_matmul as am
from repro_torch.kernels import mitchell_gemm as mg
from repro_torch.kernels import ops
from repro_torch.kernels.build import stream_of


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/cluster_sweep")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    sys.path.insert(0, root)
    import chip_smoke as cs         # its shapes and its timer

    if not torch.cuda.is_available():
        sys.exit("cluster_sweep needs a CUDA device")
    dev = torch.device("cuda")
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    lut = ops.lut_table(MultiplierSpec("appro42", 8, True, "orplane", 10),
                        dev)
    print(f"{torch.cuda.get_device_name(0)}; "
          f"{cs.nvidia_smi('name,power.limit')}", flush=True)
    res = {}
    for m, k, n in cs.MAIN_SHAPES:
        g = torch.Generator(device=dev).manual_seed(m + k + n)
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        sx, sw = ops._scales(x, w, 8)
        out = torch.empty(m, n, device=dev)
        steps = -(-k // am.CLUSTER_BK)
        for name, kern, tab, flags in (
                ("lut", am.KERNELS["lut_matmul_fused"], (lut.data_ptr(),),
                 ()),
                ("mitchell", mg.KERNELS["mitchell_matmul_fused"], (), (0,))):
            plan = am.fused_plan(kern, x, w, 8, *flags)
            caps = [am._capacity(kern.library, kern.symbol + "_capacity",
                                 0, (8, *flags, 1, 1), plan.rows, s)
                    for s in range(1, am.CLUSTER_MAX_SPLITS + 1)]
            times = {}
            for want in range(1, am.CLUSTER_MAX_SPLITS + 1):
                per = -(-steps // want)
                splits = -(-steps // per)
                if splits in times:
                    continue

                def call(s=splits, p=per):
                    kern(x.data_ptr(), 1, w.data_ptr(), 1, *tab,
                         sx.data_ptr(), sw.data_ptr(), out.data_ptr(), m, k,
                         n, 8, *flags, plan.rows, s, p * am.CLUSTER_BK,
                         stream_of(x))

                call()
                times[splits] = cs._timed_ms(torch, call, 20, flush)
            best = min(times, key=times.get)
            res[f"{name} {(m, k, n)}"] = {"capacity": caps, "plan":
                                          plan.splits, "ms": times}
            print(f"{name:8} {str((m, k, n)):17} tiles {plan.tiles:3} "
                  f"capacity {caps}; plan {plan.splits} "
                  f"{times[plan.splits]:.4f} ms, fastest {best} "
                  f"{times[best]:.4f} ms; "
                  + " ".join(f"{s}:{t:.4f}" for s, t in times.items()),
                  flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "sweep.json"), "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
