"""Time the cluster kernels at every cluster size, beside their plan's.

``kernels/csrc/cluster_gemm.cuh`` (``lut_matmul_fused``,
``nibble_lut_matmul_fused``, ``mitchell_matmul_fused``) and
``kernels/csrc/surrogate_cluster.cuh`` (``cim_gemm_fused``) split K over
a thread-block cluster; ``approx_matmul.cluster_plan`` picks the split
from the clusters of each size that the device holds at once
(``cudaOccupancyMaxActiveClusters``).  This times the kernels (the
balanced tier's LUT, the exact family's nibble sub-tables, mitchell, and
the surrogate served on bf16 and with noise and SQ on f32, as
chip_smoke.py times them) at chip_smoke.py's eight qwen3-1.7b shapes (M
= 4 and 64) at every split from 1 to 8 that leaves no slice empty, with
chip_smoke.py's timer (L2 flushed, the card spun before each start
event), and prints each split's ms, the device's cluster capacity and
the plan's choice against the fastest; and so the mesh path's partial
forms (``lut_matmul_partial``, ``nibble_lut_matmul_partial``,
``mitchell_matmul_partial``: the same kernel, its epilogue off) at
chip_smoke.py's shard shapes (PARTIAL_SHAPES).  ``--only int`` times the
int forms on the same kernel (``lut_matmul``, ``lut_matmul_mag`` over
the balanced tier's table faulted at phase 12's rate, ``mitchell_matmul``,
``nibble_lut_matmul`` over the balanced/4 lane's sub-tables: int8
operands) at the eight shapes and chip_smoke.py's SERVED_SHAPES, each
split checked bitwise against the plain version.  ``--only nibble`` runs
the nibble rows alone, and then the nibble kernel's block shapes
(``kernels/csrc/nibble_shapes.cu``: 512 threads one block an SM, and the
shipped 256 threads two blocks an SM, each planned over the frame's row
tiles 4, 16, 64 and over the shipped 4, 16) at the eight shapes and the
CNN's fc, each checked bitwise against the plain version.

``kernels/csrc/attn_cluster.cuh`` (``attn_fused``) splits a query
tile's kv blocks over a cluster; ``attn_gemm.attn_cluster_plan`` picks
the query tile bq, the split and the ring tile rk (and the blocks a
chunk).  This times it at chip_smoke.py's ATTN_MAIN (qwen3-1.7b's
decode round and prefill) on each path at every (bq, split, rk) that
fits, beside the plan's choice, the choice of the bare rule (fewest
waves x kv blocks of a tile's slowest rank; ties to fewer splits, the
larger bq, the larger rk) and the fastest.

``kernels/csrc/slstm_cluster.cuh`` (``slstm_scan``) keeps each sLSTM
head's recurrent weights in a cluster of cs blocks;
``slstm_scan.cluster_plan`` picks cs.  This times it at xlstm-125m's
width (batch 4, 4 heads of 192) at T = 1, 37 and 512 at every cluster
size that fits and on the streamed route (cs 0), beside the plan's
choice and the device's cluster capacity, and prints each size's time a
step, (ms(512) - ms(37)) / 475; at the smoke width (dh 16), where the
dot is small, that slope is the step's floor: the gates, the exchange
of h and the cluster barrier.

``kernels/csrc/conv_tile.cuh`` (``conv_lut_fused``, ``conv_log_fused``
and their partial forms up to 8 bits) cuts a conv into spatial tiles
with all of N over a persistent grid; ``conv_gemm.conv_plan`` picks the
micro-tile (pixels x columns a thread) and, from it, the tile, the
channel chunks and the tap groups.  This times it at chip_smoke.py's
five Table IV convs (batch 256) for its four variants (appro42's full
table, the exact family's nibble sub-tables, mitchell, log_our) with
every micro-tile the plan could take, beside the plan's choice and the
fastest; then the partial forms (``conv_lut_partial``,
``conv_log_partial``: int32 out) at chip_smoke.py's shard geometries
(the same convs with C halved where it splits, global scales 1.25x the
shard's own, as check_partials runs them), and counts the rows whose
plan is within 4% (fused) and 5% (partial) of the fastest.

    PYTHONPATH=src python -m repro_torch.launch.cluster_sweep \\
        --out build/cluster_sweep [--only conv|nibble|int]

Writes ``<out>/sweep.json``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.kernels import approx_matmul as am
from repro_torch.kernels import attn_gemm as ag
from repro_torch.kernels import cim_gemm as cg
from repro_torch.kernels import conv_gemm as cvg
from repro_torch.kernels import mitchell_gemm as mg
from repro_torch.kernels import ops
from repro_torch.kernels import slstm_scan as ss
from repro_torch.kernels.build import stream_of

# (B, nh, dh) of the sLSTM sweep and its lengths: xlstm-125m's width, and
# the smoke width for the step's floor
SLSTM_WIDTHS = [(4, 4, 192), (4, 4, 16)]
SLSTM_LENGTHS = (1, 37, 512)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/cluster_sweep")
    ap.add_argument("--only", choices=("all", "conv", "nibble", "int"),
                    default="all",
                    help="conv: the conv tile kernel's sweep alone; "
                    "nibble: the nibble GEMMs' alone; int: the int forms' "
                    "alone")
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
    subs = ops.nibble_table(MultiplierSpec("exact", 8, True), dev)
    gemms = [("lut", "lut_matmul", (lut.data_ptr(),), ()),
             ("nibble", "nibble_lut_matmul", (subs.data_ptr(),), ()),
             ("mitchell", "mitchell_matmul", (), (0,))]
    if args.only == "nibble":
        gemms = gemms[1:2]
    print(f"{torch.cuda.get_device_name(0)}; "
          f"{cs.nvidia_smi('name,power.limit')}", flush=True)
    res = {}

    def sweep(name, shape, kern, cap_args, plan, launch, steps):
        """Time `launch(splits, k_split)` at every split; record and print
        it beside the capacity (`cap_args` after the rows) and `plan`."""
        caps = [am._capacity(kern.library, kern.symbol + "_capacity", 0,
                             cap_args, plan.rows, s)
                for s in range(1, am.CLUSTER_MAX_SPLITS + 1)]
        times = {}
        for want in range(1, am.CLUSTER_MAX_SPLITS + 1):
            per = -(-steps // want)
            splits = -(-steps // per)
            if splits in times:
                continue

            def call(s=splits, p=per):
                launch(s, p * am.CLUSTER_BK)

            call()
            times[splits] = cs._timed_ms(torch, call, 20, flush)
        best = min(times, key=times.get)
        res[f"{name} {shape}"] = {"capacity": caps, "plan": plan.splits,
                                  "ms": times}
        print(f"{name:16} {str(shape):17} tiles {plan.tiles:3} capacity "
              f"{caps}; plan {plan.splits} {times[plan.splits]:.4f} ms, "
              f"fastest {best} {times[best]:.4f} ms; "
              + " ".join(f"{s}:{t:.4f}" for s, t in times.items()),
              flush=True)

    if args.only == "int":
        int_sweep(cs, dev, lut, sweep)
        _write(args.out, res)
        return
    if args.only != "nibble":
        conv_sweep(cs, dev, flush, res)
        if args.only == "conv":
            _write(args.out, res)
            return
        attn_sweep(cs, dev, flush, res)
        slstm_sweep(cs, dev, flush, res)
    partial_sweep(cs, dev, flush, gemms, sweep)
    mu, c0, c1 = -0.013, 1480.0, 2.1e-4     # a surrogate law with SQ
    sur = cg.KERNELS["cim_gemm_fused"]
    for m, k, n in cs.MAIN_SHAPES:
        g = torch.Generator(device=dev).manual_seed(m + k + n)
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        eps = torch.randn(m, n, generator=g, device=dev)
        sx, sw = ops._scales(x, w, 8)
        out = torch.empty(m, n, device=dev)
        steps = -(-k // am.CLUSTER_BK)
        for name, base, tab, flags in gemms:
            kern = {**am.KERNELS, **mg.KERNELS}[base + "_fused"]
            plan = am.fused_plan(kern, x, w, 8, *flags)

            def launch(s, ks, kern=kern, tab=tab, flags=flags, plan=plan):
                kern(x.data_ptr(), 1, w.data_ptr(), 1, *tab, sx.data_ptr(),
                     sw.data_ptr(), out.data_ptr(), m, k, n, 8, *flags,
                     plan.rows, s, ks, stream_of(x))

            sweep(name, (m, k, n), kern, (8, *flags, 1, 1), plan, launch,
                  steps)
        if args.only == "nibble":
            continue
        for name, var, xs, ws in (
                ("surrogate", cg.SERVED, x, w),
                ("surrogate noise", cg.NOISE_SQ, x.float(), w.float())):
            plan = cg.fused_launch_plan(xs, ws, var)
            bf = int(xs.dtype == torch.bfloat16)
            e = None if var == cg.SERVED else eps.data_ptr()

            def launch(s, ks, var=var, xs=xs, ws=ws, plan=plan, bf=bf, e=e):
                sur(xs.data_ptr(), bf, ws.data_ptr(), bf, sx.data_ptr(),
                    sw.data_ptr(), e, out.data_ptr(), m, k, n, 8,
                    float(np.float32(1.0 + mu)), float(np.float32(c0 * k)),
                    float(np.float32(c1)), var, plan.rows, s, ks,
                    stream_of(x))

            sweep(name, (m, k, n), sur, (var, bf, bf), plan, launch, steps)
    if args.only == "nibble":
        nibble_shapes(cs, dev, flush, subs, res)
    _write(args.out, res)


def int_sweep(cs, dev, lut, sweep) -> None:
    """The int forms of the cluster kernel (int8 in, int32 out) at every
    split at chip_smoke.py's eight LM shapes and SERVED_SHAPES, each
    split's result bitwise the plain version."""
    from repro_torch.core.faults import FaultConfig
    from repro_torch.kernels import ref

    spec = MultiplierSpec("appro42", 8, True, "orplane", 10)
    mag = ops.magnitude_lut(spec, FaultConfig.from_yield(rows=32, scale=1.0),
                            dev)
    subs = ops.nibble_table(MultiplierSpec("appro42", 8, True, "orplane", 4),
                            dev)
    for m, k, n in cs.MAIN_SHAPES + cs.SERVED_SHAPES:
        g = torch.Generator(device=dev).manual_seed(m * 13 + k + n)
        xq = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-128, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        out = torch.empty(m, n, dtype=torch.int32, device=dev)
        steps = -(-k // am.CLUSTER_BK)
        for name, kern, tab, flags, want in (
                ("lut int", am.KERNELS["lut_matmul"], (lut.data_ptr(),), (),
                 ref.lut_matmul_ref(xq, wq, lut)),
                ("mag int", am.KERNELS["lut_matmul_mag"], (mag.data_ptr(),),
                 (), am.lut_matmul_mag_plain(xq, wq, mag)),
                ("mitchell int", mg.KERNELS["mitchell_matmul"], (), (0,),
                 ref.mitchell_matmul_ref(xq, wq, compensated=False)),
                ("nibble int", am.KERNELS["nibble_lut_matmul"],
                 (subs.data_ptr(),), (), ref.nibble_matmul_ref(xq, wq,
                                                               subs))):
            plan = am.fused_plan(kern, xq, wq, 8, *flags)
            checked = set()

            def launch(s, ks, kern=kern, tab=tab, flags=flags, plan=plan,
                       want=want, checked=checked, name=name):
                kern(xq.data_ptr(), wq.data_ptr(), *tab, out.data_ptr(), m,
                     k, n, 8, *flags, plan.rows, s, ks, stream_of(xq))
                if s not in checked:        # the untimed first call
                    checked.add(s)
                    torch.cuda.synchronize()
                    if not torch.equal(out, want):
                        sys.exit(f"{name} {(m, k, n)} splits {s}: != plain "
                                 "version")

            sweep(name, (m, k, n), kern, (8, *flags), plan, launch, steps)


def _write(out, res) -> None:
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "sweep.json"), "w") as f:
        json.dump(res, f, indent=1)


# csrc/nibble_shapes.cu's block shapes: (threads, blocks an SM)
NIBBLE_SHAPES = ((512, 1), (256, 2))


def nibble_shapes(cs, dev, flush, subs, res) -> None:
    """The fused nibble GEMM at each of NIBBLE_SHAPES, planned over the
    frame's row tiles (4, 16, 64) and over the shipped NIBBLE_ROWS, at
    chip_smoke.py's eight LM shapes (bf16) and the CNN's fc (f32), its
    operands and timer; each bitwise the plain version.  Records each
    time and prints the row sums (the 64-row tile only where M > 16)."""
    from repro_torch.kernels.build import INT, PTR, CudaKernel, query

    kern = CudaKernel("nibble_shapes", "nibble_shape_fused",
                      [INT, PTR, INT, PTR, INT, PTR, PTR, PTR, PTR, INT,
                       INT, INT, INT, INT, INT, INT, PTR])
    sums = {}
    for m, k, n in cs.MAIN_SHAPES + [cs.CNN_FC]:
        g = torch.Generator(device=dev).manual_seed(m * 7 + k + n)
        x = torch.randn(m, k, generator=g, device=dev)
        w = torch.randn(k, n, generator=g, device=dev) * 0.02
        if (m, k, n) != cs.CNN_FC:
            x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        bf = int(x.dtype == torch.bfloat16)
        sx, sw = ops._scales(x, w, 8)
        want = am.nibble_lut_matmul_fused_plain(x, w, subs, sx, sw)
        out = torch.empty(m, n, device=dev)
        line = []
        for shape, (threads, per_sm) in enumerate(NIBBLE_SHAPES):
            for tiles in (am.CLUSTER_ROWS, am.NIBBLE_ROWS):
                plan = am.cluster_plan(m, k, n, lambda r, s, sh=shape: query(
                    "nibble_shapes", "nibble_shape_capacity", sh, r, 8, bf,
                    bf, s), tiles)

                def call(sh=shape, p=plan):
                    kern(sh, x.data_ptr(), bf, w.data_ptr(), bf,
                         subs.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                         out.data_ptr(), m, k, n, 8, p.rows, p.splits,
                         p.k_split, stream_of(x))

                call()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    sys.exit(f"nibble shape {threads}x{per_sm} rows "
                             f"{plan.rows} {(m, k, n)}: != plain version")
                ms = cs._timed_ms(torch, call, 20, flush)
                tag = f"{threads}x{per_sm} rows {max(tiles)}"
                sums[tag] = sums.get(tag, 0.0) + ms
                res[f"nibble shape {tag} {(m, k, n)}"] = {
                    "rows": plan.rows, "tiles": plan.tiles,
                    "splits": plan.splits, "ms": ms}
                line.append(f"{tag}: {plan.rows} rows {plan.tiles}x"
                            f"{plan.splits} {ms:.4f}")
        print(f"nibble shapes {str((m, k, n)):17} " + "; ".join(line),
              flush=True)
    print("nibble shapes, row sums (ms): " + "; ".join(
        f"{t} {v:.4f}" for t, v in sums.items()), flush=True)
    res["nibble shape sums"] = sums


def _median_ms(cs, fn, reps, flush) -> float:
    """The median of `reps` launches of `fn`, each timed as chip_smoke.py
    times one (L2 flushed, the card spun, CUDA events): a launch whose
    host work outlasted the spin moves a mean of a few launches, not
    their median."""
    return float(np.median([cs._timed_ms(torch, fn, 1, flush)
                            for _ in range(reps)]))


def conv_sweep(cs, dev, flush, res) -> None:
    """Time the conv tile kernel at chip_smoke.py's CNN_CONVS (batch 256,
    its operands and timer, the median of 15 launches) on each variant
    with every micro-tile of conv_gemm.TILE_MICRO that fits (the rest of
    each plan as conv_plan cuts it), the fused forms at the full convs
    and the partial forms at the shard geometries; record each, print the
    plan's choice and the fastest, and count the rows whose plan is
    within 4% (fused) or 5% (partial) of the fastest."""
    variants = [("lut appro42", "lut",
                 ops.lut_table(MultiplierSpec("appro42", 8, True), dev)),
                ("nibble exact", "nibble",
                 ops.nibble_table(MultiplierSpec("exact", 8, True), dev)),
                ("mitchell", "mitchell", None), ("log_our", "log_our", None)]
    near = {}
    for partial, slack in ((False, 0.04), (True, 0.05)):
        kind = "partial" if partial else "conv"
        for gi, (h, w, c, n) in enumerate(cs.CNN_CONVS):
            b = cs.CNN_BATCH
            if partial:           # check_partials' shard and operands
                c = c // 2 if c % 2 == 0 else c
                g = torch.Generator(device=dev).manual_seed(41 * gi + 5)
            else:
                g = torch.Generator(device=dev).manual_seed(31 * gi + 7)
            x = torch.randn(b, h, w, c, generator=g, device=dev)
            w3 = torch.randn(9, c, n, generator=g, device=dev) * 0.1
            sx, sw = ops._scales(x, w3.reshape(-1, n), 8)
            if partial:
                sx, sw = sx * 1.25, sw * 1.25
            for label, form, tab in variants:
                plan = cvg.device_plan(form, 8, x, w3, 3, 3, 1)
                times = {}
                for micro in cvg.TILE_MICRO:
                    try:
                        p = cvg.device_plan(form, 8, x, w3, 3, 3, 1,
                                            force=micro)
                    except ValueError:    # no tile of this micro-tile fits
                        continue

                    def call(f=micro):
                        cvg._conv_tile_forced(x, w3, tab, sx, sw, form, 8,
                                              3, 3, 1, f, partial=partial)

                    call()
                    times[micro] = (_median_ms(cs, call, 15, flush),
                                    (p.ib, p.tr, p.tc, p.tiles, p.grid))
                mine = (plan.rp, plan.rn)
                fast = min(times, key=lambda m: times[m][0])
                ok = times[mine][0] <= (1 + slack) * times[fast][0]
                entry = (("conv_lut_" if tab is not None else "conv_log_")
                         + ("partial" if partial else "fused"))
                near.setdefault(entry, []).append(ok)
                res[f"{kind} {label} {(b, h, w, c, n)}"] = {
                    "plan": list(mine), "plan_ms": times[mine][0],
                    "fastest": list(fast), "fastest_ms": times[fast][0],
                    "grid": [[*m, t, *geo] for m, (t, geo) in times.items()]}
                print(f"{kind} {label:12} {str((b, h, w, c, n)):22} (rp, rn): "
                      f"plan {mine} {times[mine][0]:.4f} ms, fastest {fast} "
                      f"{times[fast][0]:.4f} ms; "
                      + " ".join(f"{m[0]}x{m[1]}:{t:.4f}"
                                 for m, (t, _) in times.items()), flush=True)
    res["conv plan near the fastest"] = {k: [sum(v), len(v)]
                                         for k, v in near.items()}
    print("plan's micro-tile within 4% (fused) / 5% (partial) of the "
          "fastest: " + "; ".join(f"{k} {sum(v)} of {len(v)}"
                                  for k, v in near.items()), flush=True)


def partial_sweep(cs, dev, flush, gemms, sweep) -> None:
    """The partial forms of `gemms` ((name, wrapper base name, table
    pointer, flags): LUT, nibble, mitchell; int32 out) at chip_smoke.py's
    shard shapes, with its operands (bf16, global scales 1.25x the
    shard's own), at every split through `sweep`."""
    for m, k, n in cs.PARTIAL_SHAPES:
        g = torch.Generator(device=dev).manual_seed(m * 11 + k + n)
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        sx, sw = ops._scales(x, w, 8)
        sx, sw = sx * 1.25, sw * 1.25
        out = torch.empty(m, n, dtype=torch.int32, device=dev)
        steps = -(-k // am.CLUSTER_BK)
        for name, base, tab, flags in gemms:
            name += " partial"
            kern = {**am.KERNELS, **mg.KERNELS}[base + "_partial"]
            plan = am.fused_plan(kern, x, w, 8, *flags)

            def launch(s, ks, kern=kern, tab=tab, flags=flags, plan=plan):
                kern(x.data_ptr(), 1, w.data_ptr(), 1, *tab, sx.data_ptr(),
                     sw.data_ptr(), out.data_ptr(), m, k, n, 8, *flags,
                     plan.rows, s, ks, stream_of(x))

            sweep(name, (m, k, n), kern, (8, *flags, 1, 1), plan, launch,
                  steps)


def attn_sweep(cs, dev, flush, res) -> None:
    """Time `attn_fused` at chip_smoke.py's ATTN_MAIN on each of its
    paths (its inputs, tables and timer) at every (bq, splits, rk) the
    plan can take; record each, and print the plan's choice, the bare
    rule's and the fastest."""
    from repro_torch.core.autotune import heuristic_attn_block

    paths = [("lut", "lut", MultiplierSpec("appro42", 8, True, "orplane",
                                           10), False),
             ("log", "log", None, False), ("log_our", "log", None, True),
             ("nibble", "nibble", MultiplierSpec("exact", 8, True), False),
             ("mxu", "mxu", None, False)]
    for label, path, spec, comp in paths:
        table = ops._attn_table(path, spec, dev)
        for geom in cs.ATTN_MAIN:
            (q, k, v), sc, pos, window = cs._attn_inputs(
                torch, dev, *geom, seed=5)
            sq, skv = geom[3], geom[4]
            bk = heuristic_attn_block(f"pallas_attn_{path}", sq, skv)[1]
            kw = dict(path=path, bits=8, causal=True, window=window,
                      compensated=comp, block=(8, bk))
            plan = ag.device_plan(q, k, path, 8, bk, comp, causal=True)
            nk = -(-skv // bk)
            grid = {}
            for bq in sorted({min(c, sq) for c in ag.QUERY_ROWS}):
                for splits in range(1, min(ag.MAX_SPLITS, nk) + 1):
                    for rk in ag.RING_KEYS:
                        force = dict(bq=bq, splits=splits, rk=rk)
                        try:
                            p = ag.device_plan(q, k, path, 8, bk, comp,
                                               causal=True, force=force)
                        except ValueError:       # no block of it fits
                            continue

                        def call(f=force):
                            ag._attn_fused_forced(q, k, v, *sc, *pos, table,
                                                  f, **kw)

                        call()
                        blocks = ag._blocks_a_tile(nk, bk, sq, skv, bq,
                                                   splits, p.per, True)
                        grid[(bq, splits, rk)] = (
                            cs._timed_ms(torch, call, 10, flush),
                            p.waves * blocks)
            mine = (plan.bq, plan.splits, plan.rk)
            fast = min(grid, key=lambda c: grid[c][0])
            bare = min(grid, key=lambda c: (grid[c][1], c[1], -c[0], -c[2]))
            res[f"attn {label} {geom[:6]}"] = {
                "plan": plan._asdict(), "plan_ms": grid[mine][0],
                "fastest": fast, "fastest_ms": grid[fast][0],
                "bare_rule": bare, "bare_rule_ms": grid[bare][0],
                "grid": [[*c, t, w] for c, (t, w) in grid.items()]}
            print(f"attn {label:8} {str(geom[:6]):26} (bq, splits, rk): "
                  f"plan {mine} {grid[mine][0]:.4f} ms, bare rule {bare} "
                  f"{grid[bare][0]:.4f} ms, fastest {fast} "
                  f"{grid[fast][0]:.4f} ms of {len(grid)}", flush=True)


def slstm_sweep(cs, dev, flush, res) -> None:
    """Time `slstm_scan` at SLSTM_WIDTHS x SLSTM_LENGTHS at every cluster
    size that fits and streamed, from a nonzero state (chip_smoke.py's
    inputs and timer); record and print each beside the plan's choice
    and the capacity, and each size's time a step."""
    for b, nh, dh in SLSTM_WIDTHS:
        sizes = ss.fitting_sizes(dh, dev)
        caps = {c: ss._capacity(ss._index(dev), dh, c) for c in sizes}
        plan = ss.device_plan(b, nh, dh, dev)
        times = {}
        for t in SLSTM_LENGTHS:
            u, r, bias, state = cs._slstm_inputs(torch, dev, (b, nh, dh, t),
                                                 "state")
            for c in sizes + [0]:
                def call(c=c):
                    ss._launch(u, r, bias, nh, state, c)

                call()
                times.setdefault(c, {})[t] = cs._timed_ms(torch, call, 10,
                                                          flush)
            best = min(times, key=lambda c: times[c][t])
            print(f"slstm ({b}, {nh}, {dh}) T {t:3}: capacity {caps}; plan "
                  f"{plan.cs} {times[plan.cs][t]:.4f} ms, fastest {best} "
                  f"{times[best][t]:.4f} ms; "
                  + " ".join(f"{c}:{times[c][t]:.4f}" for c in times),
                  flush=True)
        lo, hi = SLSTM_LENGTHS[1], SLSTM_LENGTHS[-1]
        step = {c: 1e3 * (v[hi] - v[lo]) / (hi - lo) for c, v in times.items()}
        print(f"slstm ({b}, {nh}, {dh}) us a step, (ms({hi}) - ms({lo})) / "
              f"{hi - lo}: " + " ".join(f"{c}:{v:.3f}" for c, v in
                                         step.items()), flush=True)
        res[f"slstm {(b, nh, dh)}"] = {
            "capacity": caps, "plan": plan.cs, "ms": times, "us_step": step}


if __name__ == "__main__":
    main()
