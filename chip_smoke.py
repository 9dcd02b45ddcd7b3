#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--layers N] [--phases N [N ...]]

Phases, each of which must pass (the script exits nonzero otherwise):

  1. device: the card's name and count, and ``nvidia-smi``'s name and
     power limit;
  2. build: the seven CUDA sources (src/repro_torch/kernels/csrc)
     compiled by ``nvcc`` for sm_90a in parallel, with the ``-Xptxas -v``
     report; the log kernels' product loop read from their SASS
     (``cuobjdump``; for the split-K cluster kernel, its K step's product
     section, fused, partial and int instantiations; for the fused convs'
     tile kernel, its channel loops), its
     instructions a product counted by pipe; the
     tensor-core instructions (IMMA, IGMMA) of every int8_mma.cuh kernel
     and of every instantiation of the fused surrogate kernel
     (surrogate_cluster.cuh) counted, none failing; the nibble int form's
     cluster instantiations (ClusterNibbleCore, IntOut, rows 4 and 16)
     found in libnibble_gemm and no template kernel there; the attention
     cluster kernel's and the template's instantiations found in
     libattn_gemm, each in its three modes (fused, scores, PV) on the five
     paths;
  3. kernels: each of the seven GEMM kernels (full-LUT gather, its
     magnitude-table form, nibble sub-LUT gather and log-domain, int and
     fused forms) against its plain PyTorch version on the card, bitwise,
     at the shapes the qwen3-1.7b serving path gives them (M = 4 for a
     decode round of 4 slots, M = 64 for a 4 x 16 prefill, times the
     model's four (K, N) weight shapes; bf16 operands), the Table IV CNN's
     fc shape (f32 operands, as the CNN feeds them) and one ragged shape
     (the nibble kernels for the exact table and appro42 with 4
     approximate columns, the int forms also at the saturating int8
     minimum, the magnitude form over the balanced tier's table faulted
     at phase 12's rate and clean); the int LUT, magnitude, nibble and
     log forms (the split-K cluster kernel with int8 operands) also at
     SERVED_SHAPES (M = 1, 2, 8, 16, 20, the per-token and faulted lanes'
     calls), timed beside their bound and share, and at 2..8 bits (exact
     and appro42 tables, faulted and clean, mitchell and log_our, log_our's
     operands past 2^bits refused; the nibble form at the even widths on
     every int8, its magnitudes saturated at qmax); the fused LUT, nibble
     and log GEMMs,
     their partial forms and the int forms (the split-K cluster kernel,
     csrc/cluster_gemm.cuh, epilogue on, off and int8 in) also bitwise at
     CLUSTER_EDGES (every M, K and N corner
     of its plan, bf16 and f32, the LUT at 4 and 8 bits, the nibble forms
     for the exact family at 2, 4, 6 and 8 bits and appro42/4, one shape
     also on operands 2 and 4 bytes off 16-byte alignment, the log
     kernel at 8 and, through the tiled side of its bits gate, 16; each
     partial also through the epilogue against its fused form; the int
     forms on int8, one shape 1 byte off alignment), its
     launch plans printed and the LUT's table fill timed (a K = 32
     call with the 8-bit table against a 4-bit one); the two
     implicit-GEMM conv kernels (full LUT, nibble for
     both specs, Mitchell, Log-our; up to 8 bits the tile kernel,
     csrc/conv_tile.cuh, its launch plans printed) bitwise at the CNN's
     five conv geometries at the evaluation batch of 256, the reference
     tests' ragged shapes and one ResNet-18 conv2_x layer (4 x 56 x 56 x
     64 -> 64, timed, its routing printed), each variant's row sum
     printed apart, and at CONV_TILE_EDGES (several N tiles, ragged N,
     one pixel tile and many, stride 2 with 5x5 and 7x7 taps, C = 3 and
     96 on a 60-wide plane; the LUT also at 4 bits, log at 16 bits on the
     template's entry; each variant's partial form too), every launch
     counted on the route it takes; then
     the three attention kernels (fused, and the oracle's scores and PV
     stages: the cluster kernel, csrc/attn_cluster.cuh, in its three
     modes) on every datapath at the serving decode and prefill
     geometries, the reference tests' geometry and a long ragged decode
     (Skv 2048): scores bitwise against the plain version and against the
     template's scores stage (``attn_scores_wide``, forced at 8 bits: the
     independent witness), PV bitwise the template's PV over the same
     stored scores, fused bitwise against the oracle, fused and the PV
     stage within 8 eps of |plain| in every output (only the order of the
     l sum differs), one ``attn_materialized`` launching each cluster
     stage once and no template kernel, and the fused and PV modes forced
     to every split of the kv blocks (the scores mode to every split of
     its grid), each bitwise both oracles, also at a head dim of 10 and
     with K/V (and, for PV, the scores) one float off 16-byte alignment
     (the element-wise loads); the log path's 10- and 12-bit operands on
     the template's kernels (``attn_fused_wide``, ``attn_scores_wide``,
     ``attn_pv_wide``: fused_route's and materialized_route's other
     side), each call launching only those, fused bitwise the oracle and
     within 8 eps of plain; the surrogate GEMMs at
     the LM shapes, the CNN's fc and the ragged shape: ``cim_gemm_core``
     D bitwise and SQ within (K - 1) 2^-24 relative of the exact value
     (the f32 sum's bound), ``cim_gemm_fused`` (the split-K cluster kernel,
     csrc/surrogate_cluster.cuh, its launch plans printed) for the
     appro42 and log_our coefficients bitwise without noise and, given
     the same eps, with it (bf16 and f32 operands; SQ exact on the
     tensor cores), also at SURROGATE_EDGES (every row tile, K split, N
     edge, the CNN's fc and a noisy conv's im2col GEMM; bf16, f32 and
     mixed operands; 2, 4 and 8 bits; each variant; operands random and
     at +-max), and ``cim_gemm_core`` without SQ (the int8 tensor cores)
     also at ragged and split-K edge shapes with operands all -128 and
     all 127 (CORE_EDGES); and the exact-mode conv kernel
     (``conv_mxu_fused``, the int8 tensor cores) bitwise at the conv
     geometries above and its edge geometries (MXU_EDGES) and within
     1e-5 of ``F.conv2d`` on the dequantized operands (TF32 off); and the
     mesh path's five partial kernels (``lut_matmul_partial``,
     ``nibble_lut_matmul_partial``, ``mitchell_matmul_partial`` at the
     contraction-sharded wo and mlp.wo shapes at model = 2, M = 4 and
     64, bf16; ``conv_lut_partial`` full LUT and nibble,
     ``conv_log_partial`` at the CNN's convs with C halved where it
     splits, on the conv tile kernel, their launch plans printed)
     bitwise against their plain versions and, through the
     epilogue, their fused forms (timed beside them), the nibble partial
     also with an operand quantized past -qmax; and the fused sLSTM
     recurrence (``slstm_scan``) at xlstm-125m's width (batch 4, 4 heads
     of 192, T = 1, 37 and 512; batch 8, two row tiles a head, at T =
     37) and the smoke width (dh 16), from a zero and from a nonzero
     state, h and the final state within the tolerance
     kernels/slstm_scan.py states, each on the route its plan takes (the
     cluster kernel, csrc/slstm_cluster.cuh, with the plan's cluster
     size: printed with the time a step), also at every cluster size
     that fits at dh = 192, and the streamed kernel at one head too wide
     for any cluster (dh 512).  Each timed with CUDA events (L2 flushed
     before every launch, then the card spun for about 0.25 ms so that
     the launch's host work is queued before the start event), beside
     its plain version's time, a PyTorch call computing the same
     function where one exists (``torch._int_mm``, ``F.conv2d``), and
     the least time the card could take (the larger of the bytes the
     mask admits over 3.35 TB/s and the products' shared-memory gathers,
     log-product instructions, int8 tensor-core operations (the
     surrogate's SQ as four more int8 products) or, for the sLSTM
     recurrence, f32 FMAs over their peak rates at the card's maximum
     SM clock; the sLSTM bound leaves out the serial dependency across
     T) and the share of it the kernel reaches;
  4. reference: the LM on the card against the same LM on the CPU (the
     kernels' plain versions) on the smoke config, every tier of the
     hardware ladder with and without CiM attention, of the surrogate
     ladder (the card's approximate lanes run the fused surrogate
     kernel, the CPU's the plain torch_surrogate route), and a hardware
     lane of appro42 with 4 approximate columns (the nibble GEMM), and
     xlstm-125m-smoke on the hardware ladder (prefill + 4 decode steps,
     every sLSTM call through ``slstm_scan`` on the cluster route), to a
     stated tolerance with greedy-token agreement; then the norm's
     row-count invariance (rows 0-1 of 4 normed alone, bitwise, at d =
     2048 and 768);
  5. serve: ``build_engine`` over the hardware-mode ladder (exact /
     balanced / economy) and the nibble GEMM's lane (``balanced/4``:
     appro42/orplane with 4 approximate columns) on full-size
     qwen3-1.7b with seeded random weights, warmup, then a Poisson
     workload over the ladder (none of it to ``balanced/4``) served twice
     under a simulated clock (identical tokens, every request complete,
     both fused kernels launched, no plan misses after warmup) and once
     under the real clock (tokens/s and per-token p50 per tier); four of
     its requests pinned to ``balanced/4``, served twice under the
     simulated clock (identical tokens, no plan misses after warmup,
     ``nibble_lut_matmul_fused`` launched once a CiM GEMM of every
     forward and nothing else); then one
     decode round and one prefill per lane on the host clock, and one
     decode round per lane under torch.profiler (kernels, device busy
     time and idle share, device time by kernel class; three rounds,
     the median and the spread printed, each beside its CUDA-event span;
     a profile that saw fewer of the port's kernels than the launch
     counters say the call launched is printed, left out and made again,
     at most twice more; so in phases 6-8 and 10);
  6. serve with CiM attention: the same over ``build_tiers(mode=
     "hardware", attn=True)`` on all 28 layers, 320-token slots and a
     256-token prompt bucket, prompts of 130-250 tokens (so prefill spans
     two kv blocks and decode three, the last ragged): no plan misses
     after warmup, ``attn_fused`` launched 28 times per forward of the
     balanced and economy lanes and never on the exact lane, no float
     fallback, identical tokens when served again, one real-clock run,
     and three profiled decode rounds per lane;
  7. Table IV on the card: the CNN trained in float as the benchmark
     trains it (220 SGD steps), evaluated on 256 shifted images under
     the benchmark's reference semantics and in hardware mode for the
     four families (the Table IV rows of both); each hardware forward
     launches exactly five conv kernels of its family's entry and one fc
     GEMM kernel and builds no plan after the first, equals the im2col
     oracle (fused=False) bit for bit, and matches the CPU's plain
     versions on 16 images to a stated tolerance; one forward per family
     timed and profiled; then one exact-mode forward (the reference
     semantics: im2col and fake-quant, no port kernel launched; the
     reference row's top-1/top-5);
  8. surrogate, the compiler's default mode: the quickstart's macro
     (``CiMConfig(family="log_our", bits=8, mode="surrogate")``) warmed
     at the LM shapes, then ``matmul`` there with and without a noise
     key (no plan built after warmup, the same key the same output and a
     new key a new one, (out - det) / sqrt(var) of mean ~0 and variance
     ~1 within five standard errors, one shape against the CPU's route
     given the same eps); full-size qwen3-1.7b served on
     ``build_tiers(mode="surrogate")`` with phase 5's workload
     (``cim_gemm_fused`` launched 196 times per forward of the balanced
     and economy lanes and never on the exact lane, no plan misses after
     warmup, identical tokens when served twice, one real-clock run,
     three profiled decode rounds per lane); and ``cim_conv2d`` at the
     CNN's five geometries in exact mode (one ``conv_mxu_fused`` launch
     each, equal to the CPU's) and in surrogate mode with a key (the
     im2col route through the noisy fused kernel), then the five
     exact-mode convs as one run, timed and profiled;
  9. mesh: the unsharded engine on the hardware ladder serves six
     requests (8-token prompts, 3-8 new tokens, all three tiers) and
     records its tokens and logits; then four gloo ranks on the card
     (launch.mesh.spawn; the libraries already built, so no rank runs
     nvcc) form a (data 2, model 2) mesh and each runs (a)
     ``cim_matmul`` and ``model_matmul`` with the mesh at the eight LM
     shapes for the exact family's nibble lane, appro42/orplane/10,
     mitchell, log_our and bit_exact in both layouts, (b) ``cim_conv2d``
     at the CNN's five convs (batch 256 on "data") for the four
     families in both layouts where C or N splits (C = 3 must raise),
     each bitwise equal to the one-device call, and (c) the same
     workload on ``build_engine(mesh=...)`` over qwen3-1.7b at its
     published widths, 8 of its 28 layers (MESH_LAYERS):
     balanced and economy tokens identical and logits bitwise, the
     exact lane within 2^-3 of each step's largest |logit| up to its
     first differing token (tokens equal past that margin), no plan
     misses after warmup on any rank, 2 partial and 5 fused kernel
     launches a layer per approximate-lane forward on every rank, the same
     logits on every rank; per lane one decode round's time and the
     collectives' share, and rank 0's pool decode round under
     torch.profiler as in phase 5 (every rank decoding; the partials a
     class of their own).  The exact lane's first decode step is walked
     GEMM by GEMM (every rank's shards reassembled against the unsharded
     engine): the first GEMM whose fake-quantized input codes move is
     printed, and every GEMM before it must agree within the f32
     reassociation bound of the float tensor-parallel product.  Any rank
     that fails or hangs fails the phase;
 10. xLSTM: full-size xlstm-125m (12 layers, d 768, vocab 50304, seeded
     weights) on each lane of ``build_tiers(mode="hardware")``: batch 4,
     a 512-token prefill and 32 lockstep greedy decode steps; finite
     logits, tokens identical when the lane runs again, per forward 4
     ``slstm_scan`` launches on every lane (every one on the cluster
     route) and 48 ``lut_matmul_fused`` (balanced) or
     ``mitchell_matmul_fused`` (economy) launches and nothing else;
     prefill and decode-step time, tokens/s, peak memory and one
     profiled decode step and prefill per lane; then with ``cim=None``
     prefill + decode against the teacher-forced prefill of each prefix
     (the reference's 0.12);
 11. speculative decoding and per-token scales on full-size qwen3-1.7b
     (seeded bf16 weights): (a) ``model_matmul`` with per-token
     GemmParams for balanced, economy, balanced/4 and exact at the four
     LM (K, N) shapes, M = 20 (4 slots x 5 verify positions) and M = 4,
     bf16: every row of the M = 20 call bitwise that row of an M = 4
     call and of an M = 64 call (a prefill group), the integer lanes'
     bitwise the CPU's plain route and each M = 20 call exactly one
     launch of its int form (``lut_matmul``, ``mitchell_matmul``,
     ``nibble_lut_matmul``), timed at M = 4 and 20 beside its bound;
     (b) on ragged pools of 4 slots x 5 positions and, on the exact
     lane, 8 slots x 9 (72 rows), one ``decode_multi`` against as many
     sequential
     ``decode_step``s on cloned caches for the per-token exact lane and
     the three per-token hardware lanes: max |d logit| and the caches'
     max |d| (the first op that differs named from the recorded GEMM
     inputs and outputs), greedy tokens equal under phase 4's gap rule,
     196 int-form launches a forward and no fused form; (c)
     ``build_engine(spec_decode=4, spec_ks=(1, 2, 4))`` over the
     hardware ladder against an engine whose exact rung is
     ``spec_pair``'s verifier, 8 requests on ``exact`` (8-16-token
     prompts, 24-32 new tokens, all arriving at once, the second wave's
     budgets complementing the first's so the pool stays full) on the
     real clock at each depth: tokens identical to the baseline's but
     where its top-2 gap is within 1e-2 (printed), no plan built after
     warmup across the depth switches, every K/V entry at or past each
     slot's fill zero after every call; tokens/s over the run and over
     its full-pool window, acceptance, tokens a round, a round's host
     time against a per-token exact decode round's in those windows (the
     break-even), and a k = 1 call profiled.  The launches of (a)'s
     M = 4 and M = 64 calls and (b)'s sequential steps, held against the
     path, are the kernels line's ``check_launches``;
 12. fault injection and lane sentinels: (a) ``lut_matmul_mag`` (the
     faulted table's form of ``lut_matmul``: uint16 magnitude products,
     the signs from the operands; the split-K cluster kernel with int8
     operands, ClusterMagLutCore) bitwise its plain version with the
     balanced tier's table faulted at the Table V rate (32 rows, scale
     1.0) at the LM shapes, M = 4 and 64 (timed beside its bound), with
     the clean table bitwise ``lut_matmul``, and at 2..8 bits on the
     ragged shape; (b) full-size qwen3-1.7b on the hardware ladder (the
     exact rung per-token; 2 slots a tier, 64-token slots, one 8-token
     prompt bucket; bench_faults.py's workload: 16 Poisson requests at
     600/s): the clean ladder armed with ``SentinelConfig()`` for 8
     ticks, its sentinels' drift against the per-token exact rung and
     its trips printed (a measurement: at this width the default
     thresholds trip a clean lane); the faulted ladder (its probe
     cooldown 10 of its own rounds, measured after warmup, and at least
     2 s; the round, the cooldown, the run's seconds and each faulted
     lane's forwards in probes and else printed), its weight masks drawn
     first: every faulted lane trips
     within 8 tokens and no probe re-admits it, no request fails, every
     request finished on exact holds the
     exact-only run's tokens but where that run's top-2 gap is within
     1e-2 (printed), 196 ``lut_matmul_mag`` (balanced) or
     ``mitchell_matmul`` (economy) launches a faulted-lane forward and
     nothing else, no plan built after warmup; one decode round of each
     faulted lane profiled; (c) the reference's own setting,
     qwen3-1.7b-smoke on the card: the clean armed ladder 0 trips and the
     unarmed ladder's tokens, then the recovery drill (cooldown 0: a
     forced trip, the probe re-admits, traffic returns, no plan built);
     (d) one faulted ``cim_conv2d`` a family (conv_im2col, one int-kernel
     launch) bitwise the CPU's plain route.  (a)'s and (d)'s launches are
     the kernels line's ``check_launches``;
 13. per-module accuracy allocation (core/allocate.py): (a)
     ``characterize_batch`` on the card over BENCH_dse's six 12-bit specs
     at 200,000 samples, byte-equal to the serial ``characterize``, the
     serial, cold and median-of-3 steady seconds and the steady speedup
     printed (the reference contract's 10x recorded, not gated); (b)
     qwen3-1.7b-smoke, modules wq, wv and mlp_wo, ``make_evaluator(mode=
     "hardware")`` on the card and on the CPU on the same weights and
     tokens: the single-module truth table within rtol 0.15 of the CPU's
     (the exact column 0) and every selection's logits within phase 4's
     tolerance, then ``exhaustive_oracle`` (64 evaluations) and
     ``autoallocate`` at NMED 1e-2: both measured within the budget,
     autoallocate's energy at most 1.10x the oracle's; (c) qwen3-1.7b at
     its published widths (28 layers, seeded weights): the evaluator over
     the seven modules, its truth table, ``autoallocate`` at 1e-2 and,
     while that is all-exact, at twice the smallest approximate
     single-module NMED (then twice that, at most four reruns): the lane
     runs at least one approximate multiplier; (d) the ladder (exact,
     ``allocation_tier(a, mode="hardware")``), 4 slots a tier, 12 Poisson
     requests over both: all done, both tiers served, no plan built after
     warmup, identical tokens when served again, the allocation lane's
     fused GEMM launches (its modules' kernels, a layer each, a forward)
     and nothing else; an alloc table of all seven modules on the
     balanced tier's multiplier gives its prefill and decode logits
     bitwise; one decode round of the allocation lane on the host clock
     and three profiled.  (d)'s first run is phase 13's main path in the
     kernels line;
 14. telemetry (obs/, launch/obs.py): qwen3-1.7b at its published widths,
     8 of its 28 layers (OBS_LAYERS), on ``build_tiers(mode=
     "surrogate")`` (every approximate GEMM on ``cim_gemm_fused``): one
     engine with an ``EngineTelemetry`` attached and detached in turn,
     five off/on pairs of BENCH_obs's mix (24 requests, all at time 0),
     the pools reset between runs: tokens identical in every run, no plan
     built after warmup, the live ``repro_dispatch_macs_total`` of the
     telemetry-on runs equal to the energy meters' MACs, 56
     ``cim_gemm_fused`` launches a forward of balanced and economy and no
     other port kernel (these runs are phase 14's main path in the
     kernels line); the per-pair tokens/s ratios, their median and
     spread and each lane's estimated J/token printed (BENCH_obs's 3%
     reported, not gated); a decode round of each lane on the host clock
     and three profiled while the telemetry records, the approximate
     lanes' profiles showing the fused surrogate kernel; 20 adjacent
     off/on pairs of decode rounds a lane (the hooks' cost with less drift
     between the arms; the ratio's median printed); then the trace
     section (spec decoding at k = 2, sentinels of period 2, a forced trip
     of the balanced lane): the queue, prefill, decode, decode_round,
     spec_round and retry spans in a Chrome trace that loads as JSON.

``--layers`` cuts the depth of phase 5 only (the cut is printed); phases
9 and 14 serve 8 of qwen3-1.7b's 28 layers at its widths; each phase
prints its seconds;
``--phases`` runs phases 1, 2 and the listed ones and prints no result
lines.

It prints one ``{"kernels": [...]}`` JSON line and, last, one
``{"ok": true, "device": {...}}`` line.  Without a CUDA device it exits
nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
GATHERS_PER_SM_CLOCK = 32          # shared-memory words a clock
# shared-memory gathers a nibble product needs at least: the split-K
# cluster kernel folds the four sub-tables into two signed ones
# (csrc/cluster_gemm.cuh ClusterNibbleCore), so the fewest of any nibble
# kernel, as LOG_CLOCKS keeps the fewest clocks of any log loop, bounds
# every nibble row (GEMM, conv, attention): no share passes 100%
NIBBLE_GATHERS = 2
# SM clocks one log-domain product needs at least, keyed by `compensated`:
# phase 2 counts the instructions of the log kernels' product loop in
# their SASS (kernels/sass.py) and keeps the fewest of any instantiation
LOG_CLOCKS = {}
LUT_BYTES = (1 << 16) * 2          # the 8-bit int16 product table
MAG_BYTES = (1 << 14) * 2          # the 8-bit uint16 magnitude table

WEIGHT_SHAPES = ((2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048))
MAIN_SHAPES = [(m, k, n) for m in (4, 64) for (k, n) in WEIGHT_SHAPES]
CNN_FC = (256, 64, 10)             # the Table IV CNN's fc at batch 256
RAGGED = (33, 70, 17)
NIBBLE_BYTES = 4 * 16 * 16 * 4     # the 8-bit int32 nibble sub-tables
MIX = (("exact", None, 0.3), ("balanced", None, 0.4), ("economy", None, 0.3))
# the served workload: seed 1 draws all three tiers from MIX (6 balanced,
# 4 economy, 2 exact of 12 requests), which phase 5 checks
N_REQUESTS, WORKLOAD_SEED = 12, 1
REF_TOL = {"exact": 1e-2, "balanced": 4e-2, "economy": 4e-2,
           "balanced/4": 4e-2}

# phase 6: prompts of 130-250 tokens in one 256-token bucket, 320-token
# slots; seed 3 draws all three tiers (3 balanced, 3 economy, 2 exact)
ATTN_MIX = (("exact", None, 0.2), ("balanced", None, 0.4),
            ("economy", None, 0.4))
ATTN_REQUESTS, ATTN_SEED = 8, 3
INT8_TC_OPS_PER_S = 1979e12        # H100 SXM data sheet, dense int8
FP32_FMA_PER_SM_CLOCK = 128        # CUDA cores: 67 TFLOP/s at 132 SMs
# SQ = sum a^2 b^2 on the int8 tensor cores: four more products of
# squares' halves (csrc/surrogate_cluster.cuh)
SQ_INT8_PRODUCTS = 4
# attention geometries (B, H, KH, Sq, Skv, D, variant): the serving decode
# round (4 slots, ragged fill levels) and prefill (4 x 256, ragged
# lengths) of qwen3-1.7b, and the reference tests' geometry
ATTN_MAIN = [(4, 16, 8, 1, 320, 128, "decode"),
             (4, 16, 8, 256, 256, 128, "prefill")]
ATTN_SMALL = [(2, 4, 2, 21, 29, 12, v) for v in ("causal", "window",
                                                  "ragged")] \
    + [(2, 4, 2, 1, 29, 12, "decode")]
# a long ragged decode (a 2,048-token cache, slots filled to 2047, 1500,
# 700, 130): checked, with every split of its 16 kv blocks, not timed
ATTN_LONG = [(4, 16, 8, 1, 2048, 128, "decode")]
# the cluster kernel's element-wise K/V ring (no cp.async): a head dim of
# 10 (D % 4 != 0), and K/V one float past 16-byte alignment ("offset",
# else causal); checked as ATTN_SMALL is, not timed
ATTN_ODD = [(2, 4, 2, 21, 29, 10, "causal"), (2, 4, 2, 21, 29, 12, "offset")]
# the log path's operand widths past the cluster kernel's 8 bits, which
# fused_route sends to the template's fused kernel (attn_fused_wide):
# checked at ATTN_SMALL and the serving decode, not timed
ATTN_WIDE_BITS = (10, 12)
# an attention kernel against its plain version: |d| <= LSUM_EPS eps |plain|
# for every output (the l sum's rounding; see _lsum_check)
LSUM_EPS = 8

SOURCES = {
    "lut_matmul": ("src/repro_torch/kernels/csrc/cluster_gemm.cuh",
                   "src/repro/kernels/approx_matmul.py:137"),
    "lut_matmul_mag": ("src/repro_torch/kernels/csrc/cluster_gemm.cuh",
                       "src/repro/kernels/approx_matmul.py:137"),
    "lut_matmul_fused": ("src/repro_torch/kernels/csrc/cluster_gemm.cuh",
                         "src/repro/kernels/approx_matmul.py:230"),
    "mitchell_matmul": ("src/repro_torch/kernels/csrc/cluster_gemm.cuh",
                        "src/repro/kernels/mitchell_gemm.py:88"),
    "mitchell_matmul_fused": (
        "src/repro_torch/kernels/csrc/cluster_gemm.cuh",
        "src/repro/kernels/mitchell_gemm.py:173"),
    "attn_fused": ("src/repro_torch/kernels/csrc/attn_cluster.cuh",
                   "src/repro/kernels/attn_gemm.py:381"),
    "attn_scores": ("src/repro_torch/kernels/csrc/attn_cluster.cuh",
                    "src/repro/kernels/attn_gemm.py:447"),
    "attn_pv": ("src/repro_torch/kernels/csrc/attn_cluster.cuh",
                "src/repro/kernels/attn_gemm.py:461"),
    "nibble_lut_matmul": ("src/repro_torch/kernels/csrc/cluster_gemm.cuh",
                          "src/repro/kernels/approx_matmul.py:294"),
    "nibble_lut_matmul_fused": (
        "src/repro_torch/kernels/csrc/cluster_gemm.cuh",
        "src/repro/kernels/approx_matmul.py:389"),
    "conv_lut_fused": ("src/repro_torch/kernels/csrc/conv_tile.cuh",
                       "src/repro/kernels/conv_gemm.py:236"),
    "conv_log_fused": ("src/repro_torch/kernels/csrc/conv_tile.cuh",
                       "src/repro/kernels/conv_gemm.py:321"),
    "cim_gemm_core": ("src/repro_torch/kernels/csrc/surrogate_gemm.cu",
                      "src/repro/kernels/cim_gemm.py:60"),
    "cim_gemm_fused": ("src/repro_torch/kernels/csrc/surrogate_cluster.cuh",
                       "src/repro/kernels/cim_gemm.py:141"),
    # the fused kernel with its flush off (the mesh path's row-parallel
    # layers; the JAX package runs its surrogate modes through GSPMD)
    "cim_gemm_partial": ("src/repro_torch/kernels/csrc/surrogate_cluster.cuh",
                         "src/repro/kernels/cim_gemm.py:141"),
    "conv_mxu_fused": ("src/repro_torch/kernels/csrc/conv_gemm.cu",
                       "src/repro/kernels/conv_gemm.py:174"),
    "lut_matmul_partial": ("src/repro_torch/kernels/csrc/cluster_gemm.cuh",
                           "src/repro/kernels/approx_matmul.py:248"),
    "nibble_lut_matmul_partial": (
        "src/repro_torch/kernels/csrc/cluster_gemm.cuh",
        "src/repro/kernels/approx_matmul.py:402"),
    "mitchell_matmul_partial": (
        "src/repro_torch/kernels/csrc/cluster_gemm.cuh",
        "src/repro/kernels/mitchell_gemm.py:189"),
    "conv_lut_partial": ("src/repro_torch/kernels/csrc/conv_tile.cuh",
                         "src/repro/kernels/conv_gemm.py:259"),
    "conv_log_partial": ("src/repro_torch/kernels/csrc/conv_tile.cuh",
                         "src/repro/kernels/conv_gemm.py:343"),
    "slstm_scan": ("src/repro_torch/kernels/csrc/slstm_cluster.cuh",
                   "src/repro/kernels/slstm_scan.py:71"),
}
# the mesh path's partial kernels, timed at the shard-local shapes of the
# contraction-sharded wo and mlp.wo at model = 2
PARTIAL_KERNELS = ("lut_matmul_partial", "nibble_lut_matmul_partial",
                   "mitchell_matmul_partial", "cim_gemm_partial",
                   "conv_lut_partial", "conv_log_partial")
PARTIAL_SHAPES = [(m, k, n) for m in (4, 64)
                  for (k, n) in ((1024, 2048), (3072, 2048))]
GEMM_KERNELS = ("lut_matmul", "lut_matmul_fused", "mitchell_matmul",
                "mitchell_matmul_fused", "nibble_lut_matmul",
                "nibble_lut_matmul_fused")
# the int forms on the split-K cluster kernel (the oracles that the
# per-token and faulted lanes serve): phase 3 also holds them at the
# shapes those lanes give them, M = 1, 2 (a faulted lane's decode round
# of one or two slots), 8, 16 (its 4-8-token prompts over 2 slots) and 20
# (phase 11's verify), times the four LM (K, N), timed; at 2..8 bits (the
# nibble form at the even ones) on the ragged shape and INT_BITS_SHAPE
INT_KERNELS = ("lut_matmul", "lut_matmul_mag", "mitchell_matmul",
               "nibble_lut_matmul")
SERVED_SHAPES = [(m, k, n) for m in (1, 2, 8, 16, 20)
                 for (k, n) in WEIGHT_SHAPES]
INT_BITS_SHAPE = (20, 2048, 1024)
# the Table IV CNN (models/cnn.py, width 16): its five conv geometries
# (H, W, C, N), 3x3 at stride 1, at the evaluation batch, and one
# ResNet-18 conv2_x layer, timed only (B, H, W, C, N)
CNN_BATCH = 256
TRAIN_STEPS = 220                  # the benchmark's float training run
CNN_CONVS = [(16, 16, 3, 16), (16, 16, 16, 16), (8, 8, 16, 32),
             (8, 8, 32, 32), (4, 4, 32, 64)]
CONV_RAGGED = [(2, 9, 10, 5, 7, 3, 3, 1), (1, 7, 7, 3, 4, 5, 5, 1),
               (3, 8, 6, 4, 5, 1, 1, 1), (2, 10, 9, 3, 6, 3, 3, 2)]
RESNET = (4, 56, 56, 64, 64)
# the fused convs' tile kernel (csrc/conv_tile.cuh) at its edges, checked
# bitwise on every variant, not timed: several N tiles with ragged
# channels, ragged N, N = 1, one pixel tile, a plane wider than one tile
# in both dimensions, stride 2 with 5x5 and 7x7 taps, C = 3 and C = 96 on
# a 60-wide plane
CONV_TILE_EDGES = [(3, 12, 12, 17, 80, 3, 3, 1), (2, 9, 9, 3, 7, 3, 3, 1),
                   (2, 11, 7, 17, 1, 3, 3, 1), (1, 5, 5, 4, 16, 3, 3, 1),
                   (1, 20, 700, 8, 16, 3, 3, 1), (2, 13, 13, 3, 16, 5, 5, 2),
                   (2, 30, 30, 3, 64, 7, 7, 2), (1, 20, 60, 96, 24, 3, 3, 1),
                   (1, 20, 60, 3, 24, 3, 3, 1)]
# the tensor-core kernels' edge cases (checked bitwise, not timed):
# cim_gemm_core without SQ at ragged M, K, N (the byte-staged path), a
# split-K shape at N = 8 and at M = 130, with operands random, all -128
# and all 127; conv_mxu_fused at C = 17, N = 80 and 130 (several N
# tiles), stride 2 with 5x5 and 7x7 taps, a ragged image group, and
# channels in chunks with taps in two groups (C = 96 on a 60-wide plane)
CORE_EDGES = [(1, 31, 7), (17, 33, 17), (130, 6144, 2048), (4, 1, 1),
              (64, 2048, 8), (130, 2048, 17)]
MXU_EDGES = [(8, 12, 12, 17, 80, 3, 3, 1), (4, 9, 11, 5, 130, 3, 3, 2),
             (2, 13, 13, 3, 16, 5, 5, 2), (2, 30, 30, 3, 64, 7, 7, 2),
             (5, 4, 4, 8, 10, 3, 3, 1), (1, 20, 60, 96, 24, 3, 3, 1)]
# the split-K cluster kernel's edge cases (lut_matmul_fused,
# mitchell_matmul_fused and their partial forms, the kernel with its
# epilogue off; checked bitwise, not timed): every M in {1, 4, 17,
# 64, 65, 130, 2048} (one row tile of 4, 16 or 64 rows, or several), K in
# {1, 31, 33, 2048, 6144} (one step, ragged steps, up to 8 slices) and N
# in {1, 7, 8, 17, 2048} (ragged tiles, rows not 16-byte multiples: the
# element loads), bf16 and f32 operands by turns, the LUT at 4 and 8
# bits, the log kernel at 8 bits (mitchell, log_our) and, on the first
# CLUSTER_WIDE_EDGES shapes, at 16 (fused_route's tiled side); one shape
# also with both operands 2 bytes off 16-byte alignment
CLUSTER_EDGES = [(1, 31, 7), (4, 1, 1), (17, 33, 17), (64, 2048, 8),
                 (65, 6144, 17), (130, 33, 2048), (2048, 31, 1),
                 (4, 6144, 2048), (2048, 2048, 7), (1, 2048, 2048),
                 (130, 6144, 8)]
CLUSTER_WIDE_EDGES = 6
# the fused surrogate kernel's edge cases (cim_gemm_fused on
# csrc/surrogate_cluster.cuh; checked bitwise, not timed): one row tile of
# 16 rows (M = 1, 4 masked) or 64, several, K one step, ragged or split
# up to 8 slices, N ragged or many tiles, the CNN's fc and a noisy
# surrogate-mode conv's im2col GEMM (65,536 rows, K = 27, N = 16)
SURROGATE_EDGES = [(1, 31, 7), (4, 1, 1), (17, 33, 17), RAGGED,
                   (64, 2048, 8), (130, 2048, 17), (130, 6144, 2048),
                   CNN_FC, (65536, 27, 16)]
FAMS = ("exact", "appro42", "log_our", "mitchell")
# the kernels a hardware forward of the CNN runs, per family: (conv, fc)
CNN_KERNELS = {"exact": ("conv_lut_fused", "nibble_lut_matmul_fused"),
               "appro42": ("conv_lut_fused", "lut_matmul_fused"),
               "mitchell": ("conv_log_fused", "mitchell_matmul_fused"),
               "log_our": ("conv_log_fused", "mitchell_matmul_fused")}
# card against CPU logits on 16 images: everything up to the global mean
# pool is bitwise equal (the conv kernels equal their plain versions),
# the mean's sum order may differ in the last bit, and that can move one
# quantized code of the fc input, i.e. a logit by about
# max|h| / 127 * max|w_fc|: a few 1e-2 for the trained network
CNN_TOL = 5e-2
# the surrogate's calibrated (mu, c0, c1) of the balanced tier's
# multiplier (appro42/orplane/10) and of log_our, filled in phase 3
SURR_COEFFS = {}
# phase 8: the quickstart's macro, the noise keys, and the bound on the
# noise moments (five standard errors of a mean and a variance of
# M*N >= 2^17 standard normal draws)
MOMENT_SIGMAS = 5.0


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


# SM cycles the card spins between the L2 flush and a timed launch's
# start event (about 0.25 ms): long enough for the host to queue the
# launch, so its Python and driver work is not counted as kernel time
TIMER_SPIN_CYCLES = 500_000


def _timed_ms(torch, fn, reps: int, flush) -> float:
    """Mean device time of `fn` over `reps` launches, each after an L2
    flush (none with `flush` None: the L2 warm from the call before) and
    a spin of the card (TIMER_SPIN_CYCLES), from CUDA events."""
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(TIMER_SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def _bound(name: str, m: int, k: int, n: int, sms: int, clock_hz: float,
           esize: int = 2):
    """(bound_ms, bound_by) for one call: bytes each input read once and
    each output written once (a fused form's operands `esize` bytes
    each), against gathers at the SMs' peak rate or the log product's
    instructions at the rates of the pipes they run on (LOG_CLOCKS)."""
    fused = name.endswith("fused")
    nbytes = ((m * k + k * n) * esize + 4 + n * 4 + m * n * 4 if fused
              else m * k + k * n + m * n * 4)
    if name.startswith(("lut", "nibble")):
        nibble = name.startswith("nibble")
        nbytes += (NIBBLE_BYTES if nibble else MAG_BYTES
                   if name.endswith("mag") else LUT_BYTES)
        ops_s = (m * k * n * (NIBBLE_GATHERS if nibble else 1)
                 / (sms * GATHERS_PER_SM_CLOCK * clock_hz))
    else:
        ops_s = m * k * n * LOG_CLOCKS[False] / (sms * clock_hz)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(bytes_s, ops_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def log_clocks(build) -> None:
    """Fill LOG_CLOCKS from the SASS of the built log GEMM, conv and
    attention libraries: per instantiation of the template's LogCore, the
    product loop's instructions a product by pipe, and the SM clocks they
    need; per log instantiation of the cluster kernel
    (csrc/cluster_gemm.cuh, RB rows a block, BK k a stage, fused,
    partial and int), the same over its K step's product section (RB
    rows x BK / 4 k a thread); per log instantiation of the attention
    cluster kernel (csrc/attn_cluster.cuh), over each of its row loops;
    per log instantiation of the fused convs' tile kernel
    (csrc/conv_tile.cuh), over each of its channel loops (found by their
    dp4a, as the attention kernel's).  The fewest of all bound every log kernel, so
    no row's share passes 100%."""
    import re

    from repro_torch.kernels import sass
    from repro_torch.kernels.conv_gemm import ROWS_PER_THREAD, TILE

    print(f"  log product loop, instructions a product (alu / fma / xu / "
          f"either / all arithmetic) -> SM clocks a product, bound by:")
    cluster, tile = set(), set()
    for lib in ("log_gemm", "conv_gemm"):
        fns = sass.functions(sass.disassemble(build.library_path(lib)))
        for name, insns in sorted(fns.items()):
            for comp, tag in ((False, "TileLogILb0E"), (True, "TileLogILb1E")):
                if "conv_tile_kernel" not in name or tag not in name:
                    continue
                # the channel loops: a dp4a two products (mitchell) or one
                rp, rn = map(int, re.search(r"ELi(\d+)ELi(\d+)E",
                                            name).groups())
                for li, (body, idp) in enumerate(sass.idp_loops(insns)):
                    c = sass.section_per_product(body, idp * (1 if comp
                                                              else 2))
                    clk, by = sass.clocks_per_product(c)
                    LOG_CLOCKS[comp] = min(LOG_CLOCKS.get(comp, clk), clk)
                    tile.add(comp)
                    inst = (f"tile {'log_our' if comp else 'mitchell'} RP "
                            f"{rp} RN {rn} loop {li}")
                    print(f"    {lib:<9} {inst:<48} {c['alu']:.3f} / "
                          f"{c['fma']:.3f} / {c['xu']:.3f} / "
                          f"{c['either']:.3f} / {c['int']:.3f} -> "
                          f"{clk:.4f} ({by})")
            for comp, tag in ((False, "LogCoreILb0E"), (True, "LogCoreILb1E")):
                if tag not in name:
                    continue
                if "cluster_gemm_kernel" in name:
                    rb, bk = map(int, re.search(r"Li(\d+)ELi(\d+)E",
                                                name).groups())
                    c = sass.section_per_product(sass.step_products(insns),
                                                 rb * bk // 4)
                    form = ("partial" if "QuantIntOut" in name else
                            "int" if "IntOut" in name else "fused")
                    inst = (f"cluster {'log_our' if comp else 'mitchell'} "
                            f"RB {rb} BK {bk} {form}")
                    cluster.add((comp, form == "int"))
                else:
                    c = sass.per_product(insns, TILE[1], ROWS_PER_THREAD)
                    inst = name[name.index(tag):][:48]
                clk, by = sass.clocks_per_product(c)
                LOG_CLOCKS[comp] = min(LOG_CLOCKS.get(comp, clk), clk)
                print(f"    {lib:<9} {inst:<48} {c['alu']:.3f} / "
                      f"{c['fma']:.3f} / {c['xu']:.3f} / {c['either']:.3f} "
                      f"/ {c['int']:.3f} -> {clk:.4f} ({by})")
    # the attention cluster kernel's log instantiations: its tile GEMM's
    # row loops (QK^T and PV), each pass 16 products a lane, counted from
    # the loop's dp4a (IDP): mitchell two products each, log_our one
    attn = set()
    fns = sass.functions(sass.disassemble(build.library_path("attn_gemm")))
    for name, insns in sorted(fns.items()):
        for comp, tag in ((False, "ILi3ELb0E"), (True, "ILi3ELb1E")):
            if "attn_cluster_kernel" not in name or tag not in name:
                continue
            for li, (body, idp) in enumerate(sass.idp_loops(insns)):
                c = sass.section_per_product(body, idp * (1 if comp else 2))
                clk, by = sass.clocks_per_product(c)
                LOG_CLOCKS[comp] = min(LOG_CLOCKS.get(comp, clk), clk)
                attn.add(comp)
                inst = (f"attn cluster {'log_our' if comp else 'mitchell'} "
                        f"loop {li}")
                print(f"    {'attn_gemm':<9} {inst:<48} {c['alu']:.3f} / "
                      f"{c['fma']:.3f} / {c['xu']:.3f} / {c['either']:.3f} "
                      f"/ {c['int']:.3f} -> {clk:.4f} ({by})")
    if set(LOG_CLOCKS) != {False, True}:
        fail("no LogCore instantiation found in the log libraries' SASS")
    if cluster != {(c, i) for c in (False, True) for i in (False, True)}:
        fail("a cluster log kernel (fused or int, mitchell or log_our) is "
             "missing from liblog_gemm's SASS")
    if tile != {False, True}:
        fail("no channel loop of the conv tile kernel's log forms found in "
             "libconv_gemm's SASS")
    if attn != {False, True}:
        fail("no log product loop of the attention cluster kernel found in "
             "libattn_gemm's SASS")
    print(f"  LOG_CLOCKS (fewest of any instantiation): mitchell "
          f"{LOG_CLOCKS[False]:.4f}, log_our {LOG_CLOCKS[True]:.4f}",
          flush=True)


# the fused surrogate kernel's instantiations: 2 row tiles x 2 stage
# depths x 3 variants; its partial's: 2 x 2 x with and without SQ
SURROGATE_KERNELS = 12
SURROGATE_PARTIALS = 8


def tensor_core_check(build) -> None:
    """Count the tensor-core instructions (IMMA, IGMMA) in the SASS of
    every function csrc/int8_mma.cuh instantiates in the built libraries
    and of every instantiation of the fused surrogate kernel and of its
    partial (csrc/surrogate_cluster.cuh); fail if one has none, or if any
    is missing."""
    from repro_torch.kernels import sass

    found = surrogate = partial = 0
    for lib in ("surrogate_gemm", "conv_gemm"):
        fns = sass.functions(sass.disassemble(build.library_path(lib)))
        for name, insns in sorted(fns.items()):
            if ("int8_mma" not in name and "surrogate_cluster" not in name
                    and "surrogate_partial" not in name):
                continue
            found += 1
            surrogate += "surrogate_cluster" in name
            partial += "surrogate_partial" in name
            c = sass.tensor_core_counts(insns)
            print(f"  {lib:<14} {name[:56]:<56} IMMA {c['IMMA']}, IGMMA "
                  f"{c['IGMMA']} (of {len(insns)} instructions)", flush=True)
            if not c["IMMA"] + c["IGMMA"]:
                fail(f"{name} in lib{lib}: no tensor-core instruction")
    if found == surrogate + partial:
        fail("no int8_mma kernel found in the surrogate and conv libraries")
    if surrogate != SURROGATE_KERNELS or partial != SURROGATE_PARTIALS:
        fail(f"{surrogate} instantiations of the fused surrogate kernel and "
             f"{partial} of its partial in libsurrogate_gemm, expected "
             f"{SURROGATE_KERNELS} and {SURROGATE_PARTIALS}")


def nibble_int_check(build) -> None:
    """The nibble int form's instantiations in libnibble_gemm's SASS: the
    split-K cluster kernel on ClusterNibbleCore with IntOut at each of
    its row tiles (approx_matmul.NIBBLE_ROWS), and no tiled template
    kernel on NibbleCore; fail otherwise."""
    import re

    from repro_torch.kernels import sass
    from repro_torch.kernels.approx_matmul import NIBBLE_ROWS

    fns = sass.functions(sass.disassemble(build.library_path("nibble_gemm")))
    rows, template = set(), []
    for name in fns:
        if "cluster_gemm_kernel" in name and "17ClusterNibbleCore" in name \
                and "6IntOutE" in name:
            rows.add(int(re.search(r"CoreELi(\d+)E", name).group(1)))
        elif "gemm_kernel" in name and "10NibbleCore" in name:
            template.append(name)
    if rows != set(NIBBLE_ROWS) or template:
        fail(f"libnibble_gemm: the int form's cluster instantiations for "
             f"rows {sorted(rows)} (expected {list(NIBBLE_ROWS)}), template "
             f"kernels {template}")
    print(f"  nibble int form: cluster_gemm_kernel<ClusterNibbleCore, RB, "
          f"64, IntOut> for RB {sorted(rows)} in libnibble_gemm, no template "
          f"kernel", flush=True)


def attn_instances_check(build) -> None:
    """The attention kernels' instantiations in libattn_gemm's SASS: the
    cluster kernel (csrc/attn_cluster.cuh) and the template
    (csrc/attn_gemm.cu) each in its three modes (fused, scores, PV) for
    each path (log as mitchell and log_our): the cluster kernel up to 8
    bits, the template for 9..12-bit log operands and as the witness;
    fail if one is missing."""
    import re

    from repro_torch.kernels import sass

    kinds = ((0, 0), (1, 0), (2, 0), (3, 0), (3, 1))   # (path, comp)
    want = {(p, c, m) for p, c in kinds for m in range(3)}
    fns = sass.functions(sass.disassemble(build.library_path("attn_gemm")))
    found = {"cluster": set(), "template": set()}
    for name in fns:
        for kind, pat in (("cluster", r"attn_cluster_kernelILi(\d)ELb([01])"
                                      r"ELi(\d)E"),
                          ("template", r"attn_kernelILi(\d)ELb([01])E[as]"
                                       r"Li(\d)E")):
            m = re.search(pat, name)
            if m:
                found[kind].add(tuple(map(int, m.groups())))
    if found["cluster"] != want or found["template"] != want:
        fail(f"libattn_gemm: the attention kernels' (path, comp, mode) "
             f"instantiations: cluster {sorted(found['cluster'])}, template "
             f"{sorted(found['template'])}; expected each of {sorted(want)}")
    print(f"  attention: attn_cluster_kernel<PATH, COMP, MODE> and "
          f"attn_kernel<PATH, COMP, QT, MODE> in libattn_gemm, "
          f"{len(want)} each (5 paths x fused, scores, PV)", flush=True)


def check_kernels(torch, sms: int, clock_hz: float):
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.multipliers import MultiplierSpec
    from repro_torch.kernels import approx_matmul as am
    from repro_torch.kernels import mitchell_gemm as mg
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    # the balanced tier's multiplier (appro42, orplane cells, 10 columns)
    balanced = MultiplierSpec("appro42", 8, True, "orplane", 10)
    lut = ops.lut_table(balanced, dev)
    # its magnitude table faulted at phase 12's Table V rate (timed), and
    # clean (equal to lut_matmul on the int16 table)
    mags = {"": ops.magnitude_lut(balanced, FaultConfig.from_yield(
        rows=FAULT_ROWS, scale=1.0), dev),
            "[clean]": ops.magnitude_lut(balanced, None, dev)}
    # the nibble-decomposable specs: the exact table (timed) and appro42
    # with its approximate columns in the low half-word (phase 4's lane)
    subs = {"": ops.nibble_table(MultiplierSpec("exact", 8, True), dev),
            "[appro42/4]": ops.nibble_table(
                MultiplierSpec("appro42", 8, True, "orplane", 4), dev)}
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    rows = {name: [] for name in GEMM_KERNELS + ("lut_matmul_mag",)}
    for shape in MAIN_SHAPES + [CNN_FC, RAGGED]:
        m, k, n = shape
        g = torch.Generator(device=dev).manual_seed(m * 7 + k + n)
        x = torch.randn(m, k, generator=g, device=dev)
        w = torch.randn(k, n, generator=g, device=dev) * 0.02
        if shape != CNN_FC:     # the LM feeds bf16, the CNN's fc f32
            x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        xq = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-128, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        xq[:, 0] = -128                     # the saturating int8 minimum
        sx, sw = ops._scales(x, w, 8)
        calls = {
            "lut_matmul": (lambda: am.lut_matmul(xq, wq, lut),
                           lambda: ref.lut_matmul_ref(xq, wq, lut)),
            "lut_matmul_mag": (
                lambda: am.lut_matmul_mag(xq, wq, mags[""]),
                lambda: am.lut_matmul_mag_plain(xq, wq, mags[""])),
            "lut_matmul_mag[clean]": (
                lambda: am.lut_matmul_mag(xq, wq, mags["[clean]"]),
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
        for sfx, sub in subs.items():
            calls["nibble_lut_matmul" + sfx] = (
                lambda t=sub: am.nibble_lut_matmul(xq, wq, t),
                lambda t=sub: ref.nibble_matmul_ref(xq, wq, t))
            calls["nibble_lut_matmul_fused" + sfx] = (
                lambda t=sub: am.nibble_lut_matmul_fused(x, w, t, sx, sw),
                lambda t=sub: am.nibble_lut_matmul_fused_plain(x, w, t, sx,
                                                               sw))
        for name, (kern, plain) in calls.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            if not torch.equal(got, want):
                fail(f"{name} {shape}: kernel != plain version "
                     f"(max |diff| {err})")
            if name not in rows:
                continue            # log_our, appro42/4, clean: checked
            row = {"shape": shape, "max_abs_err": err}
            if shape != RAGGED:
                row["ms"] = _timed_ms(torch, kern, 10, flush)
                row["plain_ms"] = _timed_ms(torch, plain, 1, flush)
                row["bound_ms"], row["bound_by"] = _bound(
                    name, m, k, n, sms, clock_hz, x.element_size())
            rows[name].append(row)
        print(f"  {shape} ({x.dtype} fused operands): all kernels bitwise "
              f"equal to their plain versions (mitchell and log_our; "
              f"nibble for exact and appro42/4; the magnitude table "
              f"faulted and clean)", flush=True)
    check_cluster_edges(torch, lut, mags, flush)
    check_int_forms(torch, sms, clock_hz, lut, mags, rows, flush)
    print(f"  {'kernel':<22} {'M,K,N':>16} {'ms':>9} {'bound_ms':>9} "
          f"{'by':>10} {'share':>6} {'plain_ms':>9}")
    for name, rs in rows.items():
        for r in rs:
            if "ms" in r:
                print(f"  {name:<22} {str(r['shape']):>16} {r['ms']:9.4f} "
                      f"{r['bound_ms']:9.4f} {r['bound_by']:>10} "
                      f"{100 * r['bound_ms'] / r['ms']:5.1f}% "
                      f"{r['plain_ms']:9.3f}")
    return rows


def check_int_forms(torch, sms: int, clock_hz: float, lut, mags, rows,
                    flush):
    """The int forms on the split-K cluster kernel (INT_KERNELS) at the
    shapes the per-token and faulted lanes serve (SERVED_SHAPES), bitwise
    their plain versions (lut_matmul over the balanced tier's table, the
    magnitude form over its faulted and its clean table, mitchell_matmul
    as mitchell and log_our, nibble_lut_matmul over the exact family's
    and appro42/orplane/4's sub-tables), each timed and bounded
    (mitchell, the faulted table, the exact family's sub-tables), its
    row appended to `rows`; then at 2..8 bits on the ragged shape and
    INT_BITS_SHAPE, operands over the whole b-bit range (the saturating
    -2^(b-1) in the first row), for the exact family's and appro42's
    tables (the magnitude form faulted at a high rate and clean), and
    mitchell also on every int8 below 2^bits; the nibble form at the even
    widths on int8 operands over the whole int8 range (-128 in the first
    row; below 8 bits most magnitudes past qmax, saturated) for the exact
    family's and appro42's sub-tables (approximate columns in the low
    half-word), and on the b-bit range equal to lut_matmul over the same
    spec's full table; the launch plans of the served shapes printed."""
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.multipliers import MultiplierSpec
    from repro_torch.kernels import approx_matmul as am
    from repro_torch.kernels import mitchell_gemm as mg
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    subs = ops.nibble_table(MultiplierSpec("exact", 8, True), dev)
    subs4 = ops.nibble_table(MultiplierSpec("appro42", 8, True, "orplane",
                                            4), dev)
    plans = []
    for m, k, n in SERVED_SHAPES:
        g = torch.Generator(device=dev).manual_seed(m * 13 + k + n)
        xq, wq = _ints(torch, g, (m, k), 8, dev), _ints(torch, g, (k, n), 8,
                                                        dev)
        xq[:, 0] = -128
        calls = {
            "lut_matmul": (lambda: am.lut_matmul(xq, wq, lut),
                           lambda: ref.lut_matmul_ref(xq, wq, lut)),
            "lut_matmul_mag": (
                lambda: am.lut_matmul_mag(xq, wq, mags[""]),
                lambda: am.lut_matmul_mag_plain(xq, wq, mags[""])),
            "lut_matmul_mag[clean]": (
                lambda: am.lut_matmul_mag(xq, wq, mags["[clean]"]),
                lambda: ref.lut_matmul_ref(xq, wq, lut)),
            "mitchell_matmul": (
                lambda: mg.mitchell_matmul(xq, wq, compensated=False),
                lambda: ref.mitchell_matmul_ref(xq, wq, compensated=False)),
            "mitchell_matmul[log_our]": (
                lambda: mg.mitchell_matmul(xq, wq),
                lambda: ref.mitchell_matmul_ref(xq, wq)),
            "nibble_lut_matmul": (
                lambda: am.nibble_lut_matmul(xq, wq, subs),
                lambda: ref.nibble_matmul_ref(xq, wq, subs)),
            "nibble_lut_matmul[appro42/4]": (
                lambda: am.nibble_lut_matmul(xq, wq, subs4),
                lambda: ref.nibble_matmul_ref(xq, wq, subs4)),
        }
        for name, (kern, plain) in calls.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"{name} {(m, k, n)}: kernel != plain version "
                     f"({int((got != want).sum())} entries)")
            if name not in rows:
                continue
            bound, by = _bound(name, m, k, n, sms, clock_hz)
            rows[name].append({
                "shape": (m, k, n), "max_abs_err": 0.0,
                "ms": _timed_ms(torch, kern, 10, flush),
                "plain_ms": _timed_ms(torch, plain, 1, flush),
                "bound_ms": bound, "bound_by": by})
        lp = am.fused_plan(am.KERNELS["lut_matmul"], xq, wq, 8)
        mp = am.fused_plan(am.KERNELS["lut_matmul_mag"], xq, wq, 8)
        gp = am.fused_plan(mg.KERNELS["mitchell_matmul"], xq, wq, 8, 0)
        np_ = am.fused_plan(am.KERNELS["nibble_lut_matmul"], xq, wq, 8)
        plans.append(f"{(m, k, n)} lut {lp.rows}:{lp.tiles}x{lp.splits} "
                     f"mag {mp.rows}:{mp.tiles}x{mp.splits} log "
                     f"{gp.rows}:{gp.tiles}x{gp.splits} nibble "
                     f"{np_.rows}:{np_.tiles}x{np_.splits}")
    print(f"  int forms bitwise at the served shapes (M 1, 2, 8, 16, 20); "
          f"plans (rows:tiles x splits): {'; '.join(plans)}", flush=True)
    for shape in (RAGGED, INT_BITS_SHAPE):
        m, k, n = shape
        for bits in range(2, 9):
            g = torch.Generator(device=dev).manual_seed(bits * 31 + m)
            xq, wq = _ints(torch, g, (m, k), bits, dev), _ints(
                torch, g, (k, n), bits, dev)
            xq[0, :3] = -(1 << (bits - 1))
            for fam in ("exact", "appro42"):
                sb = MultiplierSpec(fam, bits, True)
                t = ops.lut_table(sb, dev)
                pairs = [("lut_matmul", am.lut_matmul(xq, wq, t, bits),
                          ref.lut_matmul_ref(xq, wq, t, bits))]
                for f in (FaultConfig(p_sa0=0.05, p_sa1=0.05, seed=bits),
                          None):
                    tab = ops.magnitude_lut(sb, f, dev)
                    kind = "clean" if f is None else "faulted"
                    pairs.append((f"lut_matmul_mag {kind}",
                                  am.lut_matmul_mag(xq, wq, tab, bits),
                                  am.lut_matmul_mag_plain(xq, wq, tab,
                                                          bits)))
                pairs.append(("lut_matmul_mag clean = lut_matmul",
                              pairs[-1][1], pairs[0][1]))
                for tag, got, want in pairs:
                    if not torch.equal(got, want):
                        fail(f"{tag} {fam} {bits}-bit {shape}: kernel != "
                             "plain version")
            for comp in (False, True):
                if not torch.equal(mg.mitchell_matmul(xq, wq, bits, comp),
                                   ref.mitchell_matmul_ref(xq, wq, bits,
                                                           comp)):
                    fail(f"mitchell_matmul (compensated {comp}) {bits}-bit "
                         f"{shape}: kernel != plain version")
            if bits < 8:
                # mitchell takes every int8; log_our's domain below 8
                # bits, |v| < 2^bits, and its first value past it refused
                lim = 1 << bits
                wide = torch.randint(-128, 128, (m, k), generator=g,
                                     device=dev, dtype=torch.int8)
                inside = wide.clamp(-lim + 1, lim - 1)
                torch.cuda.synchronize()
                for tag, xs, comp in (("mitchell, any int8", wide, False),
                                      ("log_our, |v| < 2^bits", inside,
                                       True)):
                    if not torch.equal(
                            mg.mitchell_matmul(xs, wq, bits, comp),
                            ref.mitchell_matmul_ref(xs, wq, bits, comp)):
                        fail(f"mitchell_matmul ({tag}) {bits}-bit {shape}: "
                             "kernel != plain version")
                past = inside.clone()
                past[0, 0] = -lim                  # int8 down to -128
                try:
                    mg.mitchell_matmul(past, wq, bits, True)
                except ValueError:
                    pass
                else:
                    fail(f"mitchell_matmul log_our {bits}-bit took an "
                         f"operand of {-lim}")
            if bits % 2:
                continue
            # the nibble form on every int8 (saturated at qmax), and on
            # the b-bit range equal to the full table's gather
            x8 = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                               dtype=torch.int8)
            w8 = torch.randint(-128, 128, (k, n), generator=g, device=dev,
                               dtype=torch.int8)
            x8[0, :3] = -128
            for fam, cols in (("exact", None), ("appro42", bits // 2)):
                sb = MultiplierSpec(fam, bits, True, "orplane", cols)
                t = ops.nibble_table(sb, dev)
                for tag, got, want in (
                        ("int8", am.nibble_lut_matmul(x8, w8, t, bits),
                         ref.nibble_matmul_ref(x8, w8, t, bits)),
                        ("= lut_matmul", am.nibble_lut_matmul(xq, wq, t,
                                                              bits),
                         am.lut_matmul(xq, wq, ops.lut_table(sb, dev),
                                       bits))):
                    if not torch.equal(got, want):
                        fail(f"nibble_lut_matmul ({tag}) {fam} {bits}-bit "
                             f"{shape}: kernel != plain version")
    print(f"  int forms bitwise at 2..8 bits on {RAGGED} and "
          f"{INT_BITS_SHAPE} (exact and appro42 tables, the magnitude table "
          f"faulted and clean, mitchell and log_our; mitchell on every int8, "
          f"log_our's |v| >= 2^bits refused; the nibble form at 2, 4, 6, 8 "
          f"bits on every int8, saturated, and = lut_matmul on the b-bit "
          f"range)", flush=True)


def _misaligned(torch, t):
    """A contiguous copy of `t` whose storage starts one element past a
    16-byte boundary (the cluster kernel loads such rows by elements)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_cluster_edges(torch, lut8, mags, flush):
    """The cluster kernel (csrc/cluster_gemm.cuh) at CLUSTER_EDGES, fused
    and partial (the raw int32 sum, also through the epilogue against the
    fused kernel) and int (int8 operands, -128 in the first column),
    bitwise against the plain versions, with the split each shape was
    given (the partials' plans at the shard shapes too): the LUT at 4
    and 8 bits, the magnitude form over the faulted table `mags[""]`, the
    log kernel (mitchell, log_our) at 8 (and 16, the template's side, on
    the first CLUSTER_WIDE_EDGES), the nibble forms (fused, partial and
    int, the int form on every int8, saturated) for the exact family at
    2, 4, 6 and 8 bits and appro42/4 (at the misaligned edge also on
    bf16 operands, 2 bytes off, and int8, 1 byte off); then what
    the LUT's table fill costs a call: lut_matmul_fused at K = 32 (one
    step) with the 8-bit table (128 KiB a block) against the 4-bit one
    (512 bytes), the same shapes and operands otherwise."""
    from repro_torch.core.multipliers import MultiplierSpec
    from repro_torch.kernels import approx_matmul as am
    from repro_torch.kernels import mitchell_gemm as mg
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    lut4 = ops.lut_table(MultiplierSpec("appro42", 4, True, "orplane"), dev)

    nibs = [(f"nibble{b}", b, ops.nibble_table(
        MultiplierSpec("exact", b, True), dev)) for b in (2, 4, 6, 8)]
    nibs.append(("nibble8[appro42/4]", 8, ops.nibble_table(
        MultiplierSpec("appro42", 8, True, "orplane", 4), dev)))

    def int_calls(xq, wq, wide):
        # the int forms: (tag, kernel, plain version, None, None); the
        # nibble form on every int8 at each width (saturated at qmax)
        x4, w4 = xq // 16, wq // 16               # [-8, 8): 4-bit operands
        out = [("lut8 int", lambda: am.lut_matmul(xq, wq, lut8),
                lambda: ref.lut_matmul_ref(xq, wq, lut8), None, None),
               ("lut4 int", lambda: am.lut_matmul(x4, w4, lut4, 4),
                lambda: ref.lut_matmul_ref(x4, w4, lut4, 4), None, None),
               ("mag8 int", lambda: am.lut_matmul_mag(xq, wq, mags[""]),
                lambda: am.lut_matmul_mag_plain(xq, wq, mags[""]), None,
                None)]
        for bits in (8, 16) if wide else (8,):
            for comp in (False, True):
                out.append((
                    f"{'log_our' if comp else 'mitchell'}{bits} int",
                    lambda b=bits, c=comp: mg.mitchell_matmul(xq, wq, b, c),
                    lambda b=bits, c=comp: ref.mitchell_matmul_ref(xq, wq,
                                                                   b, c),
                    None, None))
        for tag, bits, subs in nibs:
            out.append((
                f"{tag} int",
                lambda t=subs, b=bits: am.nibble_lut_matmul(xq, wq, t, b),
                lambda t=subs, b=bits: ref.nibble_matmul_ref(xq, wq, t, b),
                None, None))
        return out

    def nibble_calls(x, w, sfx=""):
        # the plain partial once a width: the plain fused form is its
        # epilogue (nibble_lut_matmul_fused_plain)
        out = []
        for tag, bits, subs in nibs:
            sx, sw = ops._scales(x, w, bits)
            memo = {}

            def part_plain(t=subs, b=bits, a=sx, c=sw, memo=memo):
                if "v" not in memo:
                    memo["v"] = am.nibble_lut_matmul_partial_plain(
                        x, w, t, a, c, b)
                return memo["v"]

            fused = (lambda t=subs, b=bits, a=sx, c=sw:
                     am.nibble_lut_matmul_fused(x, w, t, a, c, b))
            out.append((tag + sfx, fused,
                        lambda p=part_plain, a=sx, c=sw:
                        am.epilogue(p(), a, c), None, None))
            out.append((f"{tag}{sfx} partial",
                        lambda t=subs, b=bits, a=sx, c=sw:
                        am.nibble_lut_matmul_partial(x, w, t, a, c, b),
                        part_plain, (sx, sw), fused))
        return out

    for i, (m, k, n) in enumerate(CLUSTER_EDGES):
        g = torch.Generator(device=dev).manual_seed(1000 + i)
        dt = torch.bfloat16 if i % 2 == 0 else torch.float32
        x = torch.randn(m, k, generator=g, device=dev).to(dt)
        w = (torch.randn(k, n, generator=g, device=dev) * 0.02).to(dt)
        xq = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-128, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        xq[:, :1] = -128
        calls = []      # (tag, kernel, plain version, scales, fused)
        if (m, k, n) == (1, 2048, 2048):
            x, w = _misaligned(torch, x), _misaligned(torch, w)
            xq, wq = _misaligned(torch, xq), _misaligned(torch, wq)
            calls += nibble_calls(_misaligned(torch, x.to(torch.bfloat16)),
                                  _misaligned(torch, w.to(torch.bfloat16)),
                                  " bf16")
        calls += int_calls(xq, wq, i < CLUSTER_WIDE_EDGES)
        for bits, table in ((8, lut8), (4, lut4)):
            sx, sw = ops._scales(x, w, bits)
            fused = (lambda t=table, b=bits, a=sx, c=sw:
                     am.lut_matmul_fused(x, w, t, a, c, b))
            calls.append((f"lut{bits}", fused,
                          lambda t=table, b=bits, a=sx, c=sw:
                          am.lut_matmul_fused_plain(x, w, t, a, c, b),
                          None, None))
            calls.append((f"lut{bits} partial",
                          lambda t=table, b=bits, a=sx, c=sw:
                          am.lut_matmul_partial(x, w, t, a, c, b),
                          lambda t=table, b=bits, a=sx, c=sw:
                          am.lut_matmul_partial_plain(x, w, t, a, c, b),
                          (sx, sw), fused))
        for bits in (8, 16) if i < CLUSTER_WIDE_EDGES else (8,):
            sx, sw = ops._scales(x, w, bits)
            for comp in (False, True):
                tag = f"{'log_our' if comp else 'mitchell'}{bits}"
                fused = (lambda b=bits, c=comp, a=sx, s=sw:
                         mg.mitchell_matmul_fused(x, w, a, s, b, c))
                calls.append((
                    tag, fused,
                    lambda b=bits, c=comp, a=sx, s=sw:
                    mg.mitchell_matmul_fused_plain(x, w, a, s, b, c),
                    None, None))
                calls.append((
                    tag + " partial",
                    lambda b=bits, c=comp, a=sx, s=sw:
                    mg.mitchell_matmul_partial(x, w, a, s, b, c),
                    lambda b=bits, c=comp, a=sx, s=sw:
                    mg.mitchell_matmul_partial_plain(x, w, a, s, b, c),
                    (sx, sw), fused))
        calls += nibble_calls(x, w)
        for tag, kern, plain, scales, fused in calls:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if got.dtype != want.dtype or not torch.equal(got, want):
                err = float((got.double() - want.double()).abs().max())
                fail(f"cluster edge {(m, k, n)} {dt} {tag}: kernel != plain "
                     f"version ({got.dtype}, max |diff| {err})")
            if scales is not None and not torch.equal(
                    am.epilogue(got, *scales), fused()):
                fail(f"cluster edge {(m, k, n)} {dt} {tag}: the epilogue of "
                     "the partial sum != the fused kernel")
        lp = am.fused_plan(am.KERNELS["lut_matmul_fused"], x, w, 8)
        gp = am.fused_plan(mg.KERNELS["mitchell_matmul_fused"], x, w, 8, 0)
        lpp = am.fused_plan(am.KERNELS["lut_matmul_partial"], x, w, 8)
        gpp = am.fused_plan(mg.KERNELS["mitchell_matmul_partial"], x, w, 8, 0)
        np_ = am.fused_plan(am.KERNELS["nibble_lut_matmul_fused"], x, w, 8)
        npp = am.fused_plan(am.KERNELS["nibble_lut_matmul_partial"], x, w, 8)
        li = am.fused_plan(am.KERNELS["lut_matmul"], xq, wq, 8)
        mi = am.fused_plan(am.KERNELS["lut_matmul_mag"], xq, wq, 8)
        gi = am.fused_plan(mg.KERNELS["mitchell_matmul"], xq, wq, 8, 0)
        ni = am.fused_plan(am.KERNELS["nibble_lut_matmul"], xq, wq, 8)
        print(f"  cluster edge {(m, k, n)} {dt}: bitwise ({len(calls)} "
              f"calls); plan rows {lp.rows}, splits lut {lp.splits} / log "
              f"{gp.splits} / nibble {np_.splits}, partial lut "
              f"{lpp.splits} / log {gpp.splits} / nibble {npp.splits}, int "
              f"lut {li.splits} / mag {mi.rows}:{mi.splits} / log "
              f"{gi.splits} / nibble {ni.rows}:{ni.splits}", flush=True)
    plans = []
    for m, k, n in MAIN_SHAPES + [CNN_FC]:
        dt = torch.float32 if (m, k, n) == CNN_FC else torch.bfloat16
        x = torch.empty(m, k, device=dev, dtype=dt)
        w = torch.empty(k, n, device=dev, dtype=dt)
        lp = am.fused_plan(am.KERNELS["lut_matmul_fused"], x, w, 8)
        gp = am.fused_plan(mg.KERNELS["mitchell_matmul_fused"], x, w, 8, 0)
        np_ = am.fused_plan(am.KERNELS["nibble_lut_matmul_fused"], x, w, 8)
        plans.append(f"{(m, k, n)} lut {lp.tiles}x{lp.splits} log "
                     f"{gp.tiles}x{gp.splits} nibble "
                     f"{np_.tiles}x{np_.splits}")
    print(f"  cluster plans (tiles x splits): {'; '.join(plans)}",
          flush=True)
    plans = []
    for m, k, n in PARTIAL_SHAPES:
        x = torch.empty(m, k, device=dev, dtype=torch.bfloat16)
        w = torch.empty(k, n, device=dev, dtype=torch.bfloat16)
        lp = am.fused_plan(am.KERNELS["lut_matmul_partial"], x, w, 8)
        gp = am.fused_plan(mg.KERNELS["mitchell_matmul_partial"], x, w, 8, 0)
        np_ = am.fused_plan(am.KERNELS["nibble_lut_matmul_partial"], x, w, 8)
        plans.append(f"{(m, k, n)} lut {lp.tiles}x{lp.splits} log "
                     f"{gp.tiles}x{gp.splits} nibble "
                     f"{np_.tiles}x{np_.splits}")
    print(f"  partial plans at the shard shapes (tiles x splits): "
          f"{'; '.join(plans)}", flush=True)
    for n in (2048, 6144):
        g = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn(4, 32, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(32, n, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        times = {}
        for bits, table in ((8, lut8), (4, lut4)):
            sx, sw = ops._scales(x, w, bits)
            times[bits] = _timed_ms(
                torch, lambda t=table, b=bits, a=sx, c=sw:
                am.lut_matmul_fused(x, w, t, a, c, b), 20, flush)
        plan = am.fused_plan(am.KERNELS["lut_matmul_fused"], x, w, 8)
        print(f"  LUT table fill, lut_matmul_fused (4, 32, {n}), "
              f"{plan.tiles * plan.splits} blocks: 8-bit table "
              f"{times[8]:.4f} ms, 4-bit {times[4]:.4f} ms, fill "
              f"{times[8] - times[4]:.4f} ms a call", flush=True)


# ---------------------------------------------------------------------------
# phase 3, surrogate: the fused surrogate GEMMs against their plain versions
# ---------------------------------------------------------------------------


def _surrogate_bound(name, m, k, n, esize, noisy, need_sq):
    """(bound_ms, bound_by): the bytes each input read once and each
    output written once at 3.35 TB/s (the core: int8 operands, D and SQ
    written; the fused form: `esize`-byte operands, the scales, eps when
    noisy, the f32 output), against the int8 tensor-core operations at
    1,979 TOP/s, the least expensive form of the work on the card: D's
    2 M K N and, with SQ, SQ_INT8_PRODUCTS x 2 M K N more (the squares'
    s8 halves, HH, HL, LH, LL)."""
    if name == "cim_gemm_core":
        nbytes = m * k + k * n + 8 * m * n
    else:
        nbytes = ((m * k + k * n) * esize + 4 + 4 * n + 4 * m * n
                  + (4 * m * n if noisy else 0))
    ops_s = ((1 + (SQ_INT8_PRODUCTS if need_sq else 0)) * 2 * m * k * n
             / INT8_TC_OPS_PER_S)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(bytes_s, ops_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def _surrogate_coeffs():
    """SURR_COEFFS filled: the balanced (appro42/orplane/10) and log_our
    surrogates' (mu, c0, c1)."""
    from repro_torch.core.compiler import CiMConfig, compile_macro

    for fam, kw in (("appro42", dict(compressor="orplane", n_approx_cols=10)),
                    ("log_our", {})):
        sur = compile_macro(CiMConfig(family=fam, bits=8, mode="surrogate",
                                      **kw)).surrogate
        SURR_COEFFS[fam] = (sur.mu_rel, sur.c0_abs, sur.c1_rel)
    return SURR_COEFFS


def check_surrogate(torch, sms: int, clock_hz: float):
    """The surrogate GEMMs at the LM shapes, the CNN's fc and the ragged
    shape, then their edges.  (`sms` and `clock_hz` go unused: the
    surrogate's bounds are the bytes and the int8 tensor cores' rate;
    every phase-3 check takes them, as launch/kernel_ab.py calls it.)"""
    from repro_torch.kernels import cim_gemm as cg
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    _surrogate_coeffs()
    print(f"  surrogate coefficients (mu, c0, c1): {SURR_COEFFS}", flush=True)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    rows = {"cim_gemm_core": [], "cim_gemm_fused": []}
    print(f"  {'kernel':<15} {'variant':<22} {'M,K,N':>16} {'ms':>9} "
          f"{'bound_ms':>9} {'by':>10} {'share':>6} {'plain_ms':>9} "
          f"{'library_ms':>10}", flush=True)
    for shape in MAIN_SHAPES + [CNN_FC, RAGGED]:
        m, k, n = shape
        timed = shape != RAGGED
        g = torch.Generator(device=dev).manual_seed(m * 5 + k + 3 * n)
        x = torch.randn(m, k, generator=g, device=dev)
        w = torch.randn(k, n, generator=g, device=dev) * 0.02
        eps = torch.randn(m, n, generator=g, device=dev)
        xq = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-128, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        xq[:, 0] = -128
        # the core: D bitwise, SQ within the f32 sum's bound
        pd, psq = cg.cim_gemm_core_plain(xq, wq)
        sq_rel = 0.0
        for need_sq in (True, False):
            d, sq = cg.cim_gemm_core(xq, wq, need_sq=need_sq)
            torch.cuda.synchronize()
            if not torch.equal(d, pd):
                fail(f"cim_gemm_core {shape}: D != plain version (max |d| "
                     f"{float((d - pd).abs().max())})")
            want_sq = psq if need_sq else torch.zeros_like(psq)
            sq_err = float((sq - want_sq).abs().max())
            if need_sq:
                sq_rel = float(((sq - psq).abs() / psq.clamp_min(1)).max())
            if bool(((sq - want_sq).abs()
                     > k * 2.0 ** -24 * want_sq.abs()).any()):
                fail(f"cim_gemm_core {shape} need_sq={need_sq}: SQ beyond "
                     f"(K-1) 2^-24 of the exact value (max |d| {sq_err})")
            if not timed:
                continue
            row = {"shape": shape, "variant": f"need_sq={need_sq}",
                   "max_abs_err": sq_err,
                   "main": not need_sq and shape in MAIN_SHAPES}
            row["ms"] = _timed_ms(
                torch, lambda s_=need_sq: cg.cim_gemm_core(xq, wq, s_), 10,
                flush)
            if not need_sq:     # the tensor-core route with the L2 warm
                row["warm_ms"] = _timed_ms(
                    torch, lambda: cg.cim_gemm_core(xq, wq, False), 10, None)
            row["plain_ms"] = _timed_ms(
                torch, lambda s_=need_sq: cg.cim_gemm_core_plain(xq, wq, s_),
                1, flush)
            row["bound_ms"], row["bound_by"] = _surrogate_bound(
                "cim_gemm_core", m, k, n, 1, False, need_sq)
            if not need_sq and m > 16 and k % 8 == 0 and n % 8 == 0:
                lib = torch._int_mm(xq, wq)     # the yardstick: D only
                torch.cuda.synchronize()
                if not torch.equal(lib, pd):
                    fail(f"torch._int_mm {shape} != D")
                row["library_ms"] = _timed_ms(
                    torch, lambda: torch._int_mm(xq, wq), 10, flush)
            rows["cim_gemm_core"].append(row)
        # the fused form: bitwise with and without noise
        dtypes = ((torch.float32,) if shape == CNN_FC
                  else (torch.bfloat16, torch.float32))
        plans = []
        for dt in dtypes:
            xs, ws = x.to(dt), w.to(dt)
            sx, sw = ops._scales(xs, ws, 8)
            for fam, (mu, c0, c1) in SURR_COEFFS.items():
                det = cg.cim_gemm_fused(xs, ws, sx, sw, None, mu, c0, c1)
                pdet = cg.cim_gemm_fused_plain(xs, ws, sx, sw, None, mu, c0,
                                               c1)
                got = cg.cim_gemm_fused(xs, ws, sx, sw, eps, mu, c0, c1)
                want = cg.cim_gemm_fused_plain(xs, ws, sx, sw, eps, mu, c0,
                                               c1)
                torch.cuda.synchronize()
                for tag, a_, b_ in (("without", det, pdet),
                                    ("with", got, want)):
                    if not torch.equal(a_, b_) or not torch.isfinite(a_).all():
                        fail(f"cim_gemm_fused {shape} {dt} {fam} {tag} "
                             f"noise: kernel != plain version (max |d| "
                             f"{float((a_ - b_).abs().max())})")
                # timed: the serving path (bf16, no noise, the balanced
                # tier's coefficients) and the macro path (f32, log_our's
                # noise with its SQ)
                for noisy in (False, True):
                    serving = dt == torch.bfloat16 and fam == "appro42"
                    macro = dt == torch.float32 and fam == "log_our"
                    if not timed or not (serving and not noisy
                                         or macro and noisy):
                        continue
                    e = eps if noisy else None
                    row = {"shape": shape,
                           "variant": f"{str(dt)[6:]} {fam}"
                                      f"{' noise' if noisy else ''}",
                           "max_abs_err": 0.0,
                           "main": shape in MAIN_SHAPES}
                    row["ms"] = _timed_ms(
                        torch, lambda e_=e: cg.cim_gemm_fused(
                            xs, ws, sx, sw, e_, mu, c0, c1), 10, flush)
                    row["plain_ms"] = _timed_ms(
                        torch, lambda e_=e: cg.cim_gemm_fused_plain(
                            xs, ws, sx, sw, e_, mu, c0, c1), 1, flush)
                    row["bound_ms"], row["bound_by"] = _surrogate_bound(
                        "cim_gemm_fused", m, k, n, xs.element_size(), noisy,
                        noisy and c1 > 0)
                    rows["cim_gemm_fused"].append(row)
                    plan = cg.fused_launch_plan(xs, ws, cg.variant(
                        e, c0, c1))
                    plans.append(f"{row['variant']}: rows {plan.rows}, "
                                 f"tiles {plan.tiles}, splits {plan.splits}")
        for name, rs in rows.items():
            for r in rs:
                if r["shape"] == shape:
                    lib = r.get("library_ms")
                    warm = r.get("warm_ms")
                    print(f"  {name:<15} {r['variant']:<22} {str(shape):>16} "
                          f"{r['ms']:9.4f} {r['bound_ms']:9.4f} "
                          f"{r['bound_by']:>10} "
                          f"{r['bound_ms'] / r['ms']:6.1%} "
                          f"{r['plain_ms']:9.3f} "
                          f"{'-' if lib is None else f'{lib:10.4f}':>10}"
                          f"{'' if warm is None else f'  warm {warm:.4f}'}",
                          flush=True)
        if plans:
            print(f"  cim_gemm_fused {shape} plan: {'; '.join(plans)}",
                  flush=True)
        print(f"  {shape}: D bitwise, SQ within (K-1) 2^-24 = "
              f"{(k - 1) * 2.0 ** -24:.2e} (max relative error {sq_rel:.2e}), "
              f"the fused kernel bitwise with and without noise "
              f"({', '.join(str(d)[6:] for d in dtypes)} operands; appro42 "
              f"and log_our)", flush=True)
    # the tensor-core route's edges: D bitwise, SQ zeros
    for i, (m, k, n) in enumerate(CORE_EDGES):
        g = torch.Generator(device=dev).manual_seed(300 + i)
        xq = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-128, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        for v in (None, -128, 127):
            a, b = ((xq, wq) if v is None
                    else (torch.full_like(xq, v), torch.full_like(wq, v)))
            d, sq = cg.cim_gemm_core(a, b, need_sq=False)
            want, _ = cg.cim_gemm_core_plain(a, b, need_sq=False)
            torch.cuda.synchronize()
            if not torch.equal(d, want) or sq.any():
                fail(f"cim_gemm_core {(m, k, n)} operands "
                     f"{'random' if v is None else v} need_sq=False: D != "
                     f"plain version or SQ not zero")
            if (m > 16 and k % 8 == 0 and n % 8 == 0
                    and not torch.equal(torch._int_mm(a, b), d)):
                fail(f"torch._int_mm {(m, k, n)} != D")
    print(f"  cim_gemm_core need_sq=False at {CORE_EDGES}: D bitwise for "
          f"random operands, all -128 and all 127, SQ zeros", flush=True)
    check_surrogate_edges(torch)
    return rows


def check_surrogate_edges(torch):
    """cim_gemm_fused (csrc/surrogate_cluster.cuh) at SURROGATE_EDGES,
    bitwise against the plain version: bf16, f32 and mixed operands by
    turns, bits 8, 4 and 2, each variant (no noise; noise with c1 = 0;
    noise with SQ), operands random and at +-max (every code +-qmax:
    SQ's largest sums), with the plan each shape was given."""
    from repro_torch.kernels import cim_gemm as cg
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    mu, c0, c1 = SURR_COEFFS["log_our"]
    variants = (("served", False, c1), ("noise c1=0", True, 0.0),
                ("noise", True, c1))
    pairs = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
             (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16))
    for i, (m, k, n) in enumerate(SURROGATE_EDGES):
        g = torch.Generator(device=dev).manual_seed(500 + i)
        xt, wt = pairs[i % len(pairs)]
        x = torch.randn(m, k, generator=g, device=dev).to(xt)
        w = (torch.randn(k, n, generator=g, device=dev) * 0.02).to(wt)
        eps = torch.randn(m, n, generator=g, device=dev)
        sign = torch.where(torch.rand(k, n, generator=g, device=dev) < 0.5,
                           -1.0, 1.0)
        at_max = (torch.full_like(x, -3.0), (sign * 0.5).to(wt))
        calls = 0
        for a, b in ((x, w), at_max):
            for bits in (8, 4, 2):
                sx, sw = ops._scales(a, b, bits)
                for tag, noisy, c1_ in variants:
                    e = eps if noisy else None
                    got = cg.cim_gemm_fused(a, b, sx, sw, e, mu, c0, c1_,
                                            bits)
                    want = cg.cim_gemm_fused_plain(a, b, sx, sw, e, mu, c0,
                                                   c1_, bits)
                    torch.cuda.synchronize()
                    calls += 1
                    if not torch.equal(got, want):
                        err = float((got.double() - want.double()).abs()
                                    .max())
                        fail(f"surrogate edge {(m, k, n)} {xt} x {wt} "
                             f"{bits} bits {tag}: kernel != plain version "
                             f"(max |diff| {err})")
        plan = cg.fused_launch_plan(x, w, cg.NOISE_SQ)
        print(f"  surrogate edge {(m, k, n)} {str(xt)[6:]} x {str(wt)[6:]}: "
              f"bitwise ({calls} calls); plan rows {plan.rows}, tiles "
              f"{plan.tiles}, splits {plan.splits}", flush=True)


# ---------------------------------------------------------------------------
# phase 3, conv: the implicit-GEMM conv kernels against their plain versions
# ---------------------------------------------------------------------------


def _conv_bound(core, comp, b, h, w, c, n, oh, ow, sms, clock_hz):
    """(bound_ms, bound_by): the image, the weights and the scales read
    once and the output written once at 3.35 TB/s, against the M*K*N
    products of the implicit GEMM as gathers (lut; nibble NIBBLE_GATHERS
    a product) at the SMs' peak rate, for log at LOG_CLOCKS a product, or
    for the exact core as 2 M K N int8 tensor-core operations."""
    m, k = b * oh * ow, 9 * c
    nbytes = 4 * (b * h * w * c + k * n + 1 + n + m * n)
    nbytes += {"lut": LUT_BYTES, "nibble": NIBBLE_BYTES, "log": 0,
               "mxu": 0}[core]
    products = m * k * n
    if core == "log":
        ops_s = products * LOG_CLOCKS[comp] / (sms * clock_hz)
    elif core == "mxu":
        ops_s = 2 * products / INT8_TC_OPS_PER_S
    else:
        ops_s = (products * (NIBBLE_GATHERS if core == "nibble" else 1)
                 / (sms * GATHERS_PER_SM_CLOCK * clock_hz))
    bytes_s = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(bytes_s, ops_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def _float_conv_of_dequantized(x, w3, sx, sw, geo):
    """The yardstick of the exact-mode conv: the float conv (one
    F.conv2d call on views of its operands) of the dequantized operands,
    prepared once, outside the timing; run it under `_full_f32_convs`."""
    from repro_torch.core.approx_gemm import ConvParams, _float_conv
    from repro_torch.kernels.ref import quantize_tile

    conv = ConvParams(geo["kh"], geo["kw"], geo["stride"])
    xdq = quantize_tile(x, sx.reshape(()), 127).float() * sx
    wdq = (quantize_tile(w3, sw.reshape(1, -1), 127).float() * sw).reshape(
        -1, w3.shape[2])
    return lambda: _float_conv(xdq, wdq, conv)


def check_conv(torch, sms: int, clock_hz: float):
    from repro_torch.core.approx_gemm import (ConvParams, _full_f32_convs,
                                              plan_conv)
    from repro_torch.core.multipliers import MultiplierSpec
    from repro_torch.kernels import conv_gemm as cg
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    # (label, kernel, core, spec, compensated, on the CNN's path): the
    # appro42 family's full table, the exact family's nibble sub-tables,
    # appro42 with 4 approximate columns (nibble), mitchell and log_our
    a8 = MultiplierSpec("appro42", 8, True)
    ex = MultiplierSpec("exact", 8, True)
    a4 = MultiplierSpec("appro42", 8, True, n_approx_cols=4)
    variants = [("lut appro42", "conv_lut_fused", "lut", a8, False, True),
                ("nibble exact", "conv_lut_fused", "nibble", ex, False, True),
                ("nibble appro42/4", "conv_lut_fused", "nibble", a4, False,
                 False),
                ("mitchell", "conv_log_fused", "log", None, False, True),
                ("log_our", "conv_log_fused", "log", None, True, True),
                ("mxu exact", "conv_mxu_fused", "mxu", None, False, True)]
    geoms = ([(CNN_BATCH, h, w, c, n, 3, 3, 1) for h, w, c, n in CNN_CONVS]
             + CONV_RAGGED + [RESNET + (3, 3, 1)])
    rows = {"conv_lut_fused": [], "conv_log_fused": [], "conv_mxu_fused": []}
    print(f"  {'variant':<17} {'B,H,W,C->N':<24} {'ms':>9} {'bound_ms':>9} "
          f"{'by':>10} {'share':>6} {'plain_ms':>9} {'library_ms':>10}",
          flush=True)
    for gi, geom in enumerate(geoms):
        b, h, w, c, n, kh, kw, s = geom
        g = torch.Generator(device=dev).manual_seed(31 * gi + 7)
        x = torch.randn(b, h, w, c, generator=g, device=dev)
        w3 = torch.randn(kh * kw, c, n, generator=g, device=dev) * 0.1
        sx, sw = ops._scales(x, w3.reshape(-1, n), 8)
        geo = dict(kh=kh, kw=kw, stride=s)
        timed = geom not in CONV_RAGGED
        for label, name, core, spec, comp, main in variants:
            lib = None
            if core == "mxu":
                def kern():
                    return cg.conv_mxu_fused(x, w3, sx, sw, **geo)

                def plain():
                    return cg.conv_mxu_fused_plain(x, w3, sx, sw, **geo)

                lib = _float_conv_of_dequantized(x, w3, sx, sw, geo)
            elif core == "log":
                def kern(c_=comp):
                    return cg.conv_log_fused(x, w3, sx, sw, compensated=c_,
                                             **geo)

                def plain(c_=comp):
                    return cg.conv_log_fused_plain(x, w3, sx, sw,
                                                   compensated=c_, **geo)
            else:
                tab = (ops.nibble_table(spec, dev) if core == "nibble"
                       else ops.lut_table(spec, dev))
                nib = core == "nibble"

                def kern(t=tab, nb=nib):
                    return cg.conv_lut_fused(x, w3, t, sx, sw, nibble=nb,
                                             **geo)

                def plain(t=tab, nb=nib):
                    return cg.conv_lut_fused_plain(x, w3, t, sx, sw,
                                                   nibble=nb, **geo)
            wide = cg.KERNELS["conv_log_fused_wide"].launches
            n_before = cg.KERNELS[name].launches
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if (cg.KERNELS[name].launches != n_before + 1
                    or cg.KERNELS["conv_log_fused_wide"].launches != wide):
                fail(f"{name} ({label}) {geom}: not one launch of its entry")
            err = float((got.double() - want.double()).abs().max())
            if not torch.equal(got, want):
                fail(f"{name} ({label}) {geom}: kernel != plain version "
                     f"(max |diff| {err})")
            if lib is not None:
                with _full_f32_convs():
                    ref_out = lib()
                torch.cuda.synchronize()
                if not torch.allclose(got, ref_out, rtol=1e-5, atol=1e-5):
                    fail(f"{name} {geom}: beyond 1e-5 of F.conv2d on the "
                         f"dequantized operands (max |d| "
                         f"{float((got - ref_out).abs().max())})")
            row = {"variant": label, "geometry": geom, "max_abs_err": err,
                   "main": main and timed and geom[:5] != RESNET}
            if timed:
                oh, ow = got.shape[1], got.shape[2]
                row["ms"] = _timed_ms(torch, kern, 10, flush)
                if core == "mxu":   # the tensor-core kernel, L2 warm
                    row["warm_ms"] = _timed_ms(torch, kern, 10, None)
                row["plain_ms"] = _timed_ms(torch, plain, 1, flush)
                row["bound_ms"], row["bound_by"] = _conv_bound(
                    core, comp, b, h, w, c, n, oh, ow, sms, clock_hz)
                if lib is not None:
                    with _full_f32_convs():
                        row["library_ms"] = _timed_ms(torch, lib, 10, flush)
                warm = row.get("warm_ms")
                print(f"  {label:<17} {str(geom[:5]):<24} {row['ms']:9.4f} "
                      f"{row['bound_ms']:9.4f} {row['bound_by']:>10} "
                      f"{row['bound_ms'] / row['ms']:6.1%} "
                      f"{row['plain_ms']:9.3f} "
                      f"{row.get('library_ms', float('nan')):10.4f}"
                      f"{'' if warm is None else f'  warm {warm:.4f}'}",
                      flush=True)
            rows[name].append(row)
        if not timed:
            print(f"  {str(geom):<42} every variant bitwise equal to its "
                  f"plain version", flush=True)
    sums = {}
    for name, rs in rows.items():
        for r in rs:
            if "ms" in r and r["geometry"][:5] != RESNET:
                sums.setdefault(r["variant"], [0.0, 0.0])
                sums[r["variant"]][0] += r["ms"]
                sums[r["variant"]][1] += r["bound_ms"]
    print("  the CNN's five convs summed by variant (ms, bound ms): "
          + "; ".join(f"{v} {t:.4f}, {bd:.4f}" for v, (t, bd) in
                      sums.items()), flush=True)
    check_conv_tile(torch, dev)
    for gi, geom in enumerate(MXU_EDGES):
        b, h, w, c, n, kh, kw, s = geom
        g = torch.Generator(device=dev).manual_seed(400 + gi)
        x = torch.randn(b, h, w, c, generator=g, device=dev)
        w3 = torch.randn(kh * kw, c, n, generator=g, device=dev) * 0.1
        sx, sw = ops._scales(x, w3.reshape(-1, n), 8)
        geo = dict(kh=kh, kw=kw, stride=s)
        got = cg.conv_mxu_fused(x, w3, sx, sw, **geo)
        want = cg.conv_mxu_fused_plain(x, w3, sx, sw, **geo)
        lib = _float_conv_of_dequantized(x, w3, sx, sw, geo)
        with _full_f32_convs():
            ref_out = lib()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"conv_mxu_fused {geom}: kernel != plain version (max "
                 f"|diff| {float((got - want).abs().max())})")
        if not torch.allclose(got, ref_out, rtol=1e-5, atol=1e-5):
            fail(f"conv_mxu_fused {geom}: beyond 1e-5 of F.conv2d on the "
                 f"dequantized operands")
    print(f"  conv_mxu_fused at {MXU_EDGES}: bitwise equal to its plain "
          f"version and within 1e-5 of F.conv2d", flush=True)
    routes = {fam: plan_conv(fam, "hardware", 8, *RESNET, ConvParams(),
                             "cuda", spec=MultiplierSpec(fam, 8, True))
              .entry.name for fam in FAMS}
    routes["exact mode"] = plan_conv("exact", "exact", 8, *RESNET,
                                     ConvParams(), "cuda").entry.name
    print(f"  ResNet-18 conv2_x {RESNET} 3x3 routes on the card: {routes} "
          f"(the reference's 8 MiB VMEM model sends this plane to "
          f"conv_im2col)", flush=True)
    return rows


def check_conv_tile(torch, dev):
    """The convs' tile kernel (csrc/conv_tile.cuh): its launch plans at
    the CNN's convs printed, then every variant bitwise equal to its
    plain version at CONV_TILE_EDGES (the LUT also at 4 bits, the nibble
    sub-tables of both specs, log at 16 bits on the template's entry),
    and its partial form's int32 sum bitwise its plain version and,
    through the epilogue, the fused kernel's output, each launch counted
    on the route its bits take: up to 8 bits conv_lut_fused /
    conv_log_fused and conv_lut_partial / conv_log_partial (the tile
    kernel), above them conv_log_fused_wide and conv_log_partial_wide
    (the template)."""
    from repro_torch.core.multipliers import MultiplierSpec
    from repro_torch.kernels import conv_gemm as cg
    from repro_torch.kernels import ops

    for form in ("lut", "nibble", "mitchell", "log_our"):
        for h, w, c, n in CNN_CONVS:
            x = torch.empty(CNN_BATCH, h, w, c, device=dev)
            w3 = torch.empty(9, c, n, device=dev)
            p = cg.device_plan(form, 8, x, w3, 3, 3, 1)
            print(f"  tile plan {form:<8} {str((CNN_BATCH, h, w, c, n)):<24} "
                  f"rp {p.rp} rn {p.rn}, tile {p.ib}x{p.tr}x{p.tc}, chunk "
                  f"{p.cc} x {p.chunks}, taps {p.tg} x {p.groups}, tiles "
                  f"{p.tiles} on {p.grid} blocks, whole stack {p.whole}",
                  flush=True)
    a8, a4 = MultiplierSpec("appro42", 8, True), MultiplierSpec("appro42",
                                                                4, True)
    variants = [("lut appro42", "lut", 8, ops.lut_table(a8, dev)),
                ("lut appro42 4-bit", "lut", 4, ops.lut_table(a4, dev)),
                ("nibble exact", "nibble", 8,
                 ops.nibble_table(MultiplierSpec("exact", 8, True), dev)),
                ("nibble appro42/4", "nibble", 8, ops.nibble_table(
                    MultiplierSpec("appro42", 8, True, n_approx_cols=4),
                    dev)),
                ("mitchell", "mitchell", 8, None),
                ("log_our", "log_our", 8, None),
                ("mitchell 16-bit", "mitchell", 16, None),
                ("log_our 16-bit", "log_our", 16, None)]
    counted = ("conv_lut_fused", "conv_log_fused", "conv_log_fused_wide",
               "conv_lut_partial", "conv_log_partial",
               "conv_log_partial_wide")
    for gi, geom in enumerate(CONV_TILE_EDGES):
        b, h, w, c, n, kh, kw, s = geom
        g = torch.Generator(device=dev).manual_seed(500 + gi)
        x = torch.randn(b, h, w, c, generator=g, device=dev)
        w3 = torch.randn(kh * kw, c, n, generator=g, device=dev) * 0.1
        geo = dict(kh=kh, kw=kw, stride=s)
        for label, form, bits, tab in variants:
            sx, sw = ops._scales(x, w3.reshape(-1, n), bits)
            before = {k: cg.KERNELS[k].launches for k in counted}
            if tab is not None:
                nib = form == "nibble"
                got = cg.conv_lut_fused(x, w3, tab, sx, sw, bits,
                                        nibble=nib, **geo)
                want = cg.conv_lut_fused_plain(x, w3, tab, sx, sw, bits,
                                               nibble=nib, **geo)
                part = cg.conv_lut_partial(x, w3, tab, sx, sw, bits,
                                           nibble=nib, **geo)
                part_want = cg.conv_lut_partial_plain(x, w3, tab, sx, sw,
                                                      bits, nibble=nib, **geo)
            else:
                comp = form == "log_our"
                got = cg.conv_log_fused(x, w3, sx, sw, bits,
                                        compensated=comp, **geo)
                want = cg.conv_log_fused_plain(x, w3, sx, sw, bits,
                                               compensated=comp, **geo)
                part = cg.conv_log_partial(x, w3, sx, sw, bits,
                                           compensated=comp, **geo)
                part_want = cg.conv_log_partial_plain(x, w3, sx, sw, bits,
                                                      compensated=comp, **geo)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"conv tile kernel ({label}) {geom}: kernel != plain "
                     f"version (max |diff| "
                     f"{float((got - want).abs().max())})")
            if part.dtype != torch.int32 or not torch.equal(part, part_want):
                fail(f"conv tile kernel ({label}) {geom}: partial != plain "
                     f"version")
            if not torch.equal((part.float() * sx) * sw, got):
                fail(f"conv tile kernel ({label}) {geom}: the epilogue of "
                     f"the partial sum != the fused kernel")
            tile = bits <= cg.TILE_MAX_BITS
            entries = (("conv_lut_fused", "conv_lut_partial")
                       if tab is not None else
                       ("conv_log_fused", "conv_log_partial") if tile else
                       ("conv_log_fused_wide", "conv_log_partial_wide"))
            delta = {k: cg.KERNELS[k].launches - before[k] for k in counted}
            if delta != {k: int(k in entries) for k in counted}:
                fail(f"conv tile kernel ({label}) {geom}: launched {delta}, "
                     f"expected one each of {entries}")
    print(f"  conv_lut_fused / conv_log_fused and their partial forms at "
          f"CONV_TILE_EDGES {CONV_TILE_EDGES}: every variant bitwise equal "
          f"to its plain version, each partial through the epilogue to its "
          f"fused kernel, up to 8 bits on the tile kernel, 16-bit log on "
          f"conv_log_fused_wide / conv_log_partial_wide (the template)",
          flush=True)


# ---------------------------------------------------------------------------
# phase 3, mesh: the five partial kernels against their plain versions
# ---------------------------------------------------------------------------


def check_partials(torch, sms: int, clock_hz: float):
    """The mesh path's deferred-epilogue kernels at the shard-local shapes
    phase 9 gives them (the contraction-sharded wo and mlp.wo at model =
    2; the CNN's convs with the input channels halved where they split),
    bitwise against their plain versions, each also equal to its fused
    form before the epilogue; the nibble partial also with scales that
    quantize an operand past -qmax.  Timed as the fused forms are, with
    the fused form's bound at the shard shape (an int32 output moves the
    bytes of an f32 one)."""
    from repro_torch.core.multipliers import MultiplierSpec
    from repro_torch.kernels import approx_matmul as am
    from repro_torch.kernels import conv_gemm as cg
    from repro_torch.kernels import mitchell_gemm as mg
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    lut = ops.lut_table(MultiplierSpec("appro42", 8, True, "orplane", 10),
                        dev)
    subs = ops.nibble_table(MultiplierSpec("exact", 8, True), dev)
    rows = {name: [] for name in PARTIAL_KERNELS}
    print(f"  {'kernel':<26} {'shape':>24} {'ms':>9} {'bound_ms':>9} "
          f"{'by':>10} {'plain_ms':>9} {'fused_ms':>9}", flush=True)
    for shape in PARTIAL_SHAPES + [RAGGED]:
        m, k, n = shape
        g = torch.Generator(device=dev).manual_seed(m * 11 + k + n)
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        # global scales: the max over the other shard too, here 1.25x
        sx, sw = ops._scales(x, w, 8)
        sx, sw = sx * 1.25, sw * 1.25
        calls = {
            "lut_matmul_partial": (
                lambda: am.lut_matmul_partial(x, w, lut, sx, sw),
                lambda: am.lut_matmul_partial_plain(x, w, lut, sx, sw),
                lambda: am.lut_matmul_fused(x, w, lut, sx, sw)),
            "nibble_lut_matmul_partial": (
                lambda: am.nibble_lut_matmul_partial(x, w, subs, sx, sw),
                lambda: am.nibble_lut_matmul_partial_plain(x, w, subs, sx,
                                                           sw),
                lambda: am.nibble_lut_matmul_fused(x, w, subs, sx, sw))}
        for comp, sfx in ((False, ""), (True, "[log_our]")):
            calls["mitchell_matmul_partial" + sfx] = (
                lambda c=comp: mg.mitchell_matmul_partial(x, w, sx, sw,
                                                          compensated=c),
                lambda c=comp: mg.mitchell_matmul_partial_plain(
                    x, w, sx, sw, compensated=c),
                lambda c=comp: mg.mitchell_matmul_fused(x, w, sx, sw,
                                                        compensated=c))
        for name, (kern, plain, fused) in calls.items():
            got, want, full = kern(), plain(), fused()
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            if got.dtype != torch.int32 or not torch.equal(got, want):
                fail(f"{name} {shape}: kernel != plain version (max |diff| "
                     f"{err})")
            if not torch.equal(am.epilogue(got, sx, sw), full):
                fail(f"{name} {shape}: the epilogue of the partial sum != "
                     "the fused kernel")
            if name not in rows or shape == RAGGED:
                continue
            row = {"shape": shape, "max_abs_err": err,
                   "ms": _timed_ms(torch, kern, 10, flush),
                   "fused_ms": _timed_ms(torch, fused, 10, flush),
                   "plain_ms": _timed_ms(torch, plain, 1, flush)}
            row["bound_ms"], row["bound_by"] = _bound(
                name.replace("_partial", "_fused"), m, k, n, sms, clock_hz,
                x.element_size())
            rows[name].append(row)
            print(f"  {name:<26} {str(shape):>24} {row['ms']:9.4f} "
                  f"{row['bound_ms']:9.4f} {row['bound_by']:>10} "
                  f"{row['plain_ms']:9.3f} {row['fused_ms']:9.4f}",
                  flush=True)
    check_surrogate_partial(torch, rows["cim_gemm_partial"], flush)
    # scales that quantize an operand past -qmax: it clips to -127
    x = torch.randn(8, 64, device=dev)
    w = torch.randn(64, 16, device=dev) * 0.02
    sx, sw = ops._scales(x, w, 8)
    x[:, 0] = -2.0 * float(x.abs().max())
    got = am.nibble_lut_matmul_partial(x, w, subs, sx, sw)
    if not torch.equal(got, am.nibble_lut_matmul_partial_plain(x, w, subs,
                                                               sx, sw)):
        fail("nibble_lut_matmul_partial: the clipped int8 minimum differs "
             "from the plain version")
    print("  GEMM partials bitwise equal to their plain versions and to the "
          "fused kernels before the epilogue (mitchell and log_our; the "
          "nibble partial also past -qmax)", flush=True)

    a8 = MultiplierSpec("appro42", 8, True)
    ex = MultiplierSpec("exact", 8, True)
    variants = [("lut appro42", "conv_lut_partial", "lut", a8, False),
                ("nibble exact", "conv_lut_partial", "nibble", ex, False),
                ("mitchell", "conv_log_partial", "log", None, False),
                ("log_our", "conv_log_partial", "log", None, True)]
    # the tile kernel's plans at the shard geometries (one instantiation
    # and plan serve a fused form and its partial)
    for label, name, core, spec, comp in variants:
        form = (core if core != "log" else
                "log_our" if comp else "mitchell")
        for h, w_, c, n in CNN_CONVS:
            cl = c // 2 if c % 2 == 0 else c
            p = cg.device_plan(form, 8,
                               torch.empty(CNN_BATCH, h, w_, cl, device=dev),
                               torch.empty(9, cl, n, device=dev), 3, 3, 1)
            print(f"  partial plan {form:<8} "
                  f"{str((CNN_BATCH, h, w_, cl, n)):<24} rp {p.rp} rn "
                  f"{p.rn}, tile {p.ib}x{p.tr}x{p.tc}, chunk {p.cc} x "
                  f"{p.chunks}, taps {p.tg} x {p.groups}, tiles {p.tiles} "
                  f"on {p.grid} blocks, whole stack {p.whole}", flush=True)
    for gi, (h, w_, c, n) in enumerate(CNN_CONVS):
        cl = c // 2 if c % 2 == 0 else c
        b = CNN_BATCH
        g = torch.Generator(device=dev).manual_seed(41 * gi + 5)
        x = torch.randn(b, h, w_, cl, generator=g, device=dev)
        w3 = torch.randn(9, cl, n, generator=g, device=dev) * 0.1
        sx, sw = ops._scales(x, w3.reshape(-1, n), 8)
        sx, sw = sx * 1.25, sw * 1.25
        for label, name, core, spec, comp in variants:
            if core == "log":
                def kern(c_=comp):
                    return cg.conv_log_partial(x, w3, sx, sw, compensated=c_)

                def plain(c_=comp):
                    return cg.conv_log_partial_plain(x, w3, sx, sw,
                                                     compensated=c_)

                def fused(c_=comp):
                    return cg.conv_log_fused(x, w3, sx, sw, compensated=c_)
            else:
                tab = (ops.nibble_table(spec, dev) if core == "nibble"
                       else ops.lut_table(spec, dev))
                nib = core == "nibble"

                def kern(t=tab, nb=nib):
                    return cg.conv_lut_partial(x, w3, t, sx, sw, nibble=nb)

                def plain(t=tab, nb=nib):
                    return cg.conv_lut_partial_plain(x, w3, t, sx, sw,
                                                     nibble=nb)

                def fused(t=tab, nb=nib):
                    return cg.conv_lut_fused(x, w3, t, sx, sw, nibble=nb)
            before = {k: cg.KERNELS[k].launches for k in
                      ("conv_lut_partial", "conv_log_partial",
                       "conv_log_partial_wide")}
            got = kern()
            delta = {k: cg.KERNELS[k].launches - v for k, v in
                     before.items()}
            if delta != {k: int(k == name) for k in before}:
                fail(f"{name} ({label}): launched {delta}, expected one "
                     f"{name} (the tile kernel)")
            want, full = plain(), fused()
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            if got.dtype != torch.int32 or not torch.equal(got, want):
                fail(f"{name} ({label}) {(b, h, w_, cl, n)}: kernel != plain "
                     f"version (max |diff| {err})")
            if not torch.equal((got.float() * sx) * sw, full):
                fail(f"{name} ({label}): the epilogue of the partial sum != "
                     "the fused kernel")
            row = {"variant": label, "geometry": (b, h, w_, cl, n),
                   "max_abs_err": err,
                   "ms": _timed_ms(torch, kern, 10, flush),
                   "fused_ms": _timed_ms(torch, fused, 10, flush),
                   "plain_ms": _timed_ms(torch, plain, 1, flush)}
            row["bound_ms"], row["bound_by"] = _conv_bound(
                core, comp, b, h, w_, cl, n, h, w_, sms, clock_hz)
            rows[name].append(row)
            print(f"  {name:<17} {label:<12} {str((b, h, w_, cl, n)):>24} "
                  f"{row['ms']:9.4f} {row['bound_ms']:9.4f} "
                  f"{row['bound_by']:>10} {row['plain_ms']:9.3f} "
                  f"{row['fused_ms']:9.4f}", flush=True)
    print("  conv partials on the tile kernel, bitwise equal to their plain "
          "versions and to the fused kernels before the epilogue",
          flush=True)
    return rows


def check_surrogate_partial(torch, rows, flush):
    """cim_gemm_partial (the fused surrogate kernel, flush off) at the
    shard shapes and the ragged one, bf16 operands against global scales
    (1.25x the shard's): its int32 sums bitwise the plain version's with
    and without SQ's halves; the flush over them (`partial_flush`) bitwise
    the fused kernel, deterministic and noisy, also over K cut in two
    shards whose sums are added (the mesh path's row-parallel layer);
    timed without SQ (the served form) beside the fused kernel at the
    same shape, with the fused form's bound (an int32 output moves the
    bytes of an f32 one)."""
    from repro_torch.kernels import cim_gemm as sg

    dev = torch.device("cuda")
    mu, c0, c1 = _surrogate_coeffs()["appro42"]
    for shape in PARTIAL_SHAPES + [RAGGED]:
        m, k, n = shape
        g = torch.Generator(device=dev).manual_seed(m * 13 + k + n)
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        eps = torch.randn(m, n, generator=g, device=dev)
        sx = x.float().abs().amax() * 1.25 / 127
        sw = (w.float().abs().amax(dim=0) * 1.25 / 127).contiguous()
        h = k // 2
        for need_sq in (False, True):
            e = eps if need_sq else None
            got = sg.cim_gemm_partial(x, w, sx, sw, need_sq)
            want = sg.cim_gemm_partial_plain(x, w, sx, sw, need_sq)
            halves = (sg.cim_gemm_partial(x[:, :h].contiguous(), w[:h], sx,
                                          sw, need_sq)
                      + sg.cim_gemm_partial(x[:, h:].contiguous(), w[h:],
                                            sx, sw, need_sq))
            full = sg.cim_gemm_fused(x, w, sx, sw, e, mu, c0, c1)
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            if got.dtype != torch.int32 or not torch.equal(got, want):
                fail(f"cim_gemm_partial {shape} need_sq={need_sq}: kernel != "
                     f"plain version (max |diff| {err})")
            for tag, acc in (("whole", got), ("two K shards", halves)):
                flushed = sg.partial_flush(acc, sx, sw, e, mu, c0, c1, k)
                if not torch.equal(flushed, full):
                    fail(f"cim_gemm_partial {shape} need_sq={need_sq} "
                         f"({tag}): the flush of its sums != cim_gemm_fused "
                         f"(max |diff| "
                         f"{float((flushed - full).abs().max())})")
            if need_sq or shape == RAGGED:
                continue
            row = {"shape": shape, "max_abs_err": err,
                   "ms": _timed_ms(torch, lambda: sg.cim_gemm_partial(
                       x, w, sx, sw, False), 10, flush),
                   "fused_ms": _timed_ms(torch, lambda: sg.cim_gemm_fused(
                       x, w, sx, sw, None, mu, c0, c1), 10, flush),
                   "plain_ms": _timed_ms(torch, lambda: sg.cim_gemm_partial_plain(
                       x, w, sx, sw, False), 1, flush)}
            row["bound_ms"], row["bound_by"] = _surrogate_bound(
                "cim_gemm_fused", m, k, n, x.element_size(), False, False)
            rows.append(row)
            plan = sg.partial_launch_plan(x, w, False)
            print(f"  {'cim_gemm_partial':<26} {str(shape):>24} "
                  f"{row['ms']:9.4f} {row['bound_ms']:9.4f} "
                  f"{row['bound_by']:>10} {row['plain_ms']:9.3f} "
                  f"{row['fused_ms']:9.4f}  (rows {plan.rows}, splits "
                  f"{plan.splits})", flush=True)
    print("  cim_gemm_partial bitwise its plain version (D; D and SQ's four "
          "halves' sums), its flush bitwise cim_gemm_fused with and without "
          "noise, whole and over two K shards", flush=True)


# ---------------------------------------------------------------------------
# phase 3, attention: the three kernels against their plain versions
# ---------------------------------------------------------------------------


def _attn_inputs(torch, dev, b, h, kh, sq, skv, d, variant, seed):
    """Kernel-layout operands, scales and positions of one geometry.
    decode: query at each slot's fill level, keys valid up to it; prefill:
    right-padded prompts (ragged lengths); the small variants are the
    reference tests' (causal, window 5, ragged keys, one-row decode)."""
    from repro_torch.kernels import attn_gemm

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, sq, d, generator=g, device=dev)
    k = torch.randn(b, kh, skv, d, generator=g, device=dev)
    v = torch.randn(b, kh, skv, d, generator=g, device=dev)
    kpos = torch.arange(skv, dtype=torch.int32, device=dev).expand(b, skv)
    window = 5 if variant == "window" else None
    if variant == "decode" and sq == 1 and skv > 64:
        fills = ([skv - 1, 1500, 700, 130] if skv > 1500
                 else [skv - 1, 249, 130, 199])
        fill = torch.tensor(fills, dtype=torch.int32, device=dev)[:b, None]
        qpos, kval = fill, kpos <= fill
    elif variant == "prefill":
        lens = torch.tensor([256, 200, 131, 250], dtype=torch.int32,
                            device=dev)[:b, None]
        qpos, kval = kpos[:, :sq], kpos < lens
    else:
        qpos = torch.arange(skv - sq, skv, dtype=torch.int32,
                            device=dev).expand(b, sq)
        cut = {"ragged": [17, skv], "decode": [23, skv]}.get(variant,
                                                              [skv, skv])
        kval = kpos < torch.tensor(cut, device=dev)[:, None]
    qpos, kval = qpos.contiguous(), kval.to(torch.int32).contiguous()
    if variant == "offset":
        k, v = _misaligned(torch, k), _misaligned(torch, v)
    sc = attn_gemm.attn_scales(q, k, v, 8)
    return (q, k, v), sc, (qpos, kpos.contiguous(), kval), window


def _attn_bound(name, path, comp, q, k, v, pos, table, window, bk, sms,
                clock_hz):
    """(bound_ms, bound_by): the bytes the output depends on, each read or
    written once, at 3.35 TB/s, against the integer products the data
    needs, at the path's peak rate (log: LOG_CLOCKS a product, as the
    template's log core compiles it).  Both count only what the mask
    admits: the (query, key) pairs, the q rows and K/V rows that take
    part in one (the scales are passed in, so no other row is read), and
    the admitted entries of the oracle's score tensor where PV reads it;
    every output is written whole (the scores stage's (B, H, Sq, Skvp)
    tensor too, its masked entries NEG_INF), every position and scale
    read."""
    qpos, kpos, kval = pos
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    m = kval[:, None, :] != 0
    m = m & (kpos[:, None, :] <= qpos[:, :, None])
    if window is not None:
        m = m & (kpos[:, None, :] > qpos[:, :, None] - window)
    pairs = float(m.sum()) * h                   # (b, h, i, j) admitted
    q_rows = float(m.any(dim=2).sum()) * h       # (b, h, i) with a key
    kv_rows = float(m.any(dim=1).sum()) * kh     # (b, kh, j) with a query
    dots = {"attn_fused": 2, "attn_scores": 1, "attn_pv": 1}[name]
    products = dots * pairs * d
    small = 4 * (b * h + 2 * b * kh) + 4 * (b * sq + 2 * b * skv)
    tab = 0 if table is None else table.numel() * table.element_size()
    q_in, kv_in, out = 4 * q_rows * d, 4 * kv_rows * d, 4 * q.numel()
    scores = 4 * pairs
    all_scores = 4.0 * b * h * sq * -(-skv // bk) * bk
    nbytes = small + tab + {
        "attn_fused": q_in + 2 * kv_in + out,
        "attn_scores": q_in + kv_in + all_scores,
        "attn_pv": scores + kv_in + out}[name]
    if path == "mxu":
        ops_s = 2 * products / INT8_TC_OPS_PER_S
    elif path in ("lut", "nibble"):
        gathers = products * (NIBBLE_GATHERS if path == "nibble" else 1)
        ops_s = gathers / (sms * GATHERS_PER_SM_CLOCK * clock_hz)
    else:
        ops_s = products * LOG_CLOCKS[comp] / (sms * clock_hz)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(bytes_s, ops_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def _lsum_check(torch, got, want):
    """(max |d|, outputs that differ, outputs beyond l-sum rounding).

    A kernel and its plain version on one card differ only in the order
    of the sum l of the probabilities (exp, the scores, pq and acc are
    the same operations on the same values), so an output moves by l's
    relative rounding error: at most LSUM_EPS eps of |want|.  One pq
    level moved by a truncation or a wrong qmax moves it by about
    max|v| / (127 l), orders of magnitude more."""
    diff = (got - want).abs()
    beyond = diff > LSUM_EPS * torch.finfo(torch.float32).eps * want.abs()
    return float(diff.max()), int((diff > 0).sum()), int(beyond.sum())


def _oracle_launches(ag, call):
    """Run `call` and return the launches it made of the oracle's four
    entries: (attn_scores, attn_pv, attn_scores_wide, attn_pv_wide)."""
    names = ("attn_scores", "attn_pv", "attn_scores_wide", "attn_pv_wide")
    before = [ag.KERNELS[n].launches for n in names]
    out = call()
    return out, tuple(ag.KERNELS[n].launches - c
                      for n, c in zip(names, before))


def check_attention(torch, sms: int, clock_hz: float):
    from repro_torch.core.autotune import heuristic_attn_block
    from repro_torch.core.multipliers import MultiplierSpec
    from repro_torch.kernels import attn_gemm as ag
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    # (label, path, spec, compensated): the balanced tier's multiplier on
    # the lut path, the economy tier's (mitchell) on the log path, one
    # log_our case, the exact spec on the nibble path, and mxu
    paths = [("lut", "lut", MultiplierSpec("appro42", 8, True, "orplane",
                                           10), False),
             ("log", "log", None, False),
             ("log_our", "log", None, True),
             ("nibble", "nibble", MultiplierSpec("exact", 8, True), False),
             ("mxu", "mxu", None, False)]
    rows = {"attn_fused": [], "attn_scores": [], "attn_pv": []}
    print(f"  {'path':<8} {'geometry':<28} {'kernel':<12} {'ms':>9} "
          f"{'bound_ms':>9} {'by':>10} {'plain_ms':>9} {'tmpl_ms':>9}  "
          f"fused-plain: max |d|, outputs differing, beyond l-sum rounding",
          flush=True)
    for label, path, spec, comp in paths:
        table = ops._attn_table(path, spec, dev)
        geoms = (ATTN_MAIN + (ATTN_SMALL if label != "log_our" else [])
                 + ATTN_LONG + ATTN_ODD)
        for gi, geom in enumerate(geoms):
            b, h, kh, sq, skv, d, variant = geom
            (q, k, v), sc, pos, window = _attn_inputs(
                torch, dev, *geom, seed=17 * gi + len(label))
            bk = (16 if geom in ATTN_SMALL + ATTN_ODD else
                  heuristic_attn_block(f"pallas_attn_{path}", sq, skv)[1])
            kw = dict(path=path, bits=8, causal=True, window=window,
                      compensated=comp, block=(8, bk))
            tpl = dict(kw, route="template")
            calls = {
                "attn_fused": (
                    lambda: ag.attn_fused(q, k, v, *sc, *pos, table, **kw),
                    lambda: ag.attn_reference(q, k, v, *sc, *pos, table,
                                              **kw)),
                "attn_scores": (
                    lambda: ag.attn_scores(q, k, sc[0], sc[1], *pos, table,
                                           **kw),
                    lambda: ag.attn_scores_plain(q, k, sc[0], sc[1], *pos,
                                                 table, **kw),
                    lambda: ag._attn_scores_forced(q, k, sc[0], sc[1], *pos,
                                                   table, **tpl)),
            }
            fused, plain = calls["attn_fused"][0](), calls["attn_fused"][1]()
            scores = calls["attn_scores"][0]()
            tpl_scores = calls["attn_scores"][2]()
            mat = ag.attn_pv(scores, v, sc[2], *pos, table, **kw)
            calls["attn_pv"] = (
                lambda: ag.attn_pv(scores, v, sc[2], *pos, table, **kw),
                lambda: ag.attn_pv_plain(scores, v, sc[2], *pos, table,
                                         **kw),
                lambda: ag._attn_pv_forced(scores, v, sc[2], *pos, table,
                                           **tpl))
            # the template's PV over the same stored scores: with its
            # scores bitwise these, the template's attn_materialized
            tpl_mat = calls["attn_pv"][2]()
            plain_scores = calls["attn_scores"][1]()
            # a <= 8-bit attn_materialized launches each cluster stage once
            # and no template entry
            again, moved = _oracle_launches(ag, lambda: ag.attn_materialized(
                q, k, v, *sc, *pos, table, **kw))
            torch.cuda.synchronize()
            where = f"attention {label} {geom}"
            if moved != (1, 1, 0, 0):
                fail(f"{where}: attn_materialized launched (attn_scores, "
                     f"attn_pv, attn_scores_wide, attn_pv_wide) {moved}, "
                     f"not (1, 1, 0, 0)")
            for what, got, want in (
                    ("scores kernel != plain version", scores, plain_scores),
                    ("scores kernel != the template's", scores, tpl_scores),
                    ("PV kernel != the template's over the same scores",
                     mat, tpl_mat),
                    ("attn_materialized != its two stages", again, mat),
                    ("fused != materialized", fused, mat)):
                if not torch.equal(got, want):
                    fail(f"{where}: {what} (max |d| "
                         f"{float((got - want).abs().max())})")
            err, n_diff, n_level = _lsum_check(torch, fused, plain)
            if n_level:
                fail(f"{where}: fused vs plain: {n_level} outputs differ by "
                     f"more than {LSUM_EPS} eps of |plain| (max |d| {err})")
            pv_plain = calls["attn_pv"][1]()
            torch.cuda.synchronize()
            pv_err, _, pv_level = _lsum_check(torch, mat, pv_plain)
            if pv_level:
                fail(f"{where}: PV stage vs plain: {pv_level} outputs differ "
                     f"by more than {LSUM_EPS} eps of |plain| (max |d| "
                     f"{pv_err})")
            if variant == "offset":
                # the PV kernel's element-wise score loads (rows one float
                # off 16-byte alignment)
                off = ag.attn_pv(_misaligned(torch, scores), v, sc[2], *pos,
                                 table, **kw)
                torch.cuda.synchronize()
                if not torch.equal(off, mat):
                    fail(f"{where}: PV over misaligned scores != aligned "
                         f"(max |d| {float((off - mat).abs().max())})")
            # the cluster kernel forced to every split of the kv blocks
            # that leaves no range empty, fused and PV (bitwise both
            # oracles, so within the l sum's rounding of the plain
            # version), and the scores mode at every split of its grid
            plan = ag.device_plan(q, k, path, 8, bk, comp, causal=True)
            nk = -(-skv // bk)
            for splits in range(1, min(ag.MAX_SPLITS, nk) + 1):
                force = {"splits": splits}
                forced = ag._attn_fused_forced(q, k, v, *sc, *pos, table,
                                               force, **kw)
                pv = ag._attn_pv_forced(scores, v, sc[2], *pos, table,
                                        force=force, **kw)
                torch.cuda.synchronize()
                for what, got in (("the cluster kernel", forced),
                                  ("the PV kernel", pv)):
                    if not (torch.equal(got, mat) and
                            torch.equal(got, tpl_mat)):
                        fail(f"{where}: {what} at {splits} splits != "
                             f"materialized (max |d| "
                             f"{float((got - tpl_mat).abs().max())})")
            for splits in range(1, min(ag.MAX_SCORE_SPLITS, nk) + 1):
                got = ag._attn_scores_forced(q, k, sc[0], sc[1], *pos, table,
                                             force={"splits": splits}, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, tpl_scores):
                    fail(f"{where}: the scores kernel at {splits} splits != "
                         f"the template's")
            plans = {m: ag.device_plan(q, k, path, 8, bk, comp, causal=True,
                                       mode=m) for m in ("scores", "pv")}
            print(f"  {label:<8} {str(geom[:6]):<28} plan: bq {plan.bq}, "
                  f"{plan.splits} splits of {plan.per} kv blocks ("
                  f"{plan.chunks} chunks), ring {plan.rk} keys, "
                  f"{plan.smem} B, {plan.tiles} tiles in {plan.waves} "
                  f"waves; oracle " + ", ".join(
                      f"{m} bq {p.bq} x {p.splits} of {p.per} rk {p.rk} "
                      f"{p.waves} waves" for m, p in plans.items())
                  + f"; splits 1..{min(ag.MAX_SPLITS, nk)} forced (fused, "
                  f"PV; scores 1..{min(ag.MAX_SCORE_SPLITS, nk)}), each == "
                  f"both oracles", flush=True)
            timed = geom in ATTN_MAIN
            for name in rows:
                row = {"path": label, "geometry": geom,
                       "max_abs_err": (err if name == "attn_fused" else
                                       0.0 if name == "attn_scores"
                                       else pv_err)}
                if timed:
                    kern, pl = calls[name][:2]
                    row["ms"] = _timed_ms(torch, kern, 10, flush)
                    row["plain_ms"] = _timed_ms(torch, pl, 1, flush)
                    if name != "attn_fused":   # the witness, same timer
                        row["template_ms"] = _timed_ms(torch, calls[name][2],
                                                       10, flush)
                    row["bound_ms"], row["bound_by"] = _attn_bound(
                        name, path, comp, q, k, v, pos, table, window, bk,
                        sms, clock_hz)
                    print(f"  {label:<8} {str(geom[:6]):<28} {name:<12} "
                          f"{row['ms']:9.4f} {row['bound_ms']:9.4f} "
                          f"{row['bound_by']:>10} {row['plain_ms']:9.3f} "
                          f"{row.get('template_ms', float('nan')):9.4f}"
                          + (f"  {err:.3e}, {n_diff}, {n_level}"
                             if name == "attn_fused" else ""), flush=True)
                rows[name].append(row)
            if not timed:
                print(f"  {label:<8} {str(geom):<40} scores bitwise, fused "
                      f"== both oracles, fused-plain {err:.3e} ({n_diff} "
                      f"differ, none beyond l-sum rounding)", flush=True)
    check_attention_wide(torch, dev)
    return rows


def check_attention_wide(torch, dev):
    """The log path's ATTN_WIDE_BITS operands (mitchell and log_our) at
    ATTN_SMALL and the serving decode: each fused call launches the
    template's fused kernel (attn_fused_wide) once and the cluster kernel
    no time, each attn_materialized the template's pair (attn_scores_wide,
    attn_pv_wide) once each and the cluster kernel's stages no time,
    fused bitwise the oracle and within LSUM_EPS eps of the plain
    version."""
    from repro_torch.core.autotune import heuristic_attn_block
    from repro_torch.kernels import attn_gemm as ag

    wide, cluster = ag.KERNELS["attn_fused_wide"], ag.KERNELS["attn_fused"]
    for comp in (False, True):
        label = "log_our" if comp else "log"
        for bits in ATTN_WIDE_BITS:
            worst = 0.0
            for gi, geom in enumerate(ATTN_SMALL + ATTN_MAIN[:1]):
                sq, skv = geom[3], geom[4]
                (q, k, v), _, pos, window = _attn_inputs(
                    torch, dev, *geom, seed=31 * gi + bits)
                sc = ag.attn_scales(q, k, v, bits)
                bk = (16 if geom in ATTN_SMALL else heuristic_attn_block(
                    "pallas_attn_log", sq, skv)[1])
                kw = dict(path="log", bits=bits, causal=True, window=window,
                          compensated=comp, block=(8, bk))
                n_wide, n_cluster = wide.launches, cluster.launches
                fused = ag.attn_fused(q, k, v, *sc, *pos, **kw)
                moved = (wide.launches - n_wide, cluster.launches - n_cluster)
                mat, oracle = _oracle_launches(ag, lambda: ag.attn_materialized(
                    q, k, v, *sc, *pos, **kw))
                plain = ag.attn_reference(q, k, v, *sc, *pos, **kw)
                torch.cuda.synchronize()
                where = f"attention {label} {bits} bits {geom}"
                if moved != (1, 0):
                    fail(f"{where}: launched attn_fused_wide {moved[0]} and "
                         f"the cluster kernel {moved[1]} times, not 1 and 0")
                if oracle != (0, 0, 1, 1):
                    fail(f"{where}: attn_materialized launched (attn_scores, "
                         f"attn_pv, attn_scores_wide, attn_pv_wide) {oracle}, "
                         f"not (0, 0, 1, 1)")
                if not torch.equal(fused, mat):
                    fail(f"{where}: fused (template) != materialized (max "
                         f"|d| {float((fused - mat).abs().max())})")
                err, _, n_level = _lsum_check(torch, fused, plain)
                if n_level:
                    fail(f"{where}: fused (template) vs plain: {n_level} "
                         f"outputs differ by more than {LSUM_EPS} eps of "
                         f"|plain| (max |d| {err})")
                worst = max(worst, err)
            print(f"  {label:<8} {bits} bits, the template's three kernels "
                  f"at {len(ATTN_SMALL) + 1} geometries: fused == oracle, "
                  f"fused-plain {worst:.3e} (none beyond l-sum rounding)",
                  flush=True)


# ---------------------------------------------------------------------------
# phase 3, sLSTM: the fused recurrence against its plain version
# ---------------------------------------------------------------------------

# (B, nh, dh, T): xlstm-125m's width (4 heads of 192, phase 10's batch of
# 4) at a decode step, a ragged length and phase 10's 512-token prefill,
# all timed; batch 8 (two row tiles a head), the smoke width (dh 16) and
# a ragged row tile, checked only; every cluster size that fits at dh =
# 192 forced at SLSTM_SIZES_AT (launch/cluster_sweep.py times them); the
# streamed route at one head too wide for any cluster, checked and timed
SLSTM_FULL = [(4, 4, 192, t) for t in (1, 37, 512)]
SLSTM_CHECKED = [(8, 4, 192, 37), (2, 4, 16, 24), (5, 4, 16, 9)]
SLSTM_SIZES_AT = (4, 4, 192, 37)
SLSTM_WIDE = (2, 1, 512, 9)


def _slstm_bound(b, nh, dh, t, sms, clock_hz):
    """(bound_ms, bound_by): u, r, the bias and the initial state read
    once and h and the final state written once (f32) at 3.35 TB/s,
    against the recurrent matvec's B T nh dh 4dh f32 FMAs at 128 a clock
    per SM.  The serial dependency across T is not in it: step t + 1
    needs every h of step t."""
    d = nh * dh
    nbytes = 4 * (b * t * 4 * d + nh * dh * 4 * dh + 4 * d + 4 * b * d
                  + b * t * d + 4 * b * d)
    ops_s = b * t * nh * dh * 4 * dh / (sms * FP32_FMA_PER_SM_CLOCK
                                        * clock_hz)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(bytes_s, ops_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def _slstm_inputs(torch, dev, shape, start):
    b, nh, dh, t = shape
    g = torch.Generator(device=dev).manual_seed(b * t + dh)
    u = torch.randn(b, t, 4 * nh * dh, generator=g, device=dev)
    r = torch.randn(nh, dh, 4 * dh, generator=g, device=dev) * 0.05
    bias = torch.randn(nh, 4 * dh, generator=g, device=dev) * 0.1
    state = None
    if start == "state":            # as a run leaves it
        sh = (b, nh, dh)
        state = (torch.rand(sh, generator=g, device=dev) * 2 - 1,
                 torch.rand(sh, generator=g, device=dev) * 1.5 + 0.5,
                 torch.rand(sh, generator=g, device=dev) - 0.5,
                 torch.rand(sh, generator=g, device=dev) * 2 - 1)
    return u, r, bias, state


def check_slstm(torch, sms: int, clock_hz: float):
    """`slstm_scan` against its plain version from a zero and from a
    nonzero state, h and the final (c, n, h, m) within the tolerance
    kernels/slstm_scan.py states, each call on its plan's route (the
    cluster route at every dh = 192 and dh = 16 shape, the streamed one
    at SLSTM_WIDE); every cluster size that fits forced once at
    SLSTM_SIZES_AT; the full-width cases and the wide one timed."""
    from repro_torch.kernels import ref, slstm_scan

    dev = torch.device("cuda")
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    rows = {"slstm_scan": []}
    print(f"  tolerance: h, m within {slstm_scan.ATOL:g}; c, n within "
          f"{slstm_scan.ATOL:g} + {slstm_scan.STATE_RTOL:g} |plain|",
          flush=True)
    print(f"  {'B,nh,dh,T':>16} {'start':<6} {'route':>8} {'cs':>3} "
          f"{'max|err|':>9} {'ms':>9} {'us/step':>8} "
          f"{'bound_ms':>9} {'by':>10} {'plain_ms':>9}", flush=True)

    def check(shape, start, variant, run, want_route):
        u, r, bias, state = _slstm_inputs(torch, dev, shape, start)
        nh = shape[1]
        routes = dict(slstm_scan.ROUTES)
        got = run(u, r, bias, nh, state)
        torch.cuda.synchronize()
        took = [k for k in routes if slstm_scan.ROUTES[k] != routes[k]]
        if took != [want_route]:
            fail(f"slstm_scan {shape} from {start}: took the routes {took}, "
                 f"expected {want_route}")
        want = ref.slstm_scan_ref(u, r, bias, nh, state)
        err = float((got[0] - want[0]).abs().max())
        serr = max(float((a - w).abs().max())
                   for a, w in zip(got[1], want[1]))
        if not slstm_scan.close(got, want) or not torch.isfinite(
                got[0]).all():
            fail(f"slstm_scan {shape} from {start} ({variant}): kernel != "
                 f"plain version (max |dh| {err}, max |dstate| {serr})")
        return {"shape": shape, "variant": variant,
                "max_abs_err": max(err, serr)}, (u, r, bias, state)

    def show(row, start, route, cs):
        b, nh, dh, t = row["shape"]
        timed = (f"{row['ms']:9.4f} {1e3 * row['ms'] / t:8.2f} "
                 f"{row['bound_ms']:9.4f} {row['bound_by']:>10} "
                 f"{row['plain_ms']:9.3f}" if "ms" in row else "")
        print(f"  {str(row['shape']):>16} {start:<6} {route:>8} {cs:>3} "
              f"{row['max_abs_err']:9.2e} {timed}", flush=True)

    for shape in SLSTM_FULL + SLSTM_CHECKED + [SLSTM_WIDE]:
        b, nh, dh, t = shape
        plan = slstm_scan.device_plan(b, nh, dh, dev)
        wide = shape == SLSTM_WIDE
        if plan.route != ("streamed" if wide else "cluster"):
            fail(f"slstm_scan {shape}: the plan took the {plan.route} route")
        for start in ("zero", "state"):
            variant = f"streamed {start}" if wide else start
            row, (u, r, bias, state) = check(
                shape, start, variant, slstm_scan.slstm_scan, plan.route)
            row.update(route=plan.route, cs=plan.cs)
            if shape in SLSTM_FULL or wide:
                row["ms"] = _timed_ms(torch, lambda: slstm_scan.slstm_scan(
                    u, r, bias, nh, state), 10, flush)
                row["plain_ms"] = _timed_ms(
                    torch, lambda: ref.slstm_scan_ref(u, r, bias, nh, state),
                    1, flush)
                row["bound_ms"], row["bound_by"] = _slstm_bound(
                    b, nh, dh, t, sms, clock_hz)
            rows["slstm_scan"].append(row)
            show(row, start, plan.route, plan.cs)
    dh = SLSTM_SIZES_AT[2]
    sizes = slstm_scan.fitting_sizes(dh, dev)
    for cs in sizes:
        row, _ = check(SLSTM_SIZES_AT, "state", f"cs{cs}",
                       lambda *a, cs=cs: slstm_scan._launch(*a, cs),
                       "cluster")
        rows["slstm_scan"].append(row)
        show(row, "state", "cluster", cs)
    print(f"  slstm_scan: every case within the tolerance, on its plan's "
          f"route; cluster sizes {sizes} at {SLSTM_SIZES_AT} too; library "
          "call: none (no PyTorch call computes this recurrence: "
          "torch.nn.LSTM's cell has no exponential gating or normaliser); "
          "the bound leaves out the serial dependency across T", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 4: the LM on the card against the LM on the CPU (small input)
# ---------------------------------------------------------------------------


def _card_vs_cpu(torch, name, cpu, gpu, params_cpu, params_gpu, toks, tol,
                 steps):
    """Prefill + `steps` greedy decode steps (the CPU's token fed to
    both) on the card and on the CPU: (max |logit diff|, near-ties),
    failing beyond `tol`, on a non-finite logit, or on another greedy
    token where the CPU's top-2 gap exceeds `tol`."""
    s = toks.shape[1]
    with torch.inference_mode():
        lc, cc = cpu.prefill(params_cpu, {"tokens": toks, "max_len": 16})
        lg, cg = gpu.prefill(params_gpu, {"tokens": toks.cuda(),
                                          "max_len": 16})
        worst, close = 0.0, 0
        for step in range(steps + 1):
            a = lc[:, -1].float()
            b = lg[:, -1].float().cpu()
            if not torch.isfinite(b).all():
                fail(f"reference {name}: non-finite logits")
            worst = max(worst, float((a - b).abs().max()))
            if worst > tol:
                fail(f"reference {name} step {step}: max |card - cpu| "
                     f"{worst} > {tol}")
            top2 = a.topk(2, dim=-1).values
            for i in range(a.shape[0]):
                if top2[i, 0] - top2[i, 1] > tol:
                    if int(b[i].argmax()) != int(a[i].argmax()):
                        fail(f"reference {name}: greedy token differs at "
                             f"step {step} row {i}")
                else:
                    close += 1
            if step == steps:
                break
            tok = a.argmax(-1, keepdim=True)
            lc, cc = cpu.decode_step(params_cpu, cc, tok, s + step)
            lg, cg = gpu.decode_step(params_gpu, cg, tok.cuda(), s + step)
    return worst, close


def check_reference(torch):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serving import build_tiers

    cfg = get_config("qwen3-1.7b", smoke=True)
    params_cpu = LM(cfg, device="cpu").init(0)
    params_gpu = _to(torch, params_cpu, "cuda")
    rng_tokens = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=rng_tokens)
    tiers = (build_tiers(mode="hardware")
             + build_tiers(mode="hardware", attn=True)
             + build_tiers(mode="surrogate"))
    nibble_lane = _nibble_tier(tiers)
    nibble_kernel = _kernel_modules()["nibble_lut_matmul_fused"]
    surr_kernel = _kernel_modules()["cim_gemm_fused"]
    for tier in tiers + (nibble_lane,):
        name = (tier.name + (" +attn" if tier.cim.attn else "")
                + (" surrogate" if tier.cim.mode == "surrogate" else ""))
        nib0, surr0 = nibble_kernel.launches, surr_kernel.launches
        c = dataclasses.replace(cfg, cim=tier.cim)
        worst, close = _card_vs_cpu(
            torch, name, LM(c, device="cpu"), LM(c, device="cuda"),
            params_cpu, params_gpu, toks, REF_TOL[tier.name], 3)
        nib = nibble_kernel.launches - nib0
        surr = surr_kernel.launches - surr0
        if (tier is nibble_lane) != (nib > 0):
            fail(f"reference {name}: the nibble GEMM kernel launched {nib} "
                 "times")
        if (tier.cim.mode == "surrogate") != (surr > 0):
            fail(f"reference {name}: the fused surrogate kernel launched "
                 f"{surr} times")
        print(f"  {name:<19} card vs cpu: max |logit diff| {worst:.3e} "
              f"<= {REF_TOL[tier.name]} ; greedy tokens equal ({close} "
              f"near-ties under the gap rule); nibble GEMM launches {nib}, "
              f"fused surrogate launches {surr}", flush=True)

    # xlstm-125m-smoke on the hardware ladder: prefill + 4 decode steps,
    # the sLSTM layer through the fused recurrence on every forward
    cfg = get_config("xlstm-125m", smoke=True)
    params_cpu = LM(cfg, device="cpu").init(0)
    params_gpu = _to(torch, params_cpu, "cuda")
    toks = torch.randint(0, cfg.vocab, (4, 8), generator=rng_tokens)
    from repro_torch.kernels.slstm_scan import ROUTES

    scan = _kernel_modules()["slstm_scan"]
    n_slstm = cfg.layer_pattern.count("slstm")
    for tier in build_tiers(mode="hardware"):
        c = dataclasses.replace(cfg, cim=tier.cim)
        n0, routes = scan.launches, dict(ROUTES)
        worst, close = _card_vs_cpu(
            torch, f"{cfg.name} {tier.name}", LM(c, device="cpu"),
            LM(c, device="cuda"), params_cpu, params_gpu, toks,
            REF_TOL[tier.name], 4)
        took = {k: ROUTES[k] - routes[k] for k in ROUTES}
        if scan.launches - n0 != 5 * n_slstm or took != {
                "cluster": 5 * n_slstm, "streamed": 0}:
            fail(f"reference {cfg.name} {tier.name}: slstm_scan launched "
                 f"{scan.launches - n0} times in 5 forwards (routes "
                 f"{took}), expected {5 * n_slstm}, all on the cluster "
                 "route")
        print(f"  {cfg.name} {tier.name:<9} card vs cpu: max |logit diff| "
              f"{worst:.3e} <= {REF_TOL[tier.name]} ; greedy tokens equal "
              f"({close} near-ties under the gap rule); slstm_scan "
              f"launches {scan.launches - n0}, all on the cluster route",
              flush=True)


def check_norm_rows(torch):
    """The norm's row-count invariance on the card: over 64 bf16 inputs
    of 4 rows at d = 2048, 768, 1536 and 128 (qwen3's width, xlstm's,
    the mLSTM's inner width, qwen3's head width), the mean square of
    rows 0-1 alone (a data rank's share of the pool) against the 4-row
    one, for the port's `row_mean_square` (must be bitwise) and, for
    the record, one wide torch.mean (what the norm used before)."""
    from repro_torch.models.common import rms_norm, row_mean_square

    dev = torch.device("cuda")
    for d in (2048, 768, 1536, 128):
        g = torch.Generator(device=dev).manual_seed(d)
        w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(
            torch.bfloat16)
        moved = {"row_mean_square": 0, "rms_norm": 0, "torch.mean": 0}
        for _ in range(64):
            x = (torch.randn(4, d, generator=g, device=dev) * 3).to(
                torch.bfloat16).float()
            two = x[:2].clone()
            moved["row_mean_square"] += not torch.equal(
                row_mean_square(two), row_mean_square(x)[:2])
            moved["rms_norm"] += not torch.equal(
                rms_norm(two.bfloat16(), w), rms_norm(x.bfloat16(), w)[:2])
            moved["torch.mean"] += not torch.equal(
                torch.mean(two * two, -1), torch.mean(x * x, -1)[:2])
        if moved["row_mean_square"] or moved["rms_norm"]:
            fail(f"rms_norm at d = {d}: rows 0-1 alone differ from the "
                 f"4-row call ({moved})")
        print(f"  norm rows, d = {d}: of 64 inputs, rows 0-1 alone differ "
              f"from the 4-row call in {moved['row_mean_square']} mean "
              f"squares and {moved['rms_norm']} norms (the port); one wide "
              f"torch.mean differs in {moved['torch.mean']}", flush=True)


def _to(torch, tree, device):
    if isinstance(tree, dict):
        return {k: _to(torch, v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(torch, v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# phases 5, 6 and 8: serve full-size qwen3-1.7b on the hardware ladder
# without and with CiM attention, and on the surrogate ladder
# ---------------------------------------------------------------------------

# the cim_linear GEMMs of one qwen3 layer: wq, wk, wv, wo, mlp_wi, mlp_wg,
# mlp_wo (the LM head is a plain matmul)
GEMMS_PER_LAYER = 7
# the served lane of the nibble GEMM (phases 4 and 5)
NIBBLE_LANE = "balanced/4"


def _nibble_tier(tiers):
    """The balanced tier's multiplier with 4 approximate columns (appro42
    orplane): nibble-decomposable, so its GEMMs run the nibble kernel."""
    bal = next(t for t in tiers if t.name == "balanced")
    return dataclasses.replace(
        bal, name=NIBBLE_LANE,
        cim=dataclasses.replace(bal.cim, n_approx_cols=4))


def _kernel_modules():
    from repro_torch.kernels import (approx_matmul, attn_gemm, cim_gemm,
                                     conv_gemm, mitchell_gemm, slstm_scan)

    return {**approx_matmul.KERNELS, **mitchell_gemm.KERNELS,
            **conv_gemm.KERNELS, **attn_gemm.KERNELS, **cim_gemm.KERNELS,
            **slstm_scan.KERNELS}


def _launch_counts():
    return {n: k.launches for n, k in _kernel_modules().items()}


def _reset_counts():
    for k in _kernel_modules().values():
        k.launches = 0


def _count_forwards(eng):
    """Count each lane's LM forwards (prefill groups and decode rounds)."""
    counts = {name: 0 for name in eng.lanes}
    for name, lane in eng.lanes.items():
        lm = lane.backend.lm
        for meth in ("prefill", "decode_step"):
            def wrapped(*a, _real=getattr(lm, meth), _name=name, **kw):
                counts[_name] += 1
                return _real(*a, **kw)
            setattr(lm, meth, wrapped)
    return counts


def serve(torch, layers, power, attn: bool, mode: str = "hardware"):
    from repro_torch.configs import get_config
    from repro_torch.models.attention import (cim_attn_fallbacks,
                                              reset_cim_attn_fallbacks)
    from repro_torch.serving import (EngineStats, RealClock, SimClock,
                                     build_engine, build_tiers,
                                     poisson_workload)

    cfg = get_config("qwen3-1.7b")
    if layers and layers < cfg.n_layers:
        print(f"  CUT: {layers} of {cfg.n_layers} layers (widths unchanged)")
        cfg = dataclasses.replace(cfg, n_layers=layers, n_periods=layers)
    if attn:
        max_len, bucket, plens, news = 320, 256, (130, 250), (4, 8)
        n_req, mix, seed = ATTN_REQUESTS, ATTN_MIX, ATTN_SEED
    else:
        max_len, bucket, plens, news = 32, 16, (8, 16), (4, 16)
        n_req, mix, seed = N_REQUESTS, MIX, WORKLOAD_SEED
    print(f"  {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} x {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {cfg.n_layers} layers; {mode} ladder; CiM "
          f"attention {attn}; {max_len}-token slots, prompt bucket {bucket}",
          flush=True)
    tiers = build_tiers(mode=mode, attn=attn)
    # phase 5 also serves the nibble GEMM's lane, which the Poisson
    # workload never reaches: its own requests below
    nib_lane = mode == "hardware" and not attn
    if nib_lane:
        tiers = tiers + (_nibble_tier(tiers),)
    nib_per_fwd = GEMMS_PER_LAYER * cfg.n_layers
    # the GEMM kernels each approximate forward must launch, and how often
    per_fwd = ({"cim_gemm_fused": GEMMS_PER_LAYER * cfg.n_layers}
               if mode == "surrogate" else {})
    t0 = time.perf_counter()
    eng = build_engine(cfg, tiers=tiers, slots_per_tier=4, max_len=max_len,
                       prompt_buckets=(bucket,), group_buckets=(1, 2, 4),
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
    wl = poisson_workload(n_req, rate=20.0, vocab=cfg.vocab,
                          prompt_len=plens, max_new=news, tier_mix=mix,
                          seed=seed)
    forwards = _count_forwards(eng)

    def run_sim(wl=wl):
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

    reset_cim_attn_fallbacks()
    for k in forwards:
        forwards[k] = 0
    _reset_counts()
    res_a, secs = run_sim()
    launches = _launch_counts()
    fallbacks = cim_attn_fallbacks()
    tiers_used = sorted({r.tier for r in res_a.values()})
    if tiers_used != sorted(name for name, _, _ in mix):
        fail(f"the workload reached only the tiers {tiers_used}")
    print(f"  simulated-clock run: {len(wl)} requests ({', '.join(tiers_used)}"
          f"), {sum(len(r.tokens) for r in res_a.values())} tokens in "
          f"{secs:.1f}s; forwards per lane {forwards}; kernel launches "
          f"{launches}; float-path attention fallbacks {fallbacks}",
          flush=True)
    approx = forwards["balanced"] + forwards["economy"]
    fused = (("lut_matmul_fused", "mitchell_matmul_fused")
             if mode == "hardware" else ("cim_gemm_fused",))
    for name in fused:
        if launches[name] <= 0:
            fail(f"{name} was not launched while serving")
    for name, n in per_fwd.items():
        if launches[name] != n * approx:
            fail(f"{name} launched {launches[name]} times, expected {n} a "
                 f"forward of the approximate lanes ({approx} forwards), "
                 "none on the exact lane")
    others = {k: v for k, v in launches.items()
              if v and k not in fused and k != "attn_fused"}
    if others:
        fail(f"kernels of another mode launched while serving: {others}")
    want = cfg.n_layers * approx if attn else 0
    if launches["attn_fused"] != want:
        fail(f"attn_fused launched {launches['attn_fused']} times, expected "
             f"{want} ({cfg.n_layers} per forward of the approximate lanes, "
             "none on the exact lane)")
    if attn and fallbacks:
        fail(f"{fallbacks} attention calls fell back to the float path")
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

    if nib_lane:
        # the nibble lane: the Poisson workload's first four requests
        # pinned to it, served twice under the simulated clock; every
        # forward launches the nibble kernel once a CiM GEMM, nothing else
        nwl = [dataclasses.replace(r, rid=1000 + r.rid, tier=NIBBLE_LANE)
               for r in wl[:4]]
        eng.warmup()
        for k in forwards:
            forwards[k] = 0
        _reset_counts()
        res_n, secs = run_sim(nwl)
        nib, nf = _launch_counts(), forwards[NIBBLE_LANE]
        want = {"nibble_lut_matmul_fused": nib_per_fwd * nf}
        if not nf or {k: v for k, v in nib.items() if v} != want:
            fail(f"{NIBBLE_LANE}: launches {nib} in {nf} forwards, "
                 f"expected {want}")
        eng.warmup()
        res_m, _ = run_sim(nwl)
        if any(res_n[r.rid].tokens != res_m[r.rid].tokens for r in nwl):
            fail(f"{NIBBLE_LANE}: the same requests served twice gave "
                 "different tokens")
        ntok = sum(len(r.tokens) for r in res_n.values())
        print(f"  {NIBBLE_LANE} lane (appro42/orplane/4, the nibble GEMM): "
              f"{len(nwl)} requests, {ntok} tokens in {secs:.1f}s under the "
              f"simulated clock, {nf} forwards, nibble_lut_matmul_fused "
              f"launched {nib['nibble_lut_matmul_fused']} times "
              f"({nib_per_fwd} a forward), no plan misses after warmup; "
              "served again: identical tokens", flush=True)
        launches = {k: launches[k] + nib[k] for k in launches}

    # where the time goes: one pool decode round and one 4 x bucket
    # prefill per lane, host clock around work that ends in a synchronize
    for name, lane in eng.lanes.items():
        b = lane.backend
        toks = torch.zeros((4, bucket), dtype=torch.int64, device=b.device)
        lens = torch.full((4,), bucket, dtype=torch.int32, device=b.device)
        b.reset()
        _reset_counts()
        t = time.perf_counter()
        for _ in range(3):
            b.decode_round()
        torch.cuda.synchronize()
        dec = (time.perf_counter() - t) / 3
        counts = _launch_counts()
        n_attn = counts["attn_fused"]
        want = 3 * cfg.n_layers if attn and name != "exact" else 0
        if n_attn != want:
            fail(f"{name}: attn_fused launched {n_attn} times in 3 decode "
                 f"rounds, expected {want}")
        for kname, n in per_fwd.items():
            want = 3 * n if name != "exact" else 0
            if counts[kname] != want:
                fail(f"{name}: {kname} launched {counts[kname]} times in 3 "
                     f"decode rounds, expected {want}")
        want = 3 * nib_per_fwd if name == NIBBLE_LANE else 0
        if counts["nibble_lut_matmul_fused"] != want:
            fail(f"{name}: nibble_lut_matmul_fused launched "
                 f"{counts['nibble_lut_matmul_fused']} times in 3 decode "
                 f"rounds, expected {want}")
        t = time.perf_counter()
        with torch.inference_mode():
            b.lm.prefill(b.params, {"tokens": toks, "lengths": lens,
                                    "max_len": b.max_len})
        torch.cuda.synchronize()
        pre = time.perf_counter() - t
        b.reset()
        print(f"    {name:<9} decode round (4 slots) {1e3 * dec:.1f} ms, "
              f"prefill (4 x {bucket}) {1e3 * pre:.1f} ms; launches a decode "
              f"round {({k: v // 3 for k, v in counts.items() if v})}",
              flush=True)
        _profile(torch, name, b.decode_round, dec)
        b.reset()
    return launches


# ---------------------------------------------------------------------------
# phase 7: Table IV on the card
# ---------------------------------------------------------------------------


def table4(torch):
    """Train the CNN, evaluate it under both semantics, and hold every
    hardware forward to its kernels, its im2col oracle and the CPU.
    Returns the launch counts of the hardware evaluation (the main path of
    this phase) and the hardware rows."""
    from repro_torch.core.approx_gemm import plan_misses
    from repro_torch.launch import table4_cnn as t4
    from repro_torch.models.cnn import cnn_forward
    from repro_torch.models.common import CiMContext, CiMParams

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params, loss, acc = t4.train_cnn(TRAIN_STEPS, device=dev)
    torch.cuda.synchronize()
    print(f"  trained {TRAIN_STEPS} float SGD steps (batch 64, lr {t4.LR}) in "
          f"{time.perf_counter() - t0:.1f}s: last-batch loss {loss:.4f}, "
          f"accuracy {acc:.3f}", flush=True)
    t = time.perf_counter()
    ref = {fam: t4.evaluate(params, fam) for fam in FAMS}
    print(f"  reference semantics (bit-exact LUT gather, exact family in "
          f"exact mode), n={CNN_BATCH}, {time.perf_counter() - t:.1f}s:")
    for row in t4.table_rows(ref):
        print(f"    {row}")
    print(f"    claims (appro42/log_our hold accuracy, LM degrades): "
          f"{t4.claims(ref)}", flush=True)

    x, ys = t4.eval_images(CNN_BATCH, device=dev)
    hw, logits = {}, {}
    _reset_counts()                    # the main path: the hardware forwards
    for fam in FAMS:
        ctx = t4.hardware_context(fam)
        before = _launch_counts()
        with torch.no_grad():
            logits[fam] = cnn_forward(params, x, ctx)
        torch.cuda.synchronize()
        delta = {n: c - before[n] for n, c in _launch_counts().items()}
        conv, fc = CNN_KERNELS[fam]
        want = {n: {conv: 5, fc: 1}.get(n, 0) for n in delta}
        if delta != want:
            fail(f"table4 {fam}: one hardware forward launched "
                 f"{ {n: c for n, c in delta.items() if c} }, expected "
                 f"5 x {conv} and 1 x {fc} (no conv_im2col)")
        misses = plan_misses()
        with torch.no_grad():
            again = cnn_forward(params, x, ctx)
        torch.cuda.synchronize()
        if plan_misses() != misses:
            fail(f"table4 {fam}: {plan_misses() - misses} plan misses "
                 "after the first forward")
        if not torch.equal(again, logits[fam]):
            fail(f"table4 {fam}: a second forward gave other logits")
        hw[fam] = t4.top1_top5(logits[fam], ys)
    launches = _launch_counts()
    print(f"  hardware mode, n={CNN_BATCH}: 5 conv + 1 fc kernel launches a "
          f"forward for every family, no plan miss after the first; "
          f"launches {launches}")
    for row in t4.table_rows(hw):
        print(f"    {row}")
    print(f"    claims (appro42/log_our hold accuracy, LM degrades): "
          f"{t4.claims(hw)}", flush=True)

    cpu_params = {k: v.cpu() for k, v in params.items()}
    for fam in FAMS:
        ctx = t4.hardware_context(fam)
        with torch.no_grad():
            base = cnn_forward(params, x, ctx, fused=False)
            card16 = cnn_forward(params, x[:16], ctx)
            cpu16 = cnn_forward(cpu_params, x[:16].cpu(), ctx)
        torch.cuda.synchronize()
        if not torch.equal(base, logits[fam]):
            fail(f"table4 {fam}: fused != the im2col oracle (max |d| "
                 f"{float((base - logits[fam]).abs().max())})")
        diff = float((card16.cpu() - cpu16).abs().max())
        if not torch.isfinite(card16).all() or diff > CNN_TOL:
            fail(f"table4 {fam}: card vs cpu max |logit diff| {diff} > "
                 f"{CNN_TOL}")
        top2 = cpu16.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > CNN_TOL
        if (card16.cpu().argmax(-1) != cpu16.argmax(-1))[clear].any():
            fail(f"table4 {fam}: top-1 differs from the CPU's where the "
                 f"top-2 gap exceeds {CNN_TOL}")
        # one forward on the host clock (warm), then under the profiler
        with torch.no_grad():
            t = time.perf_counter()
            cnn_forward(params, x, ctx)
            torch.cuda.synchronize()
            fwd = time.perf_counter() - t
            print(f"    {fam:<9} fused == im2col oracle bitwise; card vs "
                  f"cpu (16 images) max |logit diff| {diff:.3e} <= "
                  f"{CNN_TOL}, top-1 equal on {int(clear.sum())} clear "
                  f"rows; forward ({CNN_BATCH} images) {1e3 * fwd:.2f} ms",
                  flush=True)
            _profile(torch, fam, lambda: cnn_forward(params, x, ctx), fwd)

    # exact mode as the Table IV reference runs it (the exact family's
    # row): models/cnn.py sends only bit_exact and hardware convs to
    # cim_conv2d, as the reference does, so this forward is im2col +
    # cim_linear's fake-quant and a float matmul, no port kernel;
    # conv_mxu_fused's path is cim_conv2d in exact mode (phase 8)
    ctx = CiMContext(CiMParams(mode="exact", bits=8))
    with torch.no_grad():
        before = _launch_counts()
        ex = cnn_forward(params, x, ctx)
        delta = {n: c - before[n] for n, c in _launch_counts().items()
                 if c != before[n]}
        if delta:
            fail(f"table4 exact mode: one forward launched {delta}, "
                 "expected no port kernel (im2col + cim_linear)")
        if (ex.shape != (CNN_BATCH, 10) or not torch.isfinite(ex).all()
                or t4.top1_top5(ex, ys) != ref["exact"]):
            fail(f"table4 exact mode: logits not finite or top-1/top-5 "
                 f"{t4.top1_top5(ex, ys)} != the reference row "
                 f"{ref['exact']}")
        print(f"  exact mode, n={CNN_BATCH}: im2col + fake-quant + float "
              f"matmul, no port kernel; top-1/top-5 "
              f"{t4.top1_top5(ex, ys)} as the reference row", flush=True)
    print(f"  phase 7 took {time.perf_counter() - t0:.1f}s", flush=True)
    return launches, hw


# ---------------------------------------------------------------------------
# phase 8: surrogate, the compiler's default mode
# ---------------------------------------------------------------------------


def _macro_variance(torch, x, w, gp):
    """var[out] of the fused surrogate kernel, in f64 from the exact
    pieces: c0 K s^2 + c1 SQ s^2 over the operands as the kernel
    quantizes them."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import quantize_tile

    sx, sw = ops._scales(x, w, gp.bits)
    qmax = (1 << (gp.bits - 1)) - 1
    a = quantize_tile(x, sx, qmax).double()
    b = quantize_tile(w, sw.reshape(1, -1), qmax).double()
    s2 = (sx.double() * sw.double().reshape(1, -1)) ** 2
    return gp.c0 * x.shape[-1] * s2 + gp.c1 * ((a * a) @ (b * b)) * s2


def surrogate_macro(torch):
    """The quickstart's macro on the card: warmup at the LM shapes, then
    matmul with and without a key.  Returns its launch counts."""
    from repro_torch.core import approx_gemm as ag
    from repro_torch.core.approx_gemm import NoiseKey, plan_misses
    from repro_torch.core.compiler import CiMConfig, compile_macro
    from repro_torch.core.sram_model import SRAMConfig

    dev = torch.device("cuda")
    macro = compile_macro(CiMConfig(family="log_our", bits=8,
                                    sram=SRAMConfig(rows=64, cols=32,
                                                    banks=2),
                                    mode="surrogate"))
    gp = macro.gemm_params()
    print(f"  {macro.summary()}; (mu, c0, c1) = ({gp.mu}, {gp.c0}, "
          f"{gp.c1}); routes to "
          f"{macro.kernel_plan(64, 2048, 2048).entry.name} on the card",
          flush=True)
    _reset_counts()
    t = time.perf_counter()
    n = macro.warmup(MAIN_SHAPES)
    mark = plan_misses()
    print(f"  warmup: {n} shapes, deterministic and noisy plans, in "
          f"{time.perf_counter() - t:.1f}s", flush=True)
    for i, (m, k, n) in enumerate(MAIN_SHAPES):
        g = torch.Generator(device=dev).manual_seed(100 + i)
        x = torch.randn(m, k, generator=g, device=dev)
        w = torch.randn(k, n, generator=g, device=dev)
        det = macro.matmul(x, w)
        a = macro.matmul(x, w, key=NoiseKey(2))
        b = macro.matmul(x, w, key=NoiseKey(2))
        c = macro.matmul(x, w, key=NoiseKey(3))
        torch.cuda.synchronize()
        if plan_misses() != mark:
            fail(f"macro {(m, k, n)}: {plan_misses() - mark} plans built "
                 "after warmup")
        for t_ in (det, a, c):
            if t_.shape != (m, n) or not torch.isfinite(t_).all():
                fail(f"macro {(m, k, n)}: output not finite of shape {(m, n)}")
        if not torch.equal(a, b):
            fail(f"macro {(m, k, n)}: the same key gave another output")
        if torch.equal(a, c) or torch.equal(a, det):
            fail(f"macro {(m, k, n)}: a new key (or no key) gave the same "
                 "output")
        z = (a.double() - det.double()) / torch.sqrt(
            _macro_variance(torch, x, w, gp))
        mean, var = float(z.mean()), float(z.var())
        line = (f"  {str((m, k, n)):<18} same key same output, new key new "
                f"output; (out - det) / sqrt(var): mean {mean:+.5f}, "
                f"variance {var:.5f}")
        if m * n >= 1 << 17:
            lim_m = MOMENT_SIGMAS / (m * n) ** 0.5
            lim_v = MOMENT_SIGMAS * (2.0 / (m * n)) ** 0.5
            if abs(mean) > lim_m or abs(var - 1) > lim_v:
                fail(f"macro {(m, k, n)}: noise moments ({mean}, {var}) "
                     f"beyond ({lim_m}, 1 +- {lim_v})")
            line += f" (bounds |mean| <= {lim_m:.5f}, |var-1| <= {lim_v:.5f})"
        print(line, flush=True)
    launches = _launch_counts()
    # the card against the CPU's route (the dequantized dot and the
    # variance law over the dequantized operands) given the same eps
    m, k, n = MAIN_SHAPES[0]
    g = torch.Generator(device=dev).manual_seed(100)
    x = torch.randn(m, k, generator=g, device=dev)
    w = torch.randn(k, n, generator=g, device=dev)
    eps = ag.surrogate_noise(NoiseKey(2), (m, n), dev, "normal")
    card = macro.matmul(x, w, key=NoiseKey(2))
    cpu_plan = ag.plan_gemm(gp.family, gp.mode, gp.bits, m, k, n, "cpu",
                            spec=gp.routing_spec)
    cpu = ag._cim_core(gp, cpu_plan)(x.cpu(), w.cpu(), eps.cpu())
    diff = float((card.cpu() - cpu).abs().max())
    scale = float(cpu.abs().max())
    if diff > 1e-4 * scale:
        fail(f"macro {(m, k, n)}: card vs the CPU's {cpu_plan.entry.name} "
             f"given the same eps: max |d| {diff} > 1e-4 of {scale}")
    print(f"  {(m, k, n)} card vs the CPU's {cpu_plan.entry.name} given the "
          f"same eps: max |d| {diff:.3e} <= 1e-4 x max |out| {scale:.3e} "
          f"(f32 sum orders); launches {launches}", flush=True)
    return launches


def surrogate_conv(torch):
    """cim_conv2d at the CNN's five geometries in exact mode (the exact
    conv kernel) and in surrogate mode with a key (im2col + the noisy
    fused GEMM).  Returns its launch counts."""
    from repro_torch.core.approx_gemm import (GemmParams, NoiseKey,
                                              cim_conv2d)

    dev = torch.device("cuda")
    exact = GemmParams(family="exact", bits=8, mode="exact")
    mu, c0, c1 = SURR_COEFFS["log_our"]
    surr = GemmParams(family="log_our", bits=8, mode="surrogate", mu=mu,
                      c0=c0, c1=c1)
    # the main path's launches: the sum of each conv's own, read before
    # the comparison with the CPU launches the exact kernel again
    launches = {k: 0 for k in _launch_counts()}
    convs = []
    for i, (h, w, c, n) in enumerate(CNN_CONVS):
        g = torch.Generator(device=dev).manual_seed(200 + i)
        x = torch.randn(CNN_BATCH, h, w, c, generator=g, device=dev)
        w2 = torch.randn(9 * c, n, generator=g, device=dev) * 0.1
        convs.append((x, w2))
        _reset_counts()
        y = cim_conv2d(x, w2, exact)
        yn = cim_conv2d(x, w2, surr, NoiseKey(4))
        torch.cuda.synchronize()
        delta = {k: v for k, v in _launch_counts().items() if v}
        if delta != {"conv_mxu_fused": 1, "cim_gemm_fused": 1}:
            fail(f"cim_conv2d {(h, w, c, n)}: launched {delta}, expected one "
                 "conv_mxu_fused (exact) and one cim_gemm_fused (surrogate)")
        for k, v in delta.items():
            launches[k] += v
        # the card against the CPU's plain version on 16 of the images
        y16 = cim_conv2d(x[:16], w2, exact)
        ycpu = cim_conv2d(x[:16].cpu(), w2.cpu(), exact)
        if not torch.equal(y16.cpu(), ycpu):
            fail(f"cim_conv2d exact {(h, w, c, n)}: card != CPU")
        for t_ in (y, yn):
            if (t_.shape != (CNN_BATCH, h, w, n)
                    or not torch.isfinite(t_).all()):
                fail(f"cim_conv2d {(h, w, c, n)}: output not finite of "
                     f"shape {(CNN_BATCH, h, w, n)}")
    print(f"  cim_conv2d at the CNN's five geometries (batch {CNN_BATCH}): "
          f"exact mode one conv_mxu_fused launch each, equal to the CPU's "
          f"on 16 images; surrogate mode with a key one noisy "
          f"cim_gemm_fused each (im2col); launches {launches}", flush=True)

    # conv_mxu_fused's path end to end: the five exact-mode convs as one
    # run, on the host clock and under the profiler
    def five():
        for x_, w_ in convs:
            cim_conv2d(x_, w_, exact)

    five()
    torch.cuda.synchronize()
    t = time.perf_counter()
    five()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    print(f"  the five exact-mode convs (batch {CNN_BATCH}) as one run: "
          f"{1e3 * host_s:.3f} ms host clock", flush=True)
    med = _profile(torch, "exact", five, host_s)
    if med is not None:
        print(f"    conv_mxu_fused "
              f"{med['by_class'].get('CiM conv kernel', 0.0) / 1e3:.4f} ms "
              f"of {med['busy_ms']:.4f} ms busy", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 9: mesh-partitioned execution on a (data 2, model 2) gloo mesh
# ---------------------------------------------------------------------------

# four ranks on the one card (NCCL refuses two ranks on one GPU)
MESH_SHAPE = (2, 2)
# phase 9 serves qwen3-1.7b at its published widths, 8 of its 28 layers:
# its checks (integer lanes bitwise one device, the collectives' share a
# round) hold at any depth, and the gloo rounds are the script's slowest
MESH_LAYERS = 8
MESH_REQUESTS, MESH_SEED = 6, 0     # 2 exact, 2 balanced, 2 economy
# The exact lane (mode "exact", a float lane) runs its tensor-parallel
# layers as f32 partial products summed over the model axis and rounded
# once to bf16, and its column-parallel layers as narrower cuBLAS GEMMs:
# the same dots in another f32 order.  Now and then a layer output lands
# one bf16 ulp away; the lane fake-quantizes every activation per tensor
# to 127 levels, so that ulp can move a code by a whole level, and the 28
# layers mix such moves: the two runs end as two draws of the lane's
# quantization noise (measured on an H100: 7.7-10.8% of the step's
# largest |logit| before the first differing token).  `_exact_lane_codes`
# checks that mechanism on every run: every GEMM before the first moved
# code must stay within the f32 reassociation bound (on an H100 layer 0's
# outputs reach 0.17 of it and the first codes move at layer 1's wo, so
# the gap is that mechanism, and the measured gap leaves no room to
# tighten the bound below 2^-3).  Its logits are held
# to 2^-MESH_EXACT_LOG2 of the step's largest |logit| (12.5%, as
# tests/test_torch_lm.py holds the integer tiers to 4e-2 at |logits| ~0.3
# on the CPU for the same mechanism) up to each request's first differing
# token, and its tokens to the unsharded engine's wherever the top-2
# margin exceeds that; after a differing token the sequences differ.
MESH_EXACT_LOG2 = 3
# the GEMM cases of phase 9 (a): the exact family's nibble lane, the
# balanced tier's multiplier, the economy tier's, log_our, and bit_exact
MESH_GEMMS = [("exact (nibble)", dict(family="exact", mode="hardware")),
              ("appro42/orplane/10", dict(family="appro42", mode="hardware",
                                          compressor="orplane",
                                          n_approx_cols=10)),
              ("mitchell", dict(family="mitchell", mode="hardware")),
              ("log_our", dict(family="log_our", mode="hardware")),
              ("bit_exact", dict(family="appro42", mode="bit_exact",
                                 compressor="orplane", n_approx_cols=10))]
# the cim_linear GEMMs of one layer whose weight is contraction-sharded
# (wo, mlp_wo: the partial kernels) and output-sharded (the fused ones)
ROW_PARALLEL, COL_PARALLEL = 2, 5
# pool decode rounds a lane that every rank runs for rank 0's profiles:
# as many as `_profile` may make (3, and at most two made again), so
# that every rank issues the same collectives whichever profiles lose
# kernels
MESH_PROFILE_ROUNDS = 5
# phase 9 (d): the surrogate shard GEMMs' noise key (the same on every
# rank and on one device: it draws the global output's eps whole)
MESH_NOISE_SEED = 5
# phase 9 (f): the spec lane's depth and the sentinels' period
MESH_SPEC_K, MESH_SENTINEL_PERIOD = 1, 2
# (f): the mesh sentinel's NMED, sample for sample before the first trip,
# against the unsharded sentinel's (as many samples, the same trip
# flags).  Both score the same lane logits (an integer lane on the mesh
# is one device's bit for bit) against the per-token exact reference, a
# float lane whose row-parallel products the mesh sums in another order;
# the NMEDs are about 0.30 and an H100 run measured them 0.0019 apart,
# so they are held within 2^-7 absolute, a few times that
MESH_NMED_TOL = 2.0 ** -7


def _probe_exact_step(torch, eng, bound: bool):
    """Record every cim_linear call of the exact lane's first decode step
    on `eng` (installed after warmup): (name, x, out) as f32 numpy of
    this rank's shards and, with `bound` (the unsharded engine: whole
    operands), S = |fq(x)| @ |fq(w)|, the summed magnitudes of the
    fake-quantized product.  The step's cim_linear is wrapped where the
    qwen3 layers bind it (attention's wq/wk/wv/wo, the MLP's in
    models/common).  Returns the list it fills."""
    from repro_torch.core.quantization import fake_quant
    from repro_torch.models import attention, common

    rec = []
    lm = eng.lanes["exact"].backend.lm
    real, linear = lm.decode_step, common.cim_linear

    def probed(x, w, ctx, name="", bias=None):
        out = linear(x, w, ctx, name)
        s_ = None
        if bound:
            s_ = (fake_quant(x, 8).abs().float()
                  @ fake_quant(w, 8, axis=0).abs().float()).cpu().numpy()
        rec.append((name, x.float().cpu().numpy(),
                    out.float().cpu().numpy(), s_))
        return out if bias is None else out + bias

    def first_step(*a, **kw):
        lm.decode_step = real
        attention.cim_linear = common.cim_linear = probed
        res = real(*a, **kw)
        attention.cim_linear = common.cim_linear = linear
        return res

    lm.decode_step = first_step
    return rec


def _codes(torch, x):
    """The int8 codes and the scale the exact lane's fake quantization
    rounds a bf16 activation to (core.quantization.fake_quant, per
    tensor; the mesh's global max gives the same scale)."""
    from repro_torch.core.quantization import qmax, quant_scale

    t = torch.from_numpy(x).to(torch.bfloat16)
    scale = quant_scale(t, 8).to(t.dtype)
    return torch.clamp(torch.round(t / scale), -qmax(8), qmax(8)), scale


def _gather_probe(ranked, i):
    """Call i of the ranks' exact-step records, reassembled into the whole
    operands: rows over "data" (a rank's block of the pool), a
    row-parallel layer's input over "model" on K and a column-parallel
    layer's output over "model" on N."""
    by = {(o["coords"]["data"], o["coords"]["model"]): o["probe"][i]
          for o in ranked}
    name = by[(0, 0)][0]
    row_par = name in ("wo", "mlp_wo")
    xs, outs = [], []
    for dd in range(MESH_SHAPE[0]):
        parts = [by[(dd, m)] for m in range(MESH_SHAPE[1])]
        xs.append(np.concatenate([p[1] for p in parts], axis=-1)
                  if row_par else parts[0][1])
        outs.append(parts[0][2] if row_par
                    else np.concatenate([p[2] for p in parts], axis=-1))
    return name, np.concatenate(xs, axis=0), np.concatenate(outs, axis=0)


def _exact_lane_codes(torch, base_probe, ranked, n_layers):
    """C1's check: walk the exact lane's first decode step GEMM by GEMM,
    the mesh (reassembled) against the unsharded engine.  Before the
    first GEMM whose fake-quantized input codes (or scale) differ, both
    multiply the same codes, so their outputs may differ only by the
    f32 reassociation of the dot and the final bf16 rounding: per output
    |d| <= 2 K 2^-24 S + ulp_bf16(|out|), S the summed magnitudes of the
    dequantized products (each side's f32 sum is within K 2^-24 S of the
    exact one).  A GEMM beyond that bound with no code moved before it
    is a fault of `_float_tp`.  Prints the first moved code and, per
    layer before it, the largest |d| of the pre-quantization inputs and
    of the outputs against the bound."""
    n = len(base_probe)
    if n != len(ranked[0]["probe"]) or n != GEMMS_PER_LAYER * n_layers:
        fail(f"phase 9: the exact step's records hold {n} and "
             f"{len(ranked[0]['probe'])} GEMMs, expected "
             f"{GEMMS_PER_LAYER * n_layers}")
    per_layer, first, worst_ratio = {}, None, 0.0
    for i, (name, xs_, out_s, S) in enumerate(base_probe):
        name_m, xm, out_m = _gather_probe(ranked, i)
        if name_m != name or xm.shape != xs_.shape or \
                out_m.shape != out_s.shape:
            fail(f"phase 9: exact-step GEMM {i}: {name_m} {xm.shape} on the "
                 f"mesh, {name} {xs_.shape} unsharded")
        layer = i // GEMMS_PER_LAYER
        dx = float(np.abs(xs_ - xm).max())
        qs, ss = _codes(torch, xs_)
        qm, sm = _codes(torch, xm)
        moved = int((qs != qm).sum())
        if moved or not torch.equal(ss, sm):
            rows = sorted({int(r) for r in
                           torch.nonzero(qs != qm)[:, 0].tolist()})
            first = (layer, name, moved, qs.numel(), float(ss), float(sm),
                     dx, float(np.abs(xs_).max()), rows)
            break
        k = xs_.shape[-1]
        mag = np.maximum(np.abs(out_s), np.abs(out_m))
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
        bound = 2 * k * 2.0 ** -24 * S.reshape(out_s.shape) + ulp
        dout = np.abs(out_s - out_m)
        ratio = float((dout / bound).max())
        worst_ratio = max(worst_ratio, ratio)
        lx, lo, lr = per_layer.get(layer, (0.0, 0.0, 0.0))
        per_layer[layer] = (max(lx, dx), max(lo, float(dout.max())),
                            max(lr, ratio))
        if ratio > 1.0:
            fail(f"phase 9: exact lane decode step 0, layer {layer} {name}: "
                 f"the same codes on both sides, yet the outputs differ by "
                 f"{float(dout.max()):.3e}, {ratio:.2f}x the f32 "
                 "reassociation bound (a fault of _float_tp)")
    print("  exact lane, decode step 0, mesh (rank-reassembled) against "
          "unsharded, per layer before the first moved code: max |d "
          "pre-quantization input|, max |d output|, largest |d output| / "
          "reassociation bound: " + "; ".join(
              f"L{l} {dx:.2e} {do:.2e} {r:.2f}"
              for l, (dx, do, r) in sorted(per_layer.items())), flush=True)
    if first is None:
        print("  exact lane, decode step 0: no quantization code moved in "
              f"its {n} GEMMs; every output within the bound (largest "
              f"ratio {worst_ratio:.2f})", flush=True)
    else:
        (layer, name, moved, total, ss, sm, dx, xmax, rows) = first
        print(f"  exact lane, decode step 0: the first moved code is at "
              f"layer {layer} GEMM {name}: {moved} of {total} codes (pool "
              f"rows {rows}), scale {sm!r} on the mesh, {ss!r} unsharded; "
              f"its input differs by up to {dx:.3e} (|x| up to "
              f"{xmax:.3f}); every GEMM before it within the reassociation "
              f"bound (largest ratio {worst_ratio:.2f})", flush=True)
    return first


def _mesh_config():
    """qwen3-1.7b at its widths, cut to MESH_LAYERS layers."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-1.7b")
    return dataclasses.replace(cfg, n_layers=MESH_LAYERS,
                               n_periods=MESH_LAYERS)


def _mesh_engine(cfg, mesh=None, mode: str = "hardware", tiers=None,
                 **kw):
    """Phase 9's engines, every one at `cfg`'s depth: the `mode` ladder
    (or `tiers`), 4 slots a lane, the same buckets and seed; `kw` the
    spec, sentinel and telemetry options of (e)-(g)."""
    from repro_torch.serving import build_engine, build_tiers

    kw.setdefault("record_logits", True)
    return build_engine(cfg, tiers=tiers or build_tiers(mode=mode),
                        slots_per_tier=4, max_len=32, prompt_buckets=(8,),
                        group_buckets=(1, 2, 4), seed=0, mesh=mesh, **kw)


def _mesh_spec_engine(cfg, mesh=None):
    """(f)'s engine: the hardware ladder with a spec lane (k = MESH_SPEC_K)
    and a sentinel on each approximate lane (period MESH_SENTINEL_PERIOD);
    each sentinel's samples and probes logged in order."""
    from repro_torch.serving import SentinelConfig

    eng = _mesh_engine(cfg, mesh, spec_decode=MESH_SPEC_K,
                       sentinel_cfg=SentinelConfig(
                           period=MESH_SENTINEL_PERIOD),
                       record_logits=False)
    log = []
    for name, lane in eng.lanes.items():
        sen = lane.sentinel
        if sen is None:
            continue

        def observed(*a, _sen=sen, _obs=sen.observe, _name=name, **kw):
            tripped = _obs(*a, **kw)
            log.append((_name, "sample", _sen.last_agree, _sen.last_nmed,
                        tripped))
            return tripped

        def probed(*a, _probe=sen.probe, _name=name, **kw):
            ok = _probe(*a, **kw)
            log.append((_name, "probe", ok))
            return ok

        sen.observe, sen.probe = observed, probed
    return eng, log


def _per_token_exact_engine(cfg, mesh=None):
    """The spec lane's contract engine: the per-token exact rung alone."""
    from repro_torch.serving import build_tiers
    from repro_torch.serving.tiers import spec_pair

    _, v_tier = spec_pair(build_tiers(mode="hardware"))
    return _mesh_engine(cfg, mesh, tiers=(v_tier,), record_logits=False)


def _macs_by_family(tel, mac0):
    """The dispatch MACs a run added, by family."""
    out = {}
    for key, v in tel.dispatch_macs.values.items():
        fam = dict(key)["family"]
        out[fam] = out.get(fam, 0.0) + v - mac0.get(key, 0.0)
    return out


def _digest(res) -> str:
    import hashlib

    h = hashlib.sha256()
    for rid in sorted(res):
        for lg in res[rid].logits:
            h.update(np.asarray(lg, np.float32).tobytes())
    return h.hexdigest()


def _round_times(torch, eng, mesh=None, reps: int = 3):
    """Per lane: one pool decode round on the host clock (mean of `reps`,
    ending in a synchronize) and, on a mesh, the collectives' seconds
    and calls a round."""
    out = {}
    for name, lane in eng.lanes.items():
        b = lane.backend
        b.reset()
        torch.cuda.synchronize()
        c0 = dict(mesh.comm) if mesh is not None else None
        t = time.perf_counter()
        for _ in range(reps):
            b.decode_round()
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t) / reps
        comm = ((mesh.comm["seconds"] - c0["seconds"]) / reps,
                (mesh.comm["calls"] - c0["calls"]) / reps) if c0 else None
        out[name] = (secs, comm)
        b.reset()
    return out


def _mesh_profiles(torch, eng, rank, lanes=None):
    """Per lane (of `lanes`, every lane by default) MESH_PROFILE_ROUNDS
    pool decode rounds on every rank (the collectives need all four),
    rank 0's each under torch.profiler (`_profile_once`); returns rank
    0's records by lane (empty lists on the other ranks)."""
    out = {}
    for name, lane in eng.lanes.items():
        if lanes is not None and name not in lanes:
            continue
        b = lane.backend
        b.reset()
        out[name] = []
        for _ in range(MESH_PROFILE_ROUNDS):
            if rank == 0:
                out[name].append(_profile_once(torch, b.decode_round))
            else:
                b.decode_round()
        torch.cuda.synchronize()
        b.reset()
    return out


def _spec_calls(torch, eng, mesh, rank, reps: int = 3):
    """The spec lane's one-sub-round call (an idle pool: k drafter steps
    and one verify) on the host clock, mean of `reps` ending in a
    synchronize, with the collectives' seconds and calls a call; then
    MESH_PROFILE_ROUNDS calls on every rank, rank 0's profiled."""
    b = eng.lanes["exact"].backend
    zero = np.zeros(b.n_slots, np.int64)
    none = np.full(b.n_slots, -1, np.int64)
    b.reset()
    torch.cuda.synchronize()
    c0 = dict(mesh.comm)
    t = time.perf_counter()
    for _ in range(reps):
        b.spec_round(zero, none)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t) / reps
    comm = ((mesh.comm["seconds"] - c0["seconds"]) / reps,
            (mesh.comm["calls"] - c0["calls"]) / reps)
    recs = []
    for _ in range(MESH_PROFILE_ROUNDS):
        if rank == 0:
            recs.append(_profile_once(torch, lambda: b.spec_round(zero,
                                                                  none)))
        else:
            b.spec_round(zero, none)
    torch.cuda.synchronize()
    b.reset()
    return (secs, comm), recs


def _mesh_surrogate_gemms(torch, mesh, dev):
    """(d): every LM GEMM shape in both layouts, the balanced tier's
    surrogate with and without a noise key, through the shard route
    (`surrogate_shard_matmul`, what `cim_linear` calls on shards): this
    rank's block bitwise the same block of one device's `model_matmul`
    (the fused kernel, noise included), the row-parallel partial bitwise
    its plain version, and every kernel launch on the rank's K_l x N_l
    shard.  Returns the mismatches, the launches (counted from 0, before
    the one-device calls), the shapes the kernels saw and the seconds."""
    from repro_torch.core import approx_gemm as ag
    from repro_torch.core.compiler import CiMConfig
    from repro_torch.kernels import cim_gemm
    from repro_torch.models.common import CiMParams
    from repro_torch.parallel.sharding import P, shard

    gp = CiMParams.from_config(CiMConfig(
        family="appro42", bits=8, mode="surrogate", compressor="orplane",
        n_approx_cols=10)).gemm_params()
    layouts = (("col", P("data", None), P(None, "model")),
               ("row", P("data", "model"), P("model", None)))
    seen, bad, got = [], [], {}
    real = {n: getattr(cim_gemm, n) for n in ("cim_gemm_fused",
                                              "cim_gemm_partial")}

    def spy(n):
        def call(x, w, *a, **kw):
            seen.append((n, tuple(w.shape)))
            return real[n](x, w, *a, **kw)
        return call

    _reset_counts()
    t = time.perf_counter()
    for n in real:
        setattr(cim_gemm, n, spy(n))
    try:
        for shape in MAIN_SHAPES:
            m, k, n = shape
            g = torch.Generator(device=dev).manual_seed(m * 7 + k + n)
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            w = (torch.randn(k, n, generator=g, device=dev) * 0.02).to(
                torch.bfloat16)
            for lname, xs, ws in layouts:
                xl, wl = shard(x, xs, mesh), shard(w, ws, mesh)
                for seed in (None, MESH_NOISE_SEED):
                    key = None if seed is None else ag.NoiseKey(seed)
                    y = ag.surrogate_shard_matmul(xl, wl, gp, key, mesh=mesh,
                                                  x_spec=xs, w_spec=ws)
                    got[(shape, lname, seed)] = (y, x, w, xs, ws, xl, wl)
    finally:
        for n, fn in real.items():
            setattr(cim_gemm, n, fn)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = _launch_counts()
    for (shape, lname, seed), (y, x, w, xs, ws, xl, wl) in got.items():
        key = None if seed is None else ag.NoiseKey(seed)
        want = shard(ag.model_matmul(x, w, gp, key), (xs[0], ws[1]), mesh)
        if not torch.equal(y, want):
            bad.append(f"(d) surrogate {shape} {lname} key {seed}: max |d| "
                       f"{float((y.float() - want.float()).abs().max())}")
        if lname == "row":
            sx = ag.scale_from_max(ag._global_max(xl, mesh, ("data",
                                                             "model")), 8)
            sw = ag.scale_from_max(ag._global_colmax(wl, mesh, ("model",)),
                                   8)
            for sq in (False, True):
                if not torch.equal(
                        cim_gemm.cim_gemm_partial(xl, wl, sx, sw, sq),
                        cim_gemm.cim_gemm_partial_plain(xl, wl, sx, sw, sq)):
                    bad.append(f"(d) cim_gemm_partial {shape} need_sq={sq}: "
                               "kernel != plain version")
    want_shapes = ({("cim_gemm_fused", (k, n // MESH_SHAPE[1]))
                    for _, k, n in MAIN_SHAPES}
                   | {("cim_gemm_partial", (k // MESH_SHAPE[1], n))
                      for _, k, n in MAIN_SHAPES})
    if set(seen) != want_shapes:
        bad.append(f"(d) the kernels saw weights {sorted(set(seen))}, "
                   f"expected the shards {sorted(want_shapes)}")
    return bad, launches, sorted(set(seen)), secs


def _mesh_rank(rank, world, dev, wl):
    """One rank of phase 9: (a) the GEMM frontends, (b) the conv frontend,
    (c) the hardware ladder served on the mesh, then its decode rounds
    timed and profiled (rank 0); (d) the surrogate shard GEMMs, (e) the
    surrogate ladder served with (g) the telemetry attached, its
    approximate lanes' rounds timed and profiled, (f) the spec lane and
    the sentinels on the hardware ladder and the per-token exact engine,
    a spec call timed and profiled; each part's main-path launches
    counted from 0, the single-device calls it is compared with made
    after."""
    import torch

    from repro_torch.core import approx_gemm as ag
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import P
    from repro_torch.serving import SimClock

    t_rank = time.perf_counter()
    mesh = make_host_mesh(MESH_SHAPE[1])
    out = {"coords": dict(mesh.coords), "bad": []}
    layouts = (("K", P("data", "model"), P("model", None)),
               ("N", P("data", None), P(None, "model")))

    # (a) cim_matmul and model_matmul at the eight LM shapes
    inputs, got = {}, {}
    _reset_counts()
    t = time.perf_counter()
    for shape in MAIN_SHAPES:
        m, k, n = shape
        g = torch.Generator(device=dev).manual_seed(m * 3 + k + n)
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        inputs[shape] = (x, w)
        for label, kw in MESH_GEMMS:
            gp = ag.GemmParams(bits=8, **kw)
            for lname, xs, ws in layouts:
                for fe, fn in (("cim", ag.cim_matmul),
                               ("model", ag.model_matmul)):
                    got[(shape, label, lname, fe)] = fn(
                        x, w, gp, mesh=mesh, x_spec=xs, w_spec=ws)
    torch.cuda.synchronize()
    out["gemm_s"] = time.perf_counter() - t
    out["gemm_launches"] = _launch_counts()
    for (shape, label, lname, fe), y in got.items():
        x, w = inputs[shape]
        gp = ag.GemmParams(bits=8, **dict(MESH_GEMMS)[label])
        want = (ag.cim_matmul if fe == "cim" else ag.model_matmul)(x, w, gp)
        if not torch.equal(y, want):
            out["bad"].append(f"(a) {fe}_matmul {label} {shape} {lname}: "
                              f"max |d| {float((y - want).abs().max())}")
    del got, inputs

    # (b) cim_conv2d at the CNN's five geometries, the batch on "data"
    got, raised = {}, {}
    _reset_counts()
    t = time.perf_counter()
    for gi, (h, w_, c, n) in enumerate(CNN_CONVS):
        g = torch.Generator(device=dev).manual_seed(17 * gi + 1)
        x4 = torch.randn(CNN_BATCH, h, w_, c, generator=g, device=dev)
        w2 = torch.randn(9 * c, n, generator=g, device=dev) * 0.1
        for fam in FAMS:
            gp = ag.GemmParams(family=fam, bits=8, mode="hardware")
            for lname, ws in (("C", P("model", None)),
                              ("N", P(None, "model"))):
                kw = dict(mesh=mesh, x_spec=P("data", None, None, None),
                          w_spec=ws)
                if (c if lname == "C" else n) % MESH_SHAPE[1]:
                    try:
                        ag.cim_conv2d(x4, w2, gp, **kw)
                        raised[(gi, fam, lname)] = "no error"
                    except ValueError as err:
                        raised[(gi, fam, lname)] = str(err)
                    continue
                got[(gi, fam, lname)] = (ag.cim_conv2d(x4, w2, gp, **kw),
                                         x4, w2)
    torch.cuda.synchronize()
    out["conv_s"] = time.perf_counter() - t
    out["conv_launches"] = _launch_counts()
    out["conv_raised"] = raised
    for (gi, fam, lname), (y, x4, w2) in got.items():
        want = ag.cim_conv2d(x4, w2, ag.GemmParams(family=fam, bits=8,
                                                   mode="hardware"))
        if not torch.equal(y, want):
            out["bad"].append(f"(b) cim_conv2d {fam} conv {gi + 1} {lname}: "
                              f"max |d| {float((y - want).abs().max())}")
    del got

    # (c) the hardware ladder on qwen3-1.7b at its widths
    cfg = _mesh_config()
    t = time.perf_counter()
    eng = _mesh_engine(cfg, mesh)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t
    out["gib"] = torch.cuda.memory_allocated() / 2 ** 30
    t = time.perf_counter()
    out["warm_shapes"] = eng.warmup()
    torch.cuda.synchronize()
    out["warm_s"] = time.perf_counter() - t
    forwards = _count_forwards(eng)
    out["probe"] = _probe_exact_step(torch, eng, bound=False)
    _reset_counts()
    comm0 = dict(mesh.comm)
    t = time.perf_counter()
    res = eng.run(wl, clock=SimClock())
    torch.cuda.synchronize()
    out["serve_s"] = time.perf_counter() - t
    out["serve_comm"] = (mesh.comm["seconds"] - comm0["seconds"],
                         mesh.comm["calls"] - comm0["calls"])
    out["serve_launches"] = _launch_counts()
    out["forwards"] = dict(forwards)
    out["misses"] = eng.steady_plan_misses()
    out["tokens"] = {rid: r.tokens for rid, r in res.items()}
    out["tiers"] = {rid: r.tier for rid, r in res.items()}
    out["digest"] = _digest(res)
    if rank == 0:
        out["logits"] = {rid: [np.asarray(lg, np.float32)
                               for lg in r.logits]
                         for rid, r in res.items()}
    out["rounds"] = _round_times(torch, eng, mesh)
    out["profiles"] = _mesh_profiles(torch, eng, rank)
    out["c_s"] = time.perf_counter() - t_rank
    del eng, res
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the surrogate shard GEMMs
    t = time.perf_counter()
    bad, out["surr_gemm_launches"], out["surr_seen"], out["surr_gemm_s"] = \
        _mesh_surrogate_gemms(torch, mesh, dev)
    out["bad"] += bad
    out["d_s"] = time.perf_counter() - t

    # (e) the surrogate ladder on the mesh, (g) with the telemetry
    from repro_torch.obs import EngineTelemetry, chrome_trace, prometheus_text

    t = time.perf_counter()
    tel = EngineTelemetry()
    eng = _mesh_engine(cfg, mesh, mode="surrogate", telemetry=tel)
    eng.warmup()
    forwards = _count_forwards(eng)
    mac0 = dict(tel.dispatch_macs.values)
    met0 = sum(m.macs for m in tel.meters.values())
    _reset_counts()
    comm0 = dict(mesh.comm)
    t_serve = time.perf_counter()
    res = eng.run(wl, clock=SimClock())
    torch.cuda.synchronize()
    out["surr_serve_s"] = time.perf_counter() - t_serve
    out["surr_comm"] = (mesh.comm["seconds"] - comm0["seconds"],
                        mesh.comm["calls"] - comm0["calls"])
    out["surr_launches"] = _launch_counts()
    out["surr_forwards"] = dict(forwards)
    out["surr_misses"] = eng.steady_plan_misses()
    out["surr_tokens"] = {rid: r.tokens for rid, r in res.items()}
    out["surr_tiers"] = {rid: r.tier for rid, r in res.items()}
    out["surr_digest"] = _digest(res)
    if rank == 0:
        out["surr_logits"] = {rid: [np.asarray(lg, np.float32)
                                    for lg in r.logits]
                              for rid, r in res.items()}
    out["macs"] = _macs_by_family(tel, mac0)
    out["meters"] = sum(m.macs for m in tel.meters.values()) - met0
    if rank == 0:
        out["prometheus"] = prometheus_text(tel.registry)
        out["trace"] = chrome_trace(tel.registry.spans.items(),
                                    tid_names=tel.tid_names)
    tel.detach()
    out["surr_rounds"] = _round_times(torch, eng, mesh)
    out["surr_profiles"] = _mesh_profiles(torch, eng, rank,
                                          ("balanced", "economy"))
    out["e_s"] = time.perf_counter() - t
    del eng, res
    gc.collect()
    torch.cuda.empty_cache()

    # (f) spec decoding and sentinels on the mesh, and the contract engine
    t = time.perf_counter()
    eng, log = _mesh_spec_engine(cfg, mesh)
    eng.warmup()
    _reset_counts()
    res = eng.run(wl, clock=SimClock())
    torch.cuda.synchronize()
    out["spec_launches"] = _launch_counts()
    out["spec_serve_s"] = time.perf_counter() - t
    out["spec"] = {rid: (r.tier, r.status, r.tokens)
                   for rid, r in res.items()}
    out["spec_misses"] = eng.steady_plan_misses()
    out["sentinel_log"] = log
    out["trips"] = [(e.lane, e.t, e.reason, e.tokens_before_trip)
                    for e in eng.trip_log]
    sb = eng.lanes["exact"].backend
    out["spec_stats"] = (sb.n_rounds, sb.n_drafted, sb.n_accepted,
                         sb.n_emitted)
    out["spec_call"], out["spec_profiles"] = _spec_calls(torch, eng, mesh,
                                                         rank)
    del eng, res
    gc.collect()
    torch.cuda.empty_cache()
    eng = _per_token_exact_engine(cfg, mesh)
    eng.warmup()
    res = eng.run([dataclasses.replace(r, tier="exact") for r in wl],
                  clock=SimClock())
    out["per_token"] = {rid: r.tokens for rid, r in res.items()}
    out["per_token_misses"] = eng.steady_plan_misses()
    out["f_s"] = time.perf_counter() - t
    del eng, res
    out["rank_s"] = time.perf_counter() - t_rank
    return out


def _served_against_unsharded(part, mine, tiers, base_tiers, base_tokens,
                              base_logits):
    """Rank 0's served run (`mine`: tokens and logits by request, `tiers`
    by request) against the unsharded engine's: the integer (or
    surrogate) lanes' tokens identical and logits bitwise, the exact lane
    (float tensor parallelism) within 2^-MESH_EXACT_LOG2 of the step's
    largest |logit| up to each request's first differing token, and its
    tokens equal wherever the unsharded top-2 margin exceeds that.
    Returns the exact lane's (request, step, max |d|, tolerance, margin,
    same token) and the largest |d| by lane."""
    first_diff = None
    worst = {}
    exact_steps = []
    for rid, tier in base_tiers.items():
        if tiers[rid] != tier:
            fail(f"phase 9 {part}: request {rid} served on {tiers[rid]}, "
                 f"unsharded on {tier}")
        for step, (a, b) in enumerate(zip(mine["logits"][rid],
                                          base_logits[rid])):
            d = np.abs(a - b)
            worst[tier] = max(worst.get(tier, 0.0), float(d.max()))
            if tier == "exact":
                top = np.sort(b)[-2:]
                same = int(a.argmax()) == int(b.argmax())
                exact_steps.append((
                    rid, step, float(d.max()),
                    2.0 ** -MESH_EXACT_LOG2 * float(np.abs(b).max()),
                    float(top[1] - top[0]), same))
                if not same:
                    break           # the sequences differ from here on
                continue
            if d.max() > 0 and first_diff is None:
                j = int(d.argmax())
                first_diff = (rid, tier, step, j, float(a[j]), float(b[j]))
        if tier != "exact" and mine["tokens"][rid] != base_tokens[rid]:
            fail(f"phase 9 {part}: {tier} request {rid} tokens "
                 f"{mine['tokens'][rid]} != unsharded {base_tokens[rid]}")
    for r, st, d, tol, mg, same in exact_steps:
        if d > tol:
            fail(f"phase 9 {part}: exact lane request {r} step {st}: logits "
                 f"{d:.3e} from the unsharded engine's, beyond {tol:.3e}")
        if mg > tol and not same:
            fail(f"phase 9 {part}: exact lane request {r} step {st}: another "
                 f"token past the tolerance margin ({mg:.3e} > {tol:.3e})")
    if first_diff is not None:
        fail(f"phase 9 {part}: approximate-lane logits not bitwise equal to "
             f"the unsharded engine's: first at request {first_diff[0]} "
             f"({first_diff[1]}) step {first_diff[2]} logit {first_diff[3]}: "
             f"{first_diff[4]} vs {first_diff[5]}; max |d| by lane {worst}")
    return exact_steps, worst


def _prometheus_macs(text: str):
    """`repro_dispatch_macs_total` by family from a Prometheus text
    exposition; fails on a sample line that does not parse."""
    import re

    line_re = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? '
                         r'([-+0-9.eE]+|NaN|[+-]Inf)$')
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        m = line_re.match(ln)
        if m is None:
            fail(f"phase 9 (g): Prometheus line does not parse: {ln!r}")
        if m.group(1) == "repro_dispatch_macs_total":
            labels = dict(kv.split("=", 1) for kv in m.group(3).split(","))
            fam = labels["family"].strip('"')
            out[fam] = out.get(fam, 0.0) + float(m.group(4))
    return out


def _mesh_unsharded(torch, cfg, wl):
    """(e)-(g)'s one-device runs: the surrogate ladder with the telemetry
    (tokens, logits, its run's MACs by family and the meters', a decode
    round a lane), then the spec + sentinel engine (its sentinel log,
    trips and tokens).  Returns them and the seconds each took."""
    from repro_torch.obs import EngineTelemetry
    from repro_torch.serving import SimClock

    out = {}
    t = time.perf_counter()
    tel = EngineTelemetry()
    eng = _mesh_engine(cfg, mode="surrogate", telemetry=tel)
    eng.warmup()
    mac0 = dict(tel.dispatch_macs.values)
    met0 = sum(m.macs for m in tel.meters.values())
    res = eng.run(wl, clock=SimClock())
    torch.cuda.synchronize()
    out["macs"] = _macs_by_family(tel, mac0)
    out["meters"] = sum(m.macs for m in tel.meters.values()) - met0
    tel.detach()
    out["tokens"] = {rid: r.tokens for rid, r in res.items()}
    out["logits"] = {rid: [np.asarray(lg, np.float32) for lg in r.logits]
                     for rid, r in res.items()}
    out["tiers"] = {rid: r.tier for rid, r in res.items()}
    out["rounds"] = _round_times(torch, eng)
    out["surr_s"] = time.perf_counter() - t
    del eng, res
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    eng, log = _mesh_spec_engine(cfg)
    eng.warmup()
    res = eng.run(wl, clock=SimClock())
    torch.cuda.synchronize()
    out["sentinel_log"] = log
    out["trips"] = [(e.lane, e.t, e.reason, e.tokens_before_trip)
                    for e in eng.trip_log]
    out["spec"] = {rid: (r.tier, r.status, r.tokens)
                   for rid, r in res.items()}
    out["spec_s"] = time.perf_counter() - t
    del eng, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _before_first_trip(log):
    """The sentinel samples up to and including the first that tripped."""
    out = []
    for e in log:
        if e[1] != "sample":
            continue
        out.append(e)
        if e[4]:
            break
    return out


def _mesh_surrogate_checks(torch, ranked, cfg, one, power):
    """(d), (e) and (g) over the ranks' results: see `_mesh_rank`."""
    n_calls = len(MAIN_SHAPES) * 2           # with and without a key
    for r, o in enumerate(ranked):
        gl = {k: v for k, v in o["surr_gemm_launches"].items() if v}
        if gl != {"cim_gemm_fused": n_calls, "cim_gemm_partial": n_calls}:
            fail(f"phase 9 (d) rank {r}: the shard GEMMs launched {gl}, "
                 f"expected {n_calls} cim_gemm_fused and {n_calls} "
                 "cim_gemm_partial")
        if o["surr_misses"]:
            fail(f"phase 9 (e) rank {r}: {o['surr_misses']} plan misses "
                 "after warmup")
        if o["surr_digest"] != ranked[0]["surr_digest"]:
            fail(f"phase 9 (e) rank {r}: its logits differ from rank 0's")
        fw = o["surr_forwards"]
        approx = fw["balanced"] + fw["economy"]
        want = {"cim_gemm_fused": COL_PARALLEL * cfg.n_layers * approx,
                "cim_gemm_partial": ROW_PARALLEL * cfg.n_layers * approx}
        sl = {k: v for k, v in o["surr_launches"].items() if v}
        if sl != want:
            fail(f"phase 9 (e) rank {r}: serving launched {sl}, expected "
                 f"{want} (forwards {fw})")
        if o["macs"] != one["macs"]:
            fail(f"phase 9 (g) rank {r}: dispatch MACs by family "
                 f"{o['macs']} != the unsharded engine's {one['macs']}")
        if o["meters"] != sum(o["macs"].values()):
            fail(f"phase 9 (g) rank {r}: the meters' MACs {o['meters']} != "
                 f"the live dispatch MACs {sum(o['macs'].values())}")
        print(f"  rank {r}: (d) {o['d_s']:.1f}s (shard GEMMs "
              f"{o['surr_gemm_s']:.1f}s), launches {gl}; (e) "
              f"{o['e_s']:.1f}s, served in {o['surr_serve_s']:.1f}s "
              f"(collectives {o['surr_comm'][0]:.2f}s, {o['surr_comm'][1]} "
              f"calls), forwards {fw}, launches {sl}; (f) {o['f_s']:.1f}s; "
              f"rank {o['rank_s']:.1f}s", flush=True)
        for lane, (secs, (cs, calls)) in o["surr_rounds"].items():
            print(f"    (e) {lane:<9} surrogate decode round (2 of 4 slots) "
                  f"{1e3 * secs:.1f} ms, collectives {1e3 * cs:.1f} ms "
                  f"({100 * cs / secs:.1f}%, {calls:.0f} calls); unsharded "
                  f"{1e3 * one['rounds'][lane][0]:.1f} ms", flush=True)
    print(f"  (d) every rank's kernels saw only its shards: "
          f"{ranked[0]['surr_seen']}; the shard GEMMs (8 LM shapes x 2 "
          "layouts, with and without a key) bitwise one device's "
          "cim_gemm_fused, the partial bitwise its plain version",
          flush=True)
    mine = ranked[0]
    view = {"tokens": mine["surr_tokens"], "logits": mine["surr_logits"]}
    exact_steps, worst = _served_against_unsharded(
        "(e)", view, mine["surr_tiers"], one["tiers"], one["tokens"],
        one["logits"])
    same = sum(mine["surr_tokens"][r] == one["tokens"][r]
               for r in one["tokens"])
    print(f"  (e) the surrogate ladder on the mesh: balanced and economy "
          f"tokens identical and logits bitwise the unsharded engine's; "
          f"exact lane max |d logit| {worst.get('exact')} up to its first "
          f"differing token (tolerance 2^-{MESH_EXACT_LOG2} of the step's "
          f"largest), {same} of {len(one['tokens'])} requests' tokens "
          f"identical; 0 plan misses on every rank; on {power}", flush=True)
    print("  rank 0, one surrogate pool decode round a lane under "
          "torch.profiler (every rank decoding):", flush=True)
    for lane, recs in mine["surr_profiles"].items():
        _profile(torch, lane, None, mine["surr_rounds"][lane][0], made=recs)
    prom = _prometheus_macs(mine["prometheus"])
    if not prom:
        fail("phase 9 (g): no repro_dispatch_macs_total in rank 0's text")
    trace = json.loads(json.dumps(mine["trace"]))
    kinds = sorted({e["name"] for e in trace["traceEvents"]
                    if e.get("ph") == "X"})
    if not kinds:
        fail("phase 9 (g): rank 0's Chrome trace holds no span")
    print(f"  (g) rank 0's run dispatch MACs by family {mine['macs']} = the "
          f"unsharded engine's = the meters' {mine['meters']:.0f} (every "
          f"rank); its Prometheus text parses (dispatch MACs since start "
          f"{prom}), its Chrome trace loads back ({len(trace['traceEvents'])} "
          f"events, spans {kinds})", flush=True)


def _mesh_spec_checks(ranked, one, power):
    """(f) over the ranks' results: see `_mesh_rank`."""
    mine = ranked[0]
    for r, o in enumerate(ranked):
        if o["spec_misses"] or o["per_token_misses"]:
            fail(f"phase 9 (f) rank {r}: plan misses after warmup: spec "
                 f"engine {o['spec_misses']}, per-token exact engine "
                 f"{o['per_token_misses']}")
        failed = [rid for rid, (_, st, _) in o["spec"].items() if st != "ok"]
        if failed:
            fail(f"phase 9 (f) rank {r}: requests {failed} failed")
        for key in ("spec", "sentinel_log", "trips", "spec_stats"):
            if o[key] != mine[key]:
                fail(f"phase 9 (f) rank {r}: its {key} differs from rank 0's")
        for rid, (tier, _, toks) in o["spec"].items():
            if tier == "exact" and toks != o["per_token"][rid]:
                fail(f"phase 9 (f) rank {r}: request {rid} on the spec lane "
                     f"{toks} != the per-token exact engine's "
                     f"{o['per_token'][rid]}")
    on_exact = [rid for rid, (t, _, _) in mine["spec"].items()
                if t == "exact"]
    if not on_exact:
        fail("phase 9 (f): no request finished on the spec lane")
    mesh_s, one_s = (_before_first_trip(mine["sentinel_log"]),
                     _before_first_trip(one["sentinel_log"]))
    if not mesh_s:
        fail("phase 9 (f): no sentinel sample on the mesh")
    if len(mesh_s) != len(one_s):
        fail(f"phase 9 (f): {len(mesh_s)} sentinel samples up to the first "
             f"trip on the mesh, {len(one_s)} unsharded")
    pairs = list(zip(mesh_s, one_s))
    for (ml, _, ma, mn, mt), (ul, _, ua, un, ut) in pairs:
        if ml != ul or mt != ut or abs(mn - un) > MESH_NMED_TOL:
            fail(f"phase 9 (f): sentinel sample on {ml} NMED {mn:.4f} "
                 f"(tripped {mt}), unsharded on {ul} {un:.4f} (tripped "
                 f"{ut}): beyond {MESH_NMED_TOL} or another verdict")
    n_rounds, drafted, accepted, emitted = mine["spec_stats"]
    (secs, (cs, calls)) = mine["spec_call"]
    print(f"  (f) spec k = {MESH_SPEC_K} and sentinels (period "
          f"{MESH_SENTINEL_PERIOD}) on the mesh: {len(mine['spec'])} "
          f"requests, 0 failed, every rank the same tokens, "
          f"{len(mine['sentinel_log'])} sentinel events and trips "
          f"{mine['trips']} (unsharded {one['trips']}); requests {on_exact} "
          f"on the spec lane: tokens = the mesh per-token exact engine's; "
          f"{n_rounds} sub-rounds, acceptance {accepted / max(drafted, 1):.3f}"
          f", {emitted / max(n_rounds, 1):.2f} tokens a sub-round; no plan "
          f"misses; on {power}", flush=True)
    print("  (f) sentinel samples before the first trip, (lane, mesh NMED, "
          "unsharded NMED, mesh agree, unsharded agree): " + "; ".join(
              f"({m[0]}, {m[3]:.4f}, {u[3]:.4f}, {m[2]:.2f}, {u[2]:.2f})"
              for m, u in pairs) + f"; all within {MESH_NMED_TOL} "
          f"(max |d| {max([abs(m[3] - u[3]) for m, u in pairs] or [0]):.4f})",
          flush=True)
    print(f"  (f) one spec call (an idle pool: {MESH_SPEC_K} drafter step + "
          f"one verify) {1e3 * secs:.1f} ms on rank 0, collectives "
          f"{1e3 * cs:.1f} ms ({100 * cs / secs:.1f}%, {calls:.0f} calls); "
          "under torch.profiler (every rank calling):", flush=True)
    _profile(None, "spec", None, secs, made=mine["spec_profiles"])


def mesh_phase(torch, power):
    """Phase 9: the unsharded engine's tokens and logits, then the same
    workload on a (data 2, model 2) mesh of four gloo ranks on the card
    (plus the mesh GEMM and conv frontends); every rank checked.  Returns
    the main-path launches summed over the ranks."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.serving import SimClock, poisson_workload

    t_phase = time.perf_counter()
    cfg = _mesh_config()
    print(f"  CUT: {cfg.n_layers} of qwen3-1.7b's 28 layers (widths "
          "unchanged)", flush=True)
    wl = poisson_workload(MESH_REQUESTS, rate=20.0, vocab=cfg.vocab,
                          prompt_len=(8, 8), max_new=(3, 8), tier_mix=MIX,
                          seed=MESH_SEED)
    eng = _mesh_engine(cfg)
    eng.warmup()
    base_probe = _probe_exact_step(torch, eng, bound=True)
    base = eng.run(wl, clock=SimClock())
    torch.cuda.synchronize()
    base_rounds = _round_times(torch, eng)
    base_tokens = {rid: r.tokens for rid, r in base.items()}
    base_logits = {rid: [np.asarray(lg, np.float32) for lg in r.logits]
                   for rid, r in base.items()}
    base_tiers = {rid: r.tier for rid, r in base.items()}
    if sorted(set(base_tiers.values())) != ["balanced", "economy", "exact"]:
        fail(f"phase 9's workload reached only {set(base_tiers.values())}")
    del eng, base
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  unsharded engine: {len(wl)} requests, "
          f"{sum(map(len, base_tokens.values()))} tokens, tiers "
          f"{base_tiers}; decode round (4 slots) "
          + ", ".join(f"{k} {1e3 * v[0]:.1f} ms"
                      for k, v in base_rounds.items()), flush=True)
    one = _mesh_unsharded(torch, cfg, wl)
    print(f"  unsharded (e) surrogate ladder with the telemetry "
          f"{one['surr_s']:.1f}s: decode round (4 slots) "
          + ", ".join(f"{k} {1e3 * v[0]:.1f} ms"
                      for k, v in one["rounds"].items())
          + f"; MACs by family {one['macs']}; (f) spec k = {MESH_SPEC_K} "
          f"+ sentinels {one['spec_s']:.1f}s: trips {one['trips']}, "
          f"{sum(e[1] == 'sample' for e in one['sentinel_log'])} samples",
          flush=True)

    t = time.perf_counter()
    try:
        ranked = spawn(_mesh_rank, MESH_SHAPE[0] * MESH_SHAPE[1],
                       device="cuda", args=(wl,), timeout=600,
                       pg_timeout=300, threads=2)
    except (RuntimeError, TimeoutError) as err:
        fail(f"phase 9: {err}")
    print(f"  {len(ranked)} ranks on {torch.cuda.get_device_name(0)}, mesh "
          f"(data {MESH_SHAPE[0]}, model {MESH_SHAPE[1]}), gloo; spawn to "
          f"join {time.perf_counter() - t:.1f}s", flush=True)

    totals = {}
    for r, o in enumerate(ranked):
        if o["bad"]:
            fail(f"phase 9 rank {r}: mesh != one device: {o['bad'][:5]}")
        for key, msg in o["conv_raised"].items():
            if "not divisible" not in msg:
                fail(f"phase 9 rank {r}: conv {key} did not split and did "
                     f"not raise as plan_conv does ({msg})")
        if o["misses"]:
            fail(f"phase 9 rank {r}: {o['misses']} plan misses after warmup")
        if o["tokens"].keys() != base_tokens.keys():
            fail(f"phase 9 rank {r}: requests {sorted(o['tokens'])} served")
        if o["digest"] != ranked[0]["digest"]:
            fail(f"phase 9 rank {r}: its logits differ from rank 0's")
        fw = o["forwards"]
        sl = o["serve_launches"]
        want = {"lut_matmul_partial": ROW_PARALLEL * cfg.n_layers
                * fw["balanced"],
                "lut_matmul_fused": COL_PARALLEL * cfg.n_layers
                * fw["balanced"],
                "mitchell_matmul_partial": ROW_PARALLEL * cfg.n_layers
                * fw["economy"],
                "mitchell_matmul_fused": COL_PARALLEL * cfg.n_layers
                * fw["economy"]}
        if {k: v for k, v in sl.items() if v} != want:
            fail(f"phase 9 rank {r}: serving launched {sl}, expected "
                 f"{want} (forwards {fw})")
        for part, names in (("gemm_launches", (
                "lut_matmul_partial", "nibble_lut_matmul_partial",
                "mitchell_matmul_partial", "lut_matmul_fused",
                "nibble_lut_matmul_fused", "mitchell_matmul_fused")),
                ("conv_launches", ("conv_lut_partial", "conv_log_partial",
                                   "conv_lut_fused", "conv_log_fused"))):
            for name in names:
                if o[part][name] <= 0:
                    fail(f"phase 9 rank {r}: {name} not launched by the "
                         f"mesh {part.split('_')[0]} frontend")
        # (d)'s direct shard-route calls are checks, gated on their own
        for part in ("gemm_launches", "conv_launches", "serve_launches",
                     "surr_launches", "spec_launches"):
            for name, v in o[part].items():
                totals[name] = totals.get(name, 0) + v
        print(f"  rank {r} {o['coords']}: (a) {o['gemm_s']:.1f}s, launches "
              f"{ {k: v for k, v in o['gemm_launches'].items() if v} }; "
              f"(b) {o['conv_s']:.1f}s, launches "
              f"{ {k: v for k, v in o['conv_launches'].items() if v} }; "
              f"(c) engine {o['build_s']:.1f}s ({o['gib']:.2f} GiB), warmup "
              f"{o['warm_shapes']} shapes {o['warm_s']:.1f}s, served in "
              f"{o['serve_s']:.1f}s (collectives {o['serve_comm'][0]:.2f}s, "
              f"{o['serve_comm'][1]} calls), forwards {fw}, launches "
              f"{ {k: v for k, v in sl.items() if v} }; rank "
              f"{o['rank_s']:.1f}s", flush=True)
        for lane, (secs, (cs, calls)) in o["rounds"].items():
            print(f"    {lane:<9} decode round (2 of 4 slots) "
                  f"{1e3 * secs:.1f} ms, collectives {1e3 * cs:.1f} ms "
                  f"({100 * cs / secs:.1f}%, {calls:.0f} calls); unsharded "
                  f"{1e3 * base_rounds[lane][0]:.1f} ms", flush=True)
    print("  rank 0, one pool decode round a lane under torch.profiler "
          "(every rank decoding):", flush=True)
    for lane, recs in ranked[0]["profiles"].items():
        _profile(torch, lane, None, ranked[0]["rounds"][lane][0], made=recs)
    print(f"  every rank: the mesh GEMMs (5 cases x 8 LM shapes x 2 layouts "
          f"x 2 frontends) and convs (4 families x 5 geometries, both "
          f"layouts where C or N splits; conv 1's C = 3 raised) bitwise "
          f"equal to one device; no plan misses after warmup; the same "
          f"logits on all ranks", flush=True)

    _exact_lane_codes(torch, base_probe, ranked, cfg.n_layers)
    mine = ranked[0]
    exact_steps, worst = _served_against_unsharded(
        "(c)", mine, mine["tiers"], base_tiers, base_tokens, base_logits)
    print("  exact lane up to each request's first differing token "
          "(request, step): max |d logit|, tolerance, unsharded top-2 "
          "margin, same token: " + "; ".join(
              f"({r}, {st}) {d:.3e} {tol:.3e} {mg:.3e} {same}"
              for r, st, d, tol, mg, same in exact_steps), flush=True)
    same = sum(mine["tokens"][r] == base_tokens[r] for r in base_tokens)
    print(f"  (c) served on the mesh: balanced and economy tokens identical "
          f"and logits bitwise equal to the unsharded engine's; exact lane "
          f"(float tensor parallelism) max |d logit| {worst.get('exact')} "
          f"up to its first differing token (tolerance 2^-{MESH_EXACT_LOG2} "
          f"of the step's largest), {same} of {len(base_tokens)} requests' "
          f"tokens identical; on {power}", flush=True)
    _mesh_surrogate_checks(torch, ranked, cfg, one, power)
    _mesh_spec_checks(ranked, one, power)
    print(f"  phase 9 {time.perf_counter() - t_phase:.1f}s", flush=True)
    return totals


# ---------------------------------------------------------------------------
# phase 10: xlstm-125m on the card, prefill and lockstep decode per lane
# ---------------------------------------------------------------------------

XLSTM_BATCH, XLSTM_PROMPT, XLSTM_STEPS = 4, 512, 32
# the cim_linear GEMMs of one xLSTM layer: mLSTM w_up, wq, wk, wv, w_down;
# sLSTM w_in, w_out (wi and wf are f32 matmuls; the LM head is a plain
# matmul)
XLSTM_GEMMS = {"mlstm": 5, "slstm": 2}
# the approximate lanes' GEMM kernel (build_tiers(mode="hardware"))
XLSTM_FUSED = {"balanced": "lut_matmul_fused",
               "economy": "mitchell_matmul_fused"}
# cim=None: prefill + decode against the teacher-forced prefill of each
# prefix, the reference's tolerance (tests/test_serve_consistency.py)
XLSTM_CONSISTENCY_TOL = 0.12


def xlstm_phase(torch, power):
    """Phase 10: full-size xlstm-125m (seeded weights from LM.init) on each
    lane of build_tiers(mode="hardware"), through the lockstep launcher's
    `generate`: batch 4, a 512-token prefill and 32 lockstep greedy decode
    steps, with its launches per forward,
    identical tokens when run again, timings, one profiled decode step and
    one profiled prefill;
    then with cim=None, prefill + decode against the teacher-forced
    prefill of each prefix.  Returns the main path's launches (the lanes'
    first counted runs)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.slstm_scan import ROUTES, device_plan
    from repro_torch.launch.lockstep import generate
    from repro_torch.models.transformer import LM
    from repro_torch.serving import build_tiers

    t_phase = time.perf_counter()
    cfg = get_config("xlstm-125m")
    kinds = cfg.layer_pattern
    gemms = sum(XLSTM_GEMMS[k] for k in kinds)
    n_slstm = kinds.count("slstm")
    print(f"  {cfg.name}: d_model {cfg.d_model}, {cfg.n_layers} layers "
          f"{kinds[:len(cfg.period)]} x {cfg.n_periods}, mLSTM heads "
          f"{cfg.n_heads}, sLSTM heads {cfg.rnn.slstm_heads}, vocab "
          f"{cfg.vocab} (tied); batch {XLSTM_BATCH}, {XLSTM_PROMPT}-token "
          f"prefill, {XLSTM_STEPS} decode steps; {gemms} cim_linear GEMMs "
          f"and {n_slstm} sLSTM layers a forward", flush=True)
    base = LM(cfg)
    params = base.init(0)
    n_params = sum(t.numel() for t in _leaves(params))
    g = torch.Generator(device="cuda").manual_seed(10)
    prompts = torch.randint(0, cfg.vocab, (XLSTM_BATCH, XLSTM_PROMPT),
                            generator=g, device="cuda")
    print(f"  {n_params} parameters (seeded), "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
          flush=True)
    forwards = 1 + XLSTM_STEPS
    dh = cfg.d_model // cfg.rnn.slstm_heads
    plan = device_plan(XLSTM_BATCH, cfg.rnn.slstm_heads, dh,
                       torch.device("cuda"))
    print(f"  slstm_scan plan at batch {XLSTM_BATCH}, "
          f"{cfg.rnn.slstm_heads} heads of {dh}: {plan.route} route, "
          f"clusters of {plan.cs} ({plan.waves} wave)", flush=True)
    main = {}
    for tier in build_tiers(mode="hardware"):
        lm = LM(dataclasses.replace(cfg, cim=tier.cim))
        generate(lm, params, prompts, 1 + XLSTM_STEPS)  # warm: tables, plans
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        routes = dict(ROUTES)
        toks, finite, pre_s, dec_s, caches = generate(lm, params, prompts,
                                                      1 + XLSTM_STEPS)
        counts = _launch_counts()
        took = {k: ROUTES[k] - routes[k] for k in ROUTES}
        peak = torch.cuda.max_memory_allocated() / 2**30
        for k, v in counts.items():
            main[k] = main.get(k, 0) + v
        if not finite:
            fail(f"phase 10 {tier.name}: non-finite logits")
        want = {"slstm_scan": n_slstm * forwards}
        if tier.name in XLSTM_FUSED:
            want[XLSTM_FUSED[tier.name]] = gemms * forwards
        got = {k: v for k, v in counts.items() if v}
        if took != {"cluster": n_slstm * forwards, "streamed": 0}:
            fail(f"phase 10 {tier.name}: the sLSTM routes {took}, expected "
                 f"all {n_slstm * forwards} calls on the cluster route")
        if got != want:
            fail(f"phase 10 {tier.name}: {forwards} forwards launched {got}, "
                 f"expected {want} ({n_slstm} slstm_scan and, on an "
                 f"approximate lane, {gemms} fused GEMMs a forward; nothing "
                 "else, no float fallback)")
        again = generate(lm, params, prompts, 1 + XLSTM_STEPS)[0]
        if not torch.equal(again, toks):
            fail(f"phase 10 {tier.name}: the lane run again gave other "
                 "tokens")
        per_fwd = {k: v // forwards for k, v in got.items()}
        print(f"    {tier.name:<9} launches a forward {per_fwd} (prefill "
              f"and each decode step; every slstm_scan on the cluster "
              f"route); tokens identical when run again; "
              f"prefill ({XLSTM_BATCH} x {XLSTM_PROMPT}) {1e3 * pre_s:.1f} "
              f"ms, decode step {1e3 * dec_s:.2f} ms = "
              f"{XLSTM_BATCH / dec_s:.1f} tokens/s; peak "
              f"{peak:.2f} GiB; on {power}", flush=True)
        last, pos = toks[:, -1:].cuda(), XLSTM_PROMPT + XLSTM_STEPS

        def step():
            with torch.inference_mode():
                lm.decode_step(params, caches, last, pos)

        def prefill():
            with torch.inference_mode():
                lm.prefill(params, {"tokens": prompts})

        _profile(torch, tier.name, step, dec_s)
        _profile(torch, f"{tier.name} prefill", prefill, pre_s)
        del lm, caches

    # cim=None: the kernel's initial-state path (decode, T = 1) against
    # its zero-state path (the teacher-forced prefill of each prefix)
    n_dec = 4
    g = torch.Generator(device="cuda").manual_seed(11)
    toks = torch.randint(0, cfg.vocab, (XLSTM_BATCH, XLSTM_PROMPT + n_dec),
                         generator=g, device="cuda")
    worst, scale = 0.0, 0.0
    with torch.inference_mode():
        lp, caches = base.prefill(params, {"tokens": toks[:, :XLSTM_PROMPT]})
        for i in range(n_dec):
            full, _ = base.prefill(params,
                                   {"tokens": toks[:, :XLSTM_PROMPT + i]})
            d = float((lp[:, -1].float() - full[:, -1].float()).abs().max())
            worst = max(worst, d)
            scale = max(scale, float(full.float().abs().max()))
            if d > XLSTM_CONSISTENCY_TOL:
                fail(f"phase 10 cim=None: decode step {i} {d} from the "
                     f"teacher-forced prefill, beyond {XLSTM_CONSISTENCY_TOL}")
            if i < n_dec - 1:
                lp, caches = base.decode_step(
                    params, caches, toks[:, XLSTM_PROMPT + i:
                                         XLSTM_PROMPT + i + 1],
                    XLSTM_PROMPT + i)
    print(f"  cim=None: prefill + {n_dec - 1} decode steps against the "
          f"teacher-forced prefill of each prefix: max |d logit| "
          f"{worst:.3e} (largest |logit| {scale:.3f}) <= "
          f"{XLSTM_CONSISTENCY_TOL}", flush=True)
    print(f"  phase 10 took {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return main


# ---------------------------------------------------------------------------
# phase 11: speculative decoding and per-token activation scales
# ---------------------------------------------------------------------------

# the per-token lanes: the hardware ladder's approximate rungs and the
# nibble lane, each with the int form of its GEMM (the fused runners take
# one scalar sx, so a per-token GEMM runs the int kernel and the epilogue
# outside it), and the exact rung (fake-quant and a torch matmul)
PT_INT = {"balanced": "lut_matmul", "economy": "mitchell_matmul",
          NIBBLE_LANE: "nibble_lut_matmul", "exact": None}
SPEC_K, SPEC_KS, SPEC_SLOTS = 4, (1, 2, 4), 4
# the verify width: 4 slots x (k + 1) positions at k = 4; a prefill
# group: 4 prompts in the 16-token bucket
PT_ROWS = SPEC_SLOTS * (SPEC_K + 1)
PT_PREFILL = 64
# (b)'s pools, (slots, positions scored): the k = 4 verify on every lane,
# and on the exact lane 8 slots at k = 8, whose 72 rows pass a row block
# (the float ops, the LM head and the attention einsums, are every
# lane's); the prompts' lengths
MULTI_CASES = ((SPEC_SLOTS, SPEC_K + 1),)
WIDE_CASE = (8, 9)
MULTI_LENS = (16, 12, 9, 5, 14, 3, 11, 7)
SPEC_MAX_LEN, SPEC_BUCKET, SPEC_SEED = 64, 16, 26
# (c)'s workload: 8 requests on `exact`, 8-16-token prompts, all arriving
# at once, so the engine never reads its clock to schedule and the timed
# run is the checked one; the second wave's budgets complement the first
# wave's in the order its slots free up (56 tokens a slot), so the pool
# stays full to the last round or two
SPEC_BUDGETS = (24, 26, 29, 32, 32, 30, 27, 24)
SPEC_DEVICE = "cuda"
# what feeds each recorded GEMM's input (the op to blame when its input
# is the first thing that differs)
_GEMM_INPUT_OP = {"wq": "norm1", "wk": "norm1", "wv": "norm1",
                  "wo": "attention (einsum, softmax, einsum)",
                  "mlp_wi": "norm2", "mlp_wg": "norm2",
                  "mlp_wo": "silu(mlp_wi) * mlp_wg"}


def _spec_config():
    from repro_torch.configs import get_config

    return get_config("qwen3-1.7b")


def _pt_tiers():
    """The hardware ladder plus the nibble lane, each with per-token
    scales."""
    from repro_torch.serving import build_tiers

    tiers = build_tiers(mode="hardware")
    tiers = tiers + (_nibble_tier(tiers),)
    return {t.name: dataclasses.replace(
        t, cim=dataclasses.replace(t.cim, per_token=True)) for t in tiers}


def _add(total, counts):
    """Add the launched kernels of `counts` into `total`; returns them."""
    got = {k: v for k, v in counts.items() if v}
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    return got


def _expect_launches(where: str, got: dict, want: dict) -> None:
    """Fail unless the port's kernels launched exactly `want`."""
    if got != want:
        fail(f"{where}: launches {got}, expected {want or 'none'}")


def per_token_gemms(torch, sms, clock_hz, dev):
    """Phase 11 (a): `model_matmul` with per-token GemmParams at the four
    LM (K, N) shapes, M = 20 and M = 4, bf16: each M = 20 row bitwise the
    row of an M = 4 call and of an M = 64 call (a prefill group), the
    integer lanes' first 4 rows bitwise the CPU's plain route, exactly
    one int-form launch a call.  Returns the launches of the M = 20
    calls and those of the M = 4 and M = 64 calls held against them."""
    from repro_torch.core.approx_gemm import (_quantize_operands,
                                              model_matmul)
    from repro_torch.kernels import approx_matmul as am
    from repro_torch.kernels import mitchell_gemm as mg
    from repro_torch.kernels import ops
    from repro_torch.models.common import CiMParams

    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    path, check = {}, {}
    for name, tier in _pt_tiers().items():
        gp = CiMParams.from_config(tier.cim).gemm_params()
        kern = PT_INT[name]
        for k, n in WEIGHT_SHAPES:
            g = torch.Generator(device=dev).manual_seed(k + n)
            xp = torch.randn(PT_PREFILL, k, generator=g, device=dev).to(
                torch.bfloat16)
            x = xp[:PT_ROWS]
            w = (torch.randn(k, n, generator=g, device=dev) * 0.02).to(
                torch.bfloat16)
            _reset_counts()
            y = model_matmul(x, w, gp)
            _sync(torch, dev)
            _expect_launches(f"phase 11 (a) {name} ({PT_ROWS}, {k}, {n})",
                             _add(path, _launch_counts()),
                             {kern: 1} if kern else {})
            _reset_counts()
            y4 = torch.cat([model_matmul(x[i:i + 4], w, gp)
                            for i in range(0, PT_ROWS, 4)])
            yp = model_matmul(xp, w, gp)
            _sync(torch, dev)
            _add(check, _launch_counts())
            if not torch.equal(yp[:PT_ROWS], y):
                fail(f"phase 11 (a) {name} ({k}, {n}): rows of the M = "
                     f"{PT_PREFILL} call differ from the M = {PT_ROWS} "
                     "call's")
            if not torch.equal(y, y4):
                bad = int((y != y4).any(dim=1).sum())
                fail(f"phase 11 (a) {name} ({k}, {n}): {bad} rows of the "
                     f"M = {PT_ROWS} call differ from the M = 4 calls")
            if not torch.isfinite(y).all():
                fail(f"phase 11 (a) {name}: non-finite output")
            line = (f"    {name:<10} ({PT_ROWS:>2}, {k}, {n}): rows bitwise "
                    f"the M = 4 calls' and the M = {PT_PREFILL} call's")
            if kern:
                cpu = model_matmul(x[:4].cpu(), w.cpu(), gp)
                if not torch.equal(cpu, y[:4].cpu()):
                    fail(f"phase 11 (a) {name} ({k}, {n}): the card != the "
                         "CPU's plain route")
                # the int kernel alone on this call's codes, timed
                xq, _, wq, _ = _quantize_operands(x.float(), w.float(), 8,
                                                  True)
                if kern == "mitchell_matmul":
                    def int_call(xm):
                        return mg.mitchell_matmul(xm, wq, compensated=False)
                elif kern == "lut_matmul":
                    def int_call(xm, t=ops.lut_table(gp.spec, dev)):
                        return am.lut_matmul(xm, wq, t)
                else:
                    def int_call(xm, t=ops.nibble_table(gp.spec, dev)):
                        return am.nibble_lut_matmul(xm, wq, t)
                times = []
                for m in (4, PT_ROWS):
                    ms = _timed_ms(torch, lambda m=m: int_call(xq[:m]), 10,
                                   flush)
                    bound, by = _bound(kern, m, k, n, sms, clock_hz)
                    times.append(f"M {m}: {ms:.4f} ms (bound {bound:.4f}, "
                                 f"{by}; {100 * bound / ms:.1f}%)")
                line += (f", the first 4 bitwise the CPU's; {kern} "
                         + "; ".join(times))
            print(line, flush=True)
    print(f"  (a) per-token GEMMs: launches {path} (the M = 4 and M = "
          f"{PT_PREFILL} calls held against them: {check})", flush=True)
    return path, check


class _Recorder:
    """Wraps `cim_linear` where the qwen3 layers bind it (models.attention,
    models.common) and records each call's (name, input, output)."""

    def __init__(self):
        from repro_torch.models import attention, common

        self.mods, self.real = (attention, common), common.cim_linear
        self.calls = None

    def __enter__(self):
        self.calls = []
        real, calls = self.real, self.calls

        def rec(x, w, ctx, name="", bias=None):
            out = real(x, w, ctx, name, bias)
            calls.append((name, x.detach().clone(), out.detach().clone()))
            return out
        for m in self.mods:
            m.cim_linear = rec
        return self.calls

    def __exit__(self, *exc):
        for m in self.mods:
            m.cim_linear = self.real


def _first_difference(torch, multi, steps):
    """The first op whose result differs between the (B, K) pass and the
    K sequential steps, from the recorded GEMM inputs and outputs."""
    for j, (name, x, out) in enumerate(multi):
        for i, rec in enumerate(steps):
            sname, sx, sout = rec[j]
            if sname != name:
                return f"the call order differs at call {j}"
            if not torch.equal(x[:, i:i + 1], sx):
                return (f"{_GEMM_INPUT_OP.get(name, 'the op before')} "
                        f"before {name} of layer {j // GEMMS_PER_LAYER} "
                        f"(position {i})")
            if not torch.equal(out[:, i:i + 1], sout):
                return (f"the {name} GEMM of layer {j // GEMMS_PER_LAYER} "
                        f"(position {i})")
    return "the final norm or the LM head (every GEMM agrees)"


def _gap_rule(torch, want, got, tol):
    """Greedy tokens of `got` against `want` (rows of logits): equal
    wherever want's top-2 gap exceeds `tol`; returns (differing tokens
    beyond the gap, near-ties)."""
    top2 = want.topk(2, dim=-1).values
    wide = (top2[..., 0] - top2[..., 1]) > tol
    differ = want.argmax(-1) != got.argmax(-1)
    return int((differ & wide).sum()), int((~wide).sum())


def decode_multi_vs_sequential(torch, cfg, params, dev):
    """Phase 11 (b): on ragged pools (4 slots x 5 positions, the k = 4
    verify, and on the exact lane 8 slots x 9, 72 rows), `decode_multi`
    against as many sequential `decode_step`s on cloned caches, for the
    per-token exact lane and the per-token hardware lanes.  Returns the launches of
    the `decode_multi` calls and those of the steps held against them."""
    from repro_torch.models.transformer import LM
    from repro_torch.serving.engine import LMLaneBackend

    g = torch.Generator().manual_seed(SPEC_SEED)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).numpy()
               for n in MULTI_LENS]
    per_fwd = GEMMS_PER_LAYER * cfg.n_layers
    path, check = {}, {}

    def clone(caches):
        return {"layers": [{n: t.clone() for n, t in layer.items()}
                           for layer in caches["layers"]]}

    for name, tier in _pt_tiers().items():
        lm = LM(dataclasses.replace(cfg, cim=tier.cim), dev)
        kern = PT_INT[name]
        rec = _Recorder()
        for slots, width in MULTI_CASES + ((WIDE_CASE,) if kern is None
                                           else ()):
            lane = LMLaneBackend(lm, params, n_slots=slots,
                                 max_len=SPEC_MAX_LEN,
                                 prompt_buckets=(SPEC_BUCKET,),
                                 group_buckets=(slots,))
            lane.admit(prompts[:slots], list(range(slots)))
            fill = torch.as_tensor(lane.slot_pos, dtype=torch.int32,
                                   device=dev)
            toks = torch.randint(0, cfg.vocab, (slots, width),
                                 generator=g).to(dev)
            with torch.inference_mode():
                c_s, rows, steps, pos = clone(lane.caches), [], [], fill
                _sync(torch, dev)
                _reset_counts()
                for i in range(width):
                    with rec as calls:
                        lg, c_s = lm.decode_step(params, c_s,
                                                 toks[:, i:i + 1], pos)
                    steps.append(calls)
                    rows.append(lg[:, -1])
                    pos = pos + 1
                _sync(torch, dev)
                _expect_launches(
                    f"phase 11 (b) {name}: {width} decode_steps",
                    _add(check, _launch_counts()),
                    {kern: per_fwd * width} if kern else {})
                c_m = clone(lane.caches)
                _sync(torch, dev)
                _reset_counts()
                with rec as multi:
                    lg_m, c_m = lm.decode_multi(params, c_m, toks, fill)
                _sync(torch, dev)
                n_multi = _add(path, _launch_counts())
                _expect_launches(f"phase 11 (b) {name}: decode_multi",
                                 n_multi, {kern: per_fwd} if kern else {})
            if not torch.isfinite(lg_m).all():
                fail(f"phase 11 (b) {name}: non-finite logits")
            want = torch.stack(rows, dim=1)
            d_lg = float((lg_m.float() - want.float()).abs().max())
            d_c = max(float((x[n].float() - y[n].float()).abs().max())
                      for x, y in zip(c_m["layers"], c_s["layers"])
                      for n in ("k", "v", "pos"))
            beyond, close = _gap_rule(torch, want.float(), lg_m.float(),
                                      REF_TOL[name])
            if beyond:
                fail(f"phase 11 (b) {name} {slots} x {width}: {beyond} "
                     f"greedy tokens differ beyond the gap rule's "
                     f"{REF_TOL[name]}")
            where = ("bitwise" if d_lg == 0 and d_c == 0 else
                     "first differs at "
                     + _first_difference(torch, multi, steps))
            print(f"    {name:<10} decode_multi ({slots} x {width}) vs "
                  f"{width} decode_steps: max |d logit| {d_lg:.3e}, caches "
                  f"max |d| {d_c:.3e}, {where}; greedy tokens equal "
                  f"({close} near-ties under the gap rule's "
                  f"{REF_TOL[name]}); launches {n_multi}", flush=True)
            del lane, c_s, c_m, steps, multi
        del lm
    return path, check


def _spec_stats(sb) -> str:
    """A spec lane's acceptance, its tokens a round (all slots) and a
    live slot's tokens a round."""
    slot_rounds = sb.n_drafted / sb.draft_k
    return (f"acceptance {sb.acceptance_rate:.3f}, {sb.tokens_per_round:.2f} "
            f"tokens a round ({sb.n_emitted / max(slot_rounds, 1):.2f} a live "
            f"slot), {sb.n_rounds} rounds")


def _spec_workload(cfg):
    """(c)'s requests: SPEC_BUDGETS new tokens, 8-16-token prompts from
    SPEC_SEED, all on `exact`, all arriving at time 0."""
    import numpy as np

    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(SPEC_SEED)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab,
                                               int(rng.integers(8, 17))),
                    max_new=b, tier="exact")
            for i, b in enumerate(SPEC_BUDGETS)]


def _served(torch, eng, wl, dev, check=None):
    """Serve `wl` on `eng`'s exact lane on the real clock, recording each
    round call's host-clock span, live slots, tokens and sub-rounds;
    `check(backend)` runs after every call, its time taken out of the
    run's.  Returns the results, the run's seconds, and over the full-pool
    window (from the first call's start to the end of the last call at
    which every slot was live, prefills between included) its tokens, its
    seconds and the median host-clock time of a round (a sub-round of a
    spec call) in it, from a call's start to the next one's: the engine's
    step included."""
    import statistics

    from repro_torch.serving import RealClock

    lane = eng.lanes["exact"]
    b = lane.backend
    spec = hasattr(b, "spec_round")
    meth = "spec_round" if spec else "decode_round"
    real = getattr(b, meth)
    calls, checking = [], [0.0]

    def timed(*a):
        live = (int((a[0] > 0).sum()) if spec else len(lane.running))
        n0 = b.n_rounds if spec else 0
        t0 = time.perf_counter()
        out = real(*a)
        _sync(torch, dev)
        t1 = time.perf_counter()
        calls.append((t0, t1, live, int(out[1].sum()) if spec else live,
                      b.n_rounds - n0 if spec else 1, checking[0]))
        if check is not None:
            check(b)
            checking[0] += time.perf_counter() - t1
        return out
    setattr(b, meth, timed)
    try:
        b.reset()
        res = eng.run(wl, clock=RealClock())
        _sync(torch, dev)
    finally:
        delattr(b, meth)
    full = [c for c in calls if c[2] == SPEC_SLOTS]
    win = calls[:calls.index(full[-1]) + 1]
    return {"results": res, "run_s": eng.last_run_s - checking[0],
            "tokens": sum(c[3] for c in win),
            "window_s": win[-1][1] - win[0][0] - (win[-1][5] - win[0][5]),
            "round_s": statistics.median(
                (n[0] - c[0] - (n[5] - c[5])) / c[4]
                for c, n in zip(win, win[1:]) if c[2] == SPEC_SLOTS)}


def spec_engine(torch, cfg, params, power, dev):
    """Phase 11 (c): the spec engine (hardware ladder, spec_decode=4, depths
    1, 2, 4) against a baseline engine whose exact rung is spec_pair's
    verifier, 8 requests on `exact` on the real clock at each depth:
    tokens, plans, the cache invariant after every call, tokens/s over
    the run and over its full-pool window, a round's host time against a
    decode round's (the break-even); then one k = 1 call profiled.
    Returns the launches of the served runs."""
    import numpy as np

    from repro_torch.core.approx_gemm import plan_misses
    from repro_torch.serving import build_engine, build_tiers, spec_pair
    from repro_torch.serving.spec import nonzero_past_fill

    tiers = build_tiers(mode="hardware")
    d_tier, v_tier = spec_pair(tiers)
    kw = dict(slots_per_tier=SPEC_SLOTS, max_len=SPEC_MAX_LEN,
              prompt_buckets=(SPEC_BUCKET,), group_buckets=(1, 2, 4),
              device=dev)
    base = build_engine(cfg, params, tiers=(v_tier,), record_logits=True,
                        **kw)
    spec = build_engine(cfg, params, tiers=tiers, spec_decode=SPEC_K,
                        spec_ks=SPEC_KS, **kw)
    sb = spec.lanes["exact"].backend
    t0 = time.perf_counter()
    n = base.warmup() + spec.warmup()
    _sync(torch, dev)
    mark = plan_misses()
    print(f"  (c) drafter {d_tier.name} ({d_tier.cim.family}, "
          f"{d_tier.cim.n_approx_cols} approximate columns), verifier the "
          f"exact rung with per-token scales; rounds a call "
          f"{sb.rounds_per_call}; warmup ran {n} shapes in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    wl = _spec_workload(cfg)
    stale = []

    def invariant(b):
        stale.append(nonzero_past_fill(b.caches, b.slot_pos))

    path, rows = {}, []
    for k in (None,) + SPEC_KS:
        eng = base if k is None else spec
        if k is not None:
            sb.set_draft_k(k)
            sb.n_rounds = sb.n_drafted = sb.n_accepted = sb.n_emitted = 0
        _reset_counts()
        run = _served(torch, eng, wl, dev, None if k is None else invariant)
        _add(path, _launch_counts())
        got = run["results"]
        total = sum(len(r.tokens) for r in got.values())
        if k is None:
            want, base_round = got, run["round_s"]
            what = (f"per-token exact lane, a decode round "
                    f"{1e3 * base_round:.1f} ms")
        else:
            ties = []
            for r in wl:
                a, b = want[r.rid].tokens, got[r.rid].tokens
                if a == b:
                    continue
                i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
                gap = float("inf")
                if i < min(len(a), len(b)):
                    top2 = torch.as_tensor(want[r.rid].logits[i]).topk(2)
                    gap = float(top2.values[0] - top2.values[1])
                if gap > REF_TOL["exact"]:
                    fail(f"phase 11 (c) k={k}: request {r.rid} tokens differ "
                         f"from the baseline at step {i} (baseline top-2 gap "
                         f"{gap:.3e})")
                ties.append(f"request {r.rid} step {i} (gap {gap:.3e})")
            what = (f"spec k={k}, "
                    + ("identical to the baseline" if not ties else
                       "differing at near-ties only: " + ", ".join(ties))
                    + f"; {_spec_stats(sb)}; a round "
                    f"{1e3 * run['round_s']:.1f} ms, break-even "
                    f"{run['round_s'] / base_round - 1:.2f} accepted tokens "
                    f"a live slot a round, "
                    f"{sb.n_accepted / max(sb.n_drafted / k, 1):.2f} "
                    "accepted")
        win = run["tokens"] / run["window_s"]
        rows.append((k, win))
        print(f"    real clock on {power}: {what}; {total} tokens in "
              f"{run['run_s']:.2f}s = {total / run['run_s']:.1f} tokens/s; "
              f"full pool: {run['tokens']} tokens in {run['window_s']:.2f}s "
              f"= {win:.1f} tokens/s", flush=True)
    if any(stale):
        fail(f"phase 11 (c): K/V entries past a slot's fill after a spec "
             f"call: {[s for s in stale if s][:5]}")
    if plan_misses() != mark:
        fail(f"phase 11 (c): {plan_misses() - mark} plans built after "
             "warmup (depth switches included)")
    t = time.perf_counter()
    invariant(sb)
    check_ms = 1e3 * (time.perf_counter() - t)
    best = max(rows[1:], key=lambda r: r[1])
    print(f"  (c) {len(stale)} spec calls, every K/V entry at or past each "
          f"slot's fill zero after each, in all {cfg.n_layers} layers (the "
          f"check {check_ms:.1f} ms a call, out of the times); no plan built "
          f"after warmup; launches {path}; full pool, spec k={best[0]} "
          f"{best[1]:.1f} tokens/s against the per-token exact lane's "
          f"{rows[0][1]:.1f} ({best[1] / rows[0][1]:.3f}x); "
          f"{time.perf_counter() - t0:.1f}s so far", flush=True)

    # one spec call of one round (every slot's budget 1) profiled
    one = np.ones(SPEC_SLOTS, np.int64)
    none = np.full(SPEC_SLOTS, -1, np.int64)
    sb.set_draft_k(SPEC_KS[0])
    sb.reset()
    t = time.perf_counter()
    sb.spec_round(one, none)
    _sync(torch, dev)
    _profile(torch, f"spec k={SPEC_KS[0]}", lambda: sb.spec_round(one, none),
             time.perf_counter() - t, reps=1)
    sb.reset()
    return path


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def spec_phase(torch, power, sms, clock_hz):
    """Phase 11: speculative decoding and per-token scales on full-size
    qwen3-1.7b (seeded bf16 weights).  Returns the main path's launches
    and the launches of the calls held against it in (a) and (b)."""
    from repro_torch.models.transformer import LM

    t_phase = time.perf_counter()
    dev = torch.device(SPEC_DEVICE)
    cfg = _spec_config()
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}; {SPEC_SLOTS} slots, {SPEC_MAX_LEN}-token "
          f"slots; per-token lanes {list(PT_INT)}", flush=True)
    print("  (a) per-token model_matmul, bf16", flush=True)
    path, check = per_token_gemms(torch, sms, clock_hz, dev)
    params = LM(cfg, dev).init(0)
    print(f"  (b) decode_multi against sequential decode (ragged pools; "
          f"(a) took {time.perf_counter() - t_phase:.1f}s)", flush=True)
    p, c = decode_multi_vs_sequential(torch, cfg, params, dev)
    _add(path, p)
    _add(check, c)
    print(f"  (a) and (b) took {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    _add(path, spec_engine(torch, cfg, params, power, dev))
    stray = {k: v for k, v in {**check, **path}.items()
             if k not in GEMM_KERNELS}
    if stray:
        fail(f"phase 11: kernels other than the GEMMs launched: {stray}")
    print(f"  phase 11 took {time.perf_counter() - t_phase:.1f}s", flush=True)
    return path, check


# ---------------------------------------------------------------------------
# phase 12: fault injection and lane sentinels
# ---------------------------------------------------------------------------

# the reference's fault benchmark (benchmarks/bench_faults.py) on the
# hardware ladder: the stuck-at rate of the Table V geometry of 32 rows at
# its MNIS-characterized Pf (scale 1.0), 2 slots a tier, 64-token slots,
# one 8-token prompt bucket, groups of 1 and 2, 3 restarts a request; 16
# Poisson requests at 600/s, 4-8-token prompts, 6-12 new tokens, tiers
# exact 0.2 / balanced 0.4 / economy 0.4, seed 11
FAULT_ROWS = 32
FAULT_SLOTS, FAULT_MAX_LEN, FAULT_BUCKET, FAULT_GROUPS = 2, 64, 8, (1, 2)
FAULT_RETRIES = 3
FAULT_REQUESTS, FAULT_RATE, FAULT_SEED = 16, 600.0, 11
FAULT_PROMPTS, FAULT_NEW = (4, 8), (6, 12)
FAULT_MIX = (("exact", None, 0.2), ("balanced", None, 0.4),
             ("economy", None, 0.4))
# the most tokens a faulted lane may emit before its sentinel trips (two
# shadow samples, one every second round, over 2 slots)
FAULT_DETECT = 8
# the clean ladder at full width is measured over this many scheduler
# ticks (four shadow samples a lane), not served to the end
FAULT_CLEAN_TICKS = 8
# the faulted ladder's quarantine before a half-open probe: the larger of
# FAULT_COOLDOWN_S and FAULT_COOLDOWN_ROUNDS of the ladder's own rounds
# (one decode round of every lane, measured on the card after warmup,
# the median of FAULT_ROUND_REPS).  The default (0.1 s) is shorter than
# one tick of the full-width ladder, so a tripped lane would run a
# failing probe (a prefill and a shadow-scored round) on every tick; so
# would a fixed 2 s on a host whose rounds take 0.35-0.45 s, where the
# probes took most of the run.  Counted in rounds, a probe is a fixed
# share of the run on a slow host as on a fast one, while the exact lane
# serves the displaced requests.
FAULT_COOLDOWN_S = 2.0
FAULT_COOLDOWN_ROUNDS, FAULT_ROUND_REPS = 10, 3
# the int kernel of each faulted lane's GEMMs (a fault gates the fused
# runners off; the faulted table fits the magnitude form only)
FAULT_INT = {"balanced": "lut_matmul_mag", "economy": "mitchell_matmul"}
FAULT_DEVICE = "cuda"
# (a): the magnitude-table kernel at every operand width it takes, on the
# ragged shape, for the exact family's and appro42's tables
MAG_BITS = tuple(range(2, 9))
# (d): one faulted cim_conv2d a family at the CNN's second conv geometry
# (H, W, C, N), batch 8
FAULT_CONV_BATCH, FAULT_CONV = 8, CNN_CONVS[1]


def _fault_config():
    from repro_torch.configs import get_config

    return get_config("qwen3-1.7b")


def _fault_tiers():
    """The hardware ladder with per-token scales on the exact rung: its
    rows are then their own (row-pure), so the tokens of a request on
    `exact` do not depend on the slots beside it, and the faulted and
    exact-only engines can be held token for token (the reference's
    bench_faults.py)."""
    from repro_torch.serving import build_tiers

    return tuple(
        dataclasses.replace(t, cim=dataclasses.replace(t.cim,
                                                       per_token=True))
        if t.name == "exact" else t
        for t in build_tiers(mode="hardware"))


def _ints(torch, g, shape, bits, dev):
    half = 1 << (bits - 1)
    return torch.randint(-half, half, shape, generator=g, device=dev,
                         dtype=torch.int32).to(torch.int8)


def fault_kernel(torch, sms, clock_hz, dev, fault, spec):
    """Phase 12 (a): `lut_matmul_mag` bitwise its plain version with the
    balanced tier's faulted table at the LM shapes (timed beside its bound
    and plain version), and with the clean table bitwise `lut_matmul` on
    the int16 signed table; at 2..8 bits on the ragged shape, faulted and
    clean, for the exact family's and appro42's tables.  Returns the
    timed rows and the check launches."""
    from repro_torch.core.multipliers import MultiplierSpec
    from repro_torch.kernels import approx_matmul as am
    from repro_torch.kernels import ops

    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    _reset_counts()
    faulted = ops.magnitude_lut(spec, fault, dev)
    clean = ops.magnitude_lut(spec, None, dev)
    rows = []
    for m, k, n in MAIN_SHAPES:
        g = torch.Generator(device=dev).manual_seed(m * 7 + k + n)
        xq, wq = _ints(torch, g, (m, k), 8, dev), _ints(torch, g, (k, n), 8,
                                                        dev)
        got = am.lut_matmul_mag(xq, wq, faulted)
        want = am.lut_matmul_mag_plain(xq, wq, faulted)
        if not torch.equal(got, want):
            fail(f"phase 12 (a) lut_matmul_mag ({m}, {k}, {n}): the faulted "
                 f"table's product != its plain version ({int((got != want).sum())} "
                 "entries)")
        if not torch.equal(am.lut_matmul_mag(xq, wq, clean),
                           am.lut_matmul(xq, wq, ops.lut_table(spec, dev))):
            fail(f"phase 12 (a) lut_matmul_mag ({m}, {k}, {n}): the clean "
                 "magnitude table != lut_matmul on the int16 signed table")
        ms = _timed_ms(torch, lambda: am.lut_matmul_mag(xq, wq, faulted), 10,
                       flush)
        plain_ms = _timed_ms(
            torch, lambda: am.lut_matmul_mag_plain(xq, wq, faulted), 2, flush)
        bound, by = _bound("lut_matmul_mag", m, k, n, sms, clock_hz)
        rows.append({"shape": (m, k, n), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "max_abs_err": 0.0,
                     "library_ms": None})
        print(f"    lut_matmul_mag ({m:>2}, {k}, {n}): faulted bitwise plain, "
              f"clean bitwise lut_matmul; {ms:.4f} ms (bound {bound:.4f}, "
              f"{by}; {100 * bound / ms:.1f}%), plain {plain_ms:.3f} ms",
              flush=True)
    m, k, n = RAGGED
    for bits in MAG_BITS:
        for fam, comp in (("exact", "yang1"), ("appro42", "yang1")):
            sb = MultiplierSpec(fam, bits, True, comp, None)
            g = torch.Generator(device=dev).manual_seed(bits)
            xq, wq = _ints(torch, g, (m, k), bits, dev), _ints(
                torch, g, (k, n), bits, dev)
            for tab in (ops.magnitude_lut(sb, fault, dev),
                        ops.magnitude_lut(sb, None, dev)):
                if not torch.equal(am.lut_matmul_mag(xq, wq, tab, bits),
                                   am.lut_matmul_mag_plain(xq, wq, tab,
                                                           bits)):
                    fail(f"phase 12 (a) lut_matmul_mag {fam} {bits}-bit "
                         f"{RAGGED} != its plain version")
            if not torch.equal(
                    am.lut_matmul_mag(xq, wq, ops.magnitude_lut(sb, None, dev),
                                      bits),
                    am.lut_matmul(xq, wq, ops.lut_table(sb, dev), bits)):
                fail(f"phase 12 (a) lut_matmul_mag {fam} {bits}-bit: the "
                     "clean magnitude table != lut_matmul")
    _sync(torch, dev)
    check = {k: v for k, v in _launch_counts().items() if v}
    print(f"  (a) lut_matmul_mag bitwise at the LM shapes (faulted and "
          f"clean) and at {list(MAG_BITS)} bits on {RAGGED}; launches "
          f"{check}", flush=True)
    return rows, check


def _fault_workload(cfg):
    from repro_torch.serving import poisson_workload

    return poisson_workload(FAULT_REQUESTS, FAULT_RATE, cfg.vocab,
                            prompt_len=FAULT_PROMPTS, max_new=FAULT_NEW,
                            tier_mix=FAULT_MIX, seed=FAULT_SEED)


def _run_engine(torch, eng, wl, dev):
    """Serve `wl` on the warmed `eng`, and read its plan misses right
    after (the plan cache is shared, so each engine is held to its own
    run).  Returns (results, forwards per lane, launches, plan
    misses)."""
    fwd = _count_forwards(eng)
    _reset_counts()
    res = eng.run(wl)
    _sync(torch, dev)
    return res, fwd, {k: v for k, v in _launch_counts().items() if v}, \
        eng.steady_plan_misses()


def _exact_identity(torch, res, ref, where):
    """Every request that finished on `exact` holds the exact-only run's
    tokens, but where that run's top-2 gap at the first differing step is
    within REF_TOL["exact"] (printed).  Returns the near-ties."""
    ties = []
    for rid, r in res.items():
        if r.tier != "exact":
            continue
        a, b = ref[rid].tokens, r.tokens
        if a == b:
            continue
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        gap = float("inf")
        if i < min(len(a), len(b)):
            top2 = torch.as_tensor(ref[rid].logits[i]).topk(2)
            gap = float(top2.values[0] - top2.values[1])
        if gap > REF_TOL["exact"]:
            fail(f"phase 12 {where}: request {rid} on exact differs from the "
                 f"exact-only run at step {i} (its top-2 gap {gap:.3e})")
        ties.append(f"request {rid} step {i} (gap {gap:.3e})")
    return ties


def clean_width(torch, cfg, params, power, dev):
    """Phase 12 (b), first: the clean ladder at full width, armed with
    SentinelConfig() defaults, stepped FAULT_CLEAN_TICKS scheduler ticks
    on the workload with its arrivals at time 0: each approximate lane's
    trips and its sentinel's own drift (the last sample's and, at a trip,
    the rolling argmax agreement and logit NMED against the per-token
    exact rung).  A measurement: at this width the default thresholds
    trip a clean lane on seeded weights, so the contract's 0 trips on a
    clean ladder is held in (c), on the reference's own setting.  No plan
    may be built after warmup."""
    from repro_torch.serving import SentinelConfig, build_engine

    eng = build_engine(cfg, params, tiers=_fault_tiers(),
                       sentinel_cfg=SentinelConfig(), **_fault_engine_kw(dev))
    eng.warmup()
    _sync(torch, dev)
    for r in _fault_workload(cfg):
        eng.submit(dataclasses.replace(r, arrival=0.0))
    t = time.perf_counter()
    for _ in range(FAULT_CLEAN_TICKS):
        eng.step(time.perf_counter() - t)
    _sync(torch, dev)
    if eng.steady_plan_misses():
        fail(f"phase 12 (b) clean ladder: {eng.steady_plan_misses()} plans "
             "built after warmup")
    for name in FAULT_INT:
        sen = eng.lanes[name].sentinel
        trips = [f"after {t.tokens_before_trip} tokens ({t.reason}; rolling "
                 f"agreement {t.trigger_agree:.3f}, NMED "
                 f"{t.trigger_nmed:.3f})"
                 for t in eng.trip_log if t.lane == name]
        last = ("none" if sen.last_nmed is None else
                f"agreement {sen.last_agree:.3f}, NMED {sen.last_nmed:.3f}")
        print(f"    clean {name} at full width, SentinelConfig() defaults, "
              f"{FAULT_CLEAN_TICKS} ticks on {power}: {sen.n_checks} shadow "
              f"samples against the per-token exact rung, the last {last}; "
              f"trips: {'; '.join(trips) or 'none'}", flush=True)


def _fault_engine_kw(dev):
    return dict(slots_per_tier=FAULT_SLOTS, max_len=FAULT_MAX_LEN,
                prompt_buckets=(FAULT_BUCKET,), group_buckets=FAULT_GROUPS,
                retry_budget=FAULT_RETRIES, device=dev)


def _ladder(torch, cfg, params, dev, **kw):
    """Build and warm one ladder (`kw`: build_engine's fault and sentinel
    options).  Returns (engine, warmup seconds)."""
    from repro_torch.serving import build_engine

    eng = build_engine(cfg, params, tiers=kw.pop("tiers", _fault_tiers()),
                       **kw, **_fault_engine_kw(dev))
    t = time.perf_counter()
    eng.warmup()
    _sync(torch, dev)
    return eng, time.perf_counter() - t


def _serve_ladder(torch, ladder, dev, name, reqs, power):
    """Serve `reqs` on the real clock on `ladder` (`_ladder`'s engine and
    warmup seconds) and print the run: no plan built after warmup and no
    failed request, else the phase fails.  Returns (engine, results,
    forwards per lane, launches)."""
    from repro_torch.serving import EngineStats

    eng, warm_s = ladder
    res, fwd, got, misses = _run_engine(torch, eng, reqs, dev)
    stats = EngineStats.from_results(res, eng.last_run_s)
    if misses:
        fail(f"phase 12 {name}: {misses} plans built after warmup")
    if stats.n_failed or not all(r.done and r.status == "ok"
                                 for r in res.values()):
        fail(f"phase 12 {name}: {stats.n_failed} failed requests")
    trips = "; ".join(
        f"{t.lane} after {t.tokens_before_trip} tokens ({t.reason}; rolling "
        f"agreement {t.trigger_agree:.3f}, NMED {t.trigger_nmed:.3f}; "
        f"{t.in_flight_displaced} in flight)" for t in eng.trip_log)
    print(f"    {name} real clock on {power}: warmup {warm_s:.1f}s; "
          f"{stats.n_requests} requests ok, {stats.n_failed} failed, "
          f"{sum(1 for r in res.values() if r.retries)} restarted; goodput "
          f"{stats.total_tokens} tokens in {stats.duration_s:.2f}s = "
          f"{stats.tokens_per_s:.1f} tokens/s; forwards {fwd}; trips: "
          f"{trips or 'none'}; launches {got}", flush=True)
    return eng, res, fwd, got


def _ladder_round(torch, dev, eng):
    """The ladder's round: one decode round of every lane, the median of
    FAULT_ROUND_REPS, each pool reset after (as warmup leaves it)."""
    ticks = []
    for _ in range(FAULT_ROUND_REPS):
        t = time.perf_counter()
        for lane in eng.lanes.values():
            lane.backend.decode_round()
        _sync(torch, dev)
        ticks.append(time.perf_counter() - t)
    for lane in eng.lanes.values():
        lane.backend.reset()
    return sorted(ticks)[len(ticks) // 2]


def _quarantined_forwards(eng, names):
    """Count, a lane of `names`, the forwards it runs while quarantined:
    its half-open probes, a prefill each and then their decode rounds.
    Returns {name: [probes, forwards]}, filled as the engine runs."""
    counts = {name: [0, 0] for name in names}
    for name in names:
        lane = eng.lanes[name]
        for meth, opens in (("prefill", 1), ("decode_step", 0)):
            def wrapped(*a, _real=getattr(lane.backend.lm, meth), _lane=lane,
                        _n=counts[name], _opens=opens, **kw):
                if _lane.quarantined:
                    _n[0] += _opens
                    _n[1] += 1
                return _real(*a, **kw)
            setattr(lane.backend.lm, meth, wrapped)
    return counts


def fault_engines(torch, cfg, params, power, dev, fault):
    """Phase 12 (b): the faulted armed ladder and the exact-only engine on
    the Poisson arrivals, each on the real clock: every faulted lane
    trips within FAULT_DETECT tokens, no request fails, the requests that
    finish on exact hold the exact-only run's tokens (near-ties printed),
    196 int-kernel launches a faulted-lane forward.  The faulted ladder's
    probe cooldown is scaled to its own round (`_ladder_round`, measured
    after warmup); the round, the cooldown, the run's seconds and each
    faulted lane's forwards, in probes and the rest, are printed.
    Returns the faulted run's launches and the faulted engine."""
    from repro_torch.core import faults
    from repro_torch.serving import SentinelConfig

    wl = _fault_workload(cfg)
    by_tier = {}
    for r in wl:
        by_tier[r.tier] = by_tier.get(r.tier, 0) + 1
    print(f"    workload: {len(wl)} requests {by_tier}, arrivals over "
          f"{1e3 * wl[-1].arrival:.1f} ms", flush=True)
    t = time.perf_counter()
    for k, n in WEIGHT_SHAPES:
        faults.weight_masks(fault, (k, n), 8, dev)
    _sync(torch, dev)
    print(f"    the weight masks of the four LM shapes drawn and on the "
          f"card in {time.perf_counter() - t:.1f}s", flush=True)
    eng, warm_s = _ladder(torch, cfg, params, dev, fault=fault,
                          sentinel_cfg=SentinelConfig())
    rnd = _ladder_round(torch, dev, eng)
    cooldown = max(FAULT_COOLDOWN_S, FAULT_COOLDOWN_ROUNDS * rnd)
    for name in FAULT_INT:
        eng.lanes[name].sentinel.breaker.cooldown_s = cooldown
    probes = _quarantined_forwards(eng, FAULT_INT)
    _, res, fwd, got = _serve_ladder(torch, (eng, warm_s), dev,
                                     "(b) faulted", wl, power)
    split = "; ".join(f"{name} {fwd[name]} ({probes[name][1]} in "
                      f"{probes[name][0]} probes, "
                      f"{fwd[name] - probes[name][1]} else)"
                      for name in FAULT_INT)
    print(f"    (b) faulted run {eng.last_run_s:.1f}s: the ladder's round "
          f"{rnd:.3f} s (one decode round of each of its {len(eng.lanes)} "
          f"lanes, median of {FAULT_ROUND_REPS}) -> a probe cooldown of "
          f"{cooldown:.2f} s (the larger of {FAULT_COOLDOWN_S:g} s and "
          f"{FAULT_COOLDOWN_ROUNDS} rounds); forwards a faulted lane: "
          f"{split}", flush=True)
    tripped = {t.lane for t in eng.trip_log}
    served = {r.tier for r in wl} - {"exact"}
    if not served <= tripped:
        fail(f"phase 12 (b): faulted lanes {sorted(served - tripped)} did "
             "not trip")
    readmitted = [name for name in served
                  if not eng.lanes[name].quarantined
                  or eng.lanes[name].sentinel.breaker.n_recoveries]
    if readmitted:
        fail(f"phase 12 (b): a probe re-admitted the faulted lanes "
             f"{sorted(readmitted)}")
    late = [(t.lane, t.tokens_before_trip) for t in eng.trip_log
            if t.tokens_before_trip > FAULT_DETECT]
    if late:
        fail(f"phase 12 (b): trips after more than {FAULT_DETECT} tokens: "
             f"{late}")
    want = {FAULT_INT[lane]: GEMMS_PER_LAYER * cfg.n_layers * fwd[lane]
            for lane in FAULT_INT if fwd[lane]}
    _expect_launches("phase 12 (b) faulted ladder", got, want)

    ex_wl = [dataclasses.replace(r, tier="exact", tolerance=None) for r in wl]
    _, ref, _, ex_got = _serve_ladder(
        torch, _ladder(torch, cfg, params, dev, record_logits=True,
                       tiers=tuple(t for t in _fault_tiers()
                                   if t.name == "exact")),
        dev, "(b) exact-only", ex_wl, power)
    _expect_launches("phase 12 (b) exact-only", ex_got, {})
    ties = _exact_identity(torch, res, ref, "(b)")
    on_exact = sum(1 for r in res.values() if r.tier == "exact")
    print(f"  (b) faulted ladder: {len(eng.trip_log)} trips (detection "
          f"{[t.tokens_before_trip for t in eng.trip_log]} tokens), 0 "
          f"failed, {on_exact} requests finished on exact, "
          + ("identical to the exact-only run" if not ties else
             "identical to the exact-only run but at near-ties: "
             + ", ".join(ties))
          + f"; every faulted lane still quarantined (probes after a "
          f"{cooldown:.2f} s cooldown, none passed); "
          f"{GEMMS_PER_LAYER * cfg.n_layers} int-kernel launches a "
          "faulted-lane forward, no fused or nibble form; no plan built "
          "after warmup", flush=True)
    return got, eng


def fault_smoke(torch, dev, power):
    """Phase 12 (c): the reference's own setting (bench_faults.py:
    qwen3-1.7b-smoke) on the card: the clean armed ladder against the same
    ladder unarmed, the workload's arrivals at time 0 so both admit alike:
    0 trips and equal tokens; then the recovery drill."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serving import SentinelConfig

    cfg = get_config("qwen3-1.7b", smoke=True)
    params = LM(cfg, dev).init(0)
    at0 = [dataclasses.replace(r, arrival=0.0) for r in _fault_workload(cfg)]
    clean, res, _, _ = _serve_ladder(
        torch, _ladder(torch, cfg, params, dev, sentinel_cfg=SentinelConfig()),
        dev, "(c) smoke clean armed", at0, power)
    _, unarmed, _, _ = _serve_ladder(torch, _ladder(torch, cfg, params, dev),
                                     dev, "(c) smoke unarmed", at0, power)
    if clean.trip_log:
        fail(f"phase 12 (c): the clean armed ladder tripped: "
             f"{[(t.lane, t.reason) for t in clean.trip_log]}")
    moved = [rid for rid in res if res[rid].tokens != unarmed[rid].tokens]
    if moved:
        fail(f"phase 12 (c): the armed clean ladder's tokens differ from "
             f"the unarmed one's for requests {moved}")
    print(f"  (c) {cfg.name}: the clean armed ladder 0 trips, its tokens the "
          "unarmed ladder's", flush=True)
    fault_recovery(torch, cfg, params, dev)


def fault_recovery(torch, cfg, params, dev):
    """Phase 12 (c): the recovery drill of bench_faults.py on the clean
    armed ladder (cooldown 0): two requests on balanced, a forced trip
    (both restart on exact), the half-open probe on the next tick, traffic
    routed back to balanced, the demoted work drained; no plan built
    after warmup."""
    import numpy as np

    from repro_torch.serving import (Request, SentinelConfig, SimClock,
                                     build_engine)

    eng = build_engine(cfg, params, tiers=_fault_tiers(),
                       sentinel_cfg=SentinelConfig(cooldown_s=0.0),
                       **_fault_engine_kw(dev))
    eng.warmup()
    _sync(torch, dev)
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, (6,)),
                    max_new=8, tier="balanced") for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.step(0.0)
    lane = eng.lanes["balanced"]
    if not lane.running:
        fail("phase 12 (c): the requests did not land on balanced")
    eng._trip(lane, 0.01, "forced (recovery drill)")
    if not (lane.quarantined and not lane.running
            and all(eng.results[r.rid].retries == 1 for r in reqs)):
        fail("phase 12 (c): the forced trip did not quarantine the lane and "
             "restart its requests")
    eng.step(0.02)                      # the half-open probe fires here
    if lane.quarantined:
        fail(f"phase 12 (c): the probe did not re-admit the clean lane "
             f"(breaker {lane.sentinel.breaker.state})")
    back = eng.submit(Request(rid=99, prompt=reqs[0].prompt, max_new=2,
                              tier="balanced", arrival=0.03))
    if back != "balanced":
        fail(f"phase 12 (c): traffic went to {back} after the recovery")
    eng.run([], clock=SimClock())
    if not all(r.done and r.status == "ok" for r in eng.results.values()):
        fail("phase 12 (c): the demoted work did not drain")
    if eng.steady_plan_misses():
        fail(f"phase 12 (c): {eng.steady_plan_misses()} plans built after "
             "warmup")
    br = lane.sentinel.breaker
    print(f"  (c) recovery drill: forced trip, 2 requests restarted on "
          f"{eng.results[0].tier}, probe passed ({br.n_trips} trip, "
          f"{br.n_recoveries} recovery), request 99 routed back to "
          f"{back}, drained, no plan built after warmup", flush=True)


def fault_convs(torch, dev, fault, tiers):
    """Phase 12 (d): one faulted `cim_conv2d` a family (hardware mode) on
    the card bitwise the CPU's plain route, each one int-kernel launch on
    the conv_im2col route.  Returns the launches."""
    from repro_torch.core.approx_gemm import GemmParams, cim_conv2d

    h, w, c, n = FAULT_CONV
    g = torch.Generator().manual_seed(12)
    x = torch.randn(FAULT_CONV_BATCH, h, w, c, generator=g)
    wt = torch.randn(9 * c, n, generator=g) * 0.1
    bal = next(t for t in tiers if t.name == "balanced").cim
    total = {}
    for fam, comp, nac in (("exact", "yang1", None),
                           ("appro42", bal.compressor, bal.n_approx_cols),
                           ("mitchell", "yang1", None),
                           ("log_our", "yang1", None)):
        gp = GemmParams(family=fam, bits=8, mode="hardware",
                        compressor=comp, n_approx_cols=nac, fault=fault)
        _reset_counts()
        with torch.no_grad():
            got = cim_conv2d(x.to(dev), wt.to(dev), gp)
            _sync(torch, dev)
            got_launch = _add(total, _launch_counts())
            want = cim_conv2d(x, wt, gp)
        kern = "mitchell_matmul" if fam in ("mitchell", "log_our") \
            else "lut_matmul_mag"
        _expect_launches(f"phase 12 (d) {fam}", got_launch, {kern: 1})
        if not torch.equal(got.cpu(), want):
            fail(f"phase 12 (d) {fam}: the faulted conv on the card != the "
                 "CPU's plain route")
    print(f"  (d) faulted cim_conv2d ({FAULT_CONV_BATCH}, {h}, {w}, {c}) -> "
          f"{n}, 3x3, for exact, appro42, mitchell and log_our: bitwise "
          f"the CPU's, conv_im2col and one int kernel each; launches {total}",
          flush=True)
    return total


def fault_phase(torch, power, sms, clock_hz):
    """Phase 12: fault injection and lane sentinels on full-size
    qwen3-1.7b (seeded bf16 weights).  Returns the served launches (the
    faulted ladder's run), the launches of the calls held against them
    ((a), (d)) and (a)'s timed rows of lut_matmul_mag."""
    from repro_torch.core.faults import FaultConfig
    from repro_torch.models.transformer import LM

    t_phase = time.perf_counter()
    dev = torch.device(FAULT_DEVICE)
    cfg = _fault_config()
    fault = FaultConfig.from_yield(rows=FAULT_ROWS, scale=1.0)
    tiers = _fault_tiers()
    bal = next(t for t in tiers if t.name == "balanced").cim
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}; {FAULT_SLOTS} slots a tier, "
          f"{FAULT_MAX_LEN}-token slots; fault p_sa0 = p_sa1 = "
          f"{fault.p_sa0:.6g} (Table V, {FAULT_ROWS} rows, Pf "
          f"{fault.rate:.6g})", flush=True)
    print("  (a) the magnitude-table LUT kernel against its plain version",
          flush=True)
    rows, check = fault_kernel(torch, sms, clock_hz, dev, fault, bal.spec)
    params = LM(cfg, dev).init(0)
    print(f"  (b) full width ({time.perf_counter() - t_phase:.1f}s so far)",
          flush=True)
    clean_width(torch, cfg, params, power, dev)
    print(f"    ({time.perf_counter() - t_phase:.1f}s so far)", flush=True)
    path, eng = fault_engines(torch, cfg, params, power, dev, fault)
    for name in FAULT_INT:
        b = eng.lanes[name].backend
        t = time.perf_counter()
        b.decode_round()
        _sync(torch, dev)
        _profile(torch, f"faulted {name}", b.decode_round,
                 time.perf_counter() - t)
    del eng, b, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (c) ({time.perf_counter() - t_phase:.1f}s so far)", flush=True)
    fault_smoke(torch, dev, power)
    _add(check, fault_convs(torch, dev, fault, tiers))
    print(f"  phase 12 took {time.perf_counter() - t_phase:.1f}s", flush=True)
    return path, check, rows


# ---------------------------------------------------------------------------
# phase 13: per-module accuracy allocation (core/allocate.py)
# ---------------------------------------------------------------------------

# BENCH_dse's characterization grid: six 12-bit specs, Monte Carlo
ALLOC_CHAR_SPECS = ([("appro42", 12, False, "yang1", n) for n in (4, 8)]
                    + [("appro42", 12, False, "orplane", n) for n in (6, 10)]
                    + [("log_our", 12, False, "yang1", None),
                       ("mitchell", 12, False, "yang1", None)])
ALLOC_CHAR_SAMPLES = 200_000
# the reference contract's speedup of the batched characterization
# (recorded, not gated)
ALLOC_CHAR_SPEEDUP = 10.0
ALLOC_BUDGET = 1e-2
# autoallocate's energy against the exhaustive oracle's
ALLOC_ENERGY_SLACK = 1.10
ALLOC_SMOKE_MODULES = ("wq", "wv", "mlp_wo")
ALLOC_MODULES = ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wg", "mlp_wo")
# the card's single-module truth table against the CPU's: rtol as
# tests/test_torch_allocate.py holds the port's to the JAX package's (a
# last-ulp difference on a rounding boundary moves a whole code); each
# selection's logits within phase 4's REF_TOL
ALLOC_TRUTH_RTOL = 0.15
# (c): reruns at twice the last budget while the search returns
# all-exact, the first at 2x the smallest approximate single-module NMED
ALLOC_RERUNS = 4
ALLOC_REQUESTS, ALLOC_SEED = 12, 1
# new tokens a request: (d) serves the workload twice at ~170 ms a decode
# round of the allocation lane at full width (on an H100, (4, 16) took
# 23.9 s a run and the phase 106.2 s)
ALLOC_NEW = (4, 10)
ALLOC_MIX = (("exact", None, 0.5), ("autoalloc", None, 0.5))
ALLOC_DEVICE = "cuda"


def _alloc_config():
    from repro_torch.configs import get_config

    return get_config("qwen3-1.7b")


def _alloc_smoke_config():
    from repro_torch.configs import get_config

    return get_config("qwen3-1.7b", smoke=True)


def _alloc_kernel(family: str, ncols, bits: int = 8):
    """The fused kernel a hardware-mode module of this multiplier launches
    (None for the exact macro)."""
    if family == "exact":
        return None
    if family == "appro42":
        n = bits if ncols is None else ncols
        return ("nibble_lut_matmul_fused" if n <= bits // 2
                else "lut_matmul_fused")
    return "mitchell_matmul_fused"


def alloc_characterize(torch, dev):
    """(a) characterize_batch on the device against the serial path."""
    from repro_torch.core import error_model as erm
    from repro_torch.core.multipliers import MultiplierSpec

    specs = [MultiplierSpec(*k) for k in ALLOC_CHAR_SPECS]
    n = ALLOC_CHAR_SAMPLES
    t = time.perf_counter()
    serial = [erm.characterize(s, n_samples=n, cache=False) for s in specs]
    serial_s = time.perf_counter() - t
    t = time.perf_counter()
    cold = erm.characterize_batch(specs, n_samples=n, cache=False,
                                  device=dev)
    cold_s = time.perf_counter() - t
    steady = []
    for _ in range(3):
        t = time.perf_counter()
        got = erm.characterize_batch(specs, n_samples=n, cache=False,
                                     device=dev)
        steady.append(time.perf_counter() - t)
        if got != serial:
            fail("(a) characterize_batch differs from characterize")
    if cold != serial:
        fail("(a) characterize_batch (cold) differs from characterize")
    steady_s = float(np.median(steady))
    speedup = serial_s / steady_s
    print(f"  (a) characterize_batch on {dev.type}: {len(specs)} 12-bit "
          f"specs x {n} samples, byte-equal to characterize; serial "
          f"{serial_s:.3f}s, batched cold {cold_s:.3f}s, steady median of "
          f"3 {steady_s:.4f}s ({', '.join(f'{s:.4f}' for s in steady)}); "
          f"steady speedup {speedup:.1f}x (the reference contract asks "
          f">= {ALLOC_CHAR_SPEEDUP:.0f}x: "
          f"{'met' if speedup >= ALLOC_CHAR_SPEEDUP else 'not met'})",
          flush=True)


def _selection_logits(torch, ev, assignments):
    return [ev.logits(a).to(torch.float32).cpu() for a in assignments]


def _singles(L, T):
    out = []
    for i in range(L):
        for t in range(T):
            a = [0] * L
            a[i] = t
            out.append(a)
    return out


def alloc_smoke(torch, dev):
    """(b) the smoke model: the device's truth table against the CPU's on
    the same weights and tokens, then the oracle and the search."""
    from repro_torch.core import allocate
    from repro_torch.models.transformer import LM

    cfg = _alloc_smoke_config()
    lm = LM(cfg, dev)
    params = lm.init(0)
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    kw = dict(tokens=toks, modules=ALLOC_SMOKE_MODULES, mode="hardware")
    t_b = time.perf_counter()
    ev = allocate.make_evaluator(lm, params=params, **kw)
    cpu = allocate.make_evaluator(LM(cfg, "cpu"),
                                  params=_to(torch, params, "cpu"), **kw)
    L, T = len(ev.modules), len(ev.candidates)
    singles = _singles(L, T)
    truth = ev.nmed_many(singles).reshape(L, T)
    want = cpu.nmed_many(singles).reshape(L, T)
    worst = {}
    for a, x, y in zip(singles, _selection_logits(torch, ev, singles),
                       _selection_logits(torch, cpu, singles)):
        tol = REF_TOL["exact" if not any(a) else "balanced"]
        d = float((x - y).abs().max())
        if not torch.isfinite(x).all() or d > tol:
            fail(f"(b) selection {a}: logits {d:.3e} from the CPU's "
                 f"(tolerance {tol})")
        worst[tol] = max(worst.get(tol, 0.0), d)
    if not (truth[:, 0] == 0).all() or not (truth[:, 1:] > 0).all():
        fail(f"(b) truth table {truth.tolist()}: the exact column must be "
             "0 and every approximate entry positive")
    rel = np.abs(truth - want) / np.maximum(want, 1e-30)
    if rel[:, 1:].max() > ALLOC_TRUTH_RTOL:
        fail(f"(b) truth table {truth.tolist()} vs the CPU's "
             f"{want.tolist()}: beyond rtol {ALLOC_TRUTH_RTOL}")
    names = [c.short_name() for c in ev.candidates]
    print(f"  (b) {cfg.name}, modules {ALLOC_SMOKE_MODULES}, tiers {names}: "
          f"single-module NMED on {dev.type} (CPU's in brackets), max rel "
          f"{rel[:, 1:].max():.3e} <= {ALLOC_TRUTH_RTOL}; logits max |d| "
          + ", ".join(f"{v:.3e} <= {k}" for k, v in sorted(worst.items())),
          flush=True)
    for i, m in enumerate(ev.modules):
        print(f"    {m.name:<7} " + ", ".join(
            f"{truth[i, j]:.6f} [{want[i, j]:.6f}]" for j in range(T)),
            flush=True)
    t = time.perf_counter()
    o = allocate.exhaustive_oracle(lm, ALLOC_BUDGET, evaluator=ev)
    o_s = time.perf_counter() - t
    t = time.perf_counter()
    a = allocate.autoallocate(lm, ALLOC_BUDGET, evaluator=ev)
    a_s = time.perf_counter() - t
    for what, r in (("oracle", o), ("autoallocate", a)):
        if r.nmed > ALLOC_BUDGET:
            fail(f"(b) {what} measured NMED {r.nmed} > {ALLOC_BUDGET}")
    if a.energy_per_mac_j > ALLOC_ENERGY_SLACK * o.energy_per_mac_j:
        fail(f"(b) autoallocate {a.energy_per_mac_j:.4g} J/MAC > "
             f"{ALLOC_ENERGY_SLACK} x the oracle's {o.energy_per_mac_j:.4g}")
    for what, r, s in (("oracle", o, o_s), ("autoallocate", a, a_s)):
        print(f"    {what} at {ALLOC_BUDGET}: {dict(r.tier_map)}, NMED "
              f"{r.nmed:.6e}, {r.energy_per_mac_j * 1e12:.4f} pJ/MAC "
              f"(FreePDK45 model; {100 * r.energy_saving:.1f}% below "
              f"exact), {r.evals} evaluations in {s:.2f}s", flush=True)
    print(f"    autoallocate / oracle energy "
          f"{a.energy_per_mac_j / o.energy_per_mac_j:.4f} <= "
          f"{ALLOC_ENERGY_SLACK}; (b) took {time.perf_counter() - t_b:.1f}s",
          flush=True)


def alloc_full(torch, cfg, params, dev):
    """(c) the search at the published width: the seven modules' truth
    table, then autoallocate at ALLOC_BUDGET and, while that is
    all-exact, at twice the smallest approximate single-module NMED (then
    twice that).  Returns the allocation, which runs at least one
    approximate multiplier."""
    from repro_torch.core import allocate
    from repro_torch.models.transformer import LM

    lm = LM(cfg, dev)
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    t = time.perf_counter()
    ev = allocate.make_evaluator(lm, params=params, tokens=toks,
                                 modules=ALLOC_MODULES, mode="hardware")
    build_s = time.perf_counter() - t
    L, T = len(ev.modules), len(ev.candidates)
    t = time.perf_counter()
    truth = ev.nmed_many(_singles(L, T)).reshape(L, T)
    truth_s = time.perf_counter() - t
    print(f"  (c) {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"modules {[m.name for m in ev.modules]}; evaluator built in "
          f"{build_s:.1f}s; single-module NMED ({L * T} evaluations in "
          f"{truth_s:.1f}s, tiers {[c.short_name() for c in ev.candidates]}):",
          flush=True)
    for i, m in enumerate(ev.modules):
        print(f"    {m.name:<7} k {m.k} n {m.n} " + ", ".join(
            f"{truth[i, j]:.6f}" for j in range(T)), flush=True)
    if not (truth[:, 0] == 0).all():
        fail(f"(c) an all-exact selection measured NMED {truth[:, 0]}")
    budget = ALLOC_BUDGET
    for attempt in range(ALLOC_RERUNS + 1):
        t = time.perf_counter()
        a = allocate.autoallocate(lm, budget, evaluator=ev)
        print(f"    autoallocate at {budget:.6e}: {a.evals} evaluations in "
              f"{time.perf_counter() - t:.1f}s; {a.report()}", flush=True)
        if a.nmed > budget:
            fail(f"(c) measured NMED {a.nmed} > budget {budget}")
        if any(family != "exact" for _, family, _, _ in a.alloc):
            return a
        budget = (2.0 * float(truth[:, 1:].min()) if attempt == 0
                  else 2.0 * budget)
    fail(f"(c) autoallocate returned all-exact up to budget {budget / 2}")


def alloc_serve(torch, cfg, params, a, power, dev):
    """(d) the ladder (exact, autoalloc) served; returns the launches of
    its first run (the main path)."""
    from repro_torch.core.compiler import CiMConfig
    from repro_torch.models.transformer import LM
    from repro_torch.serving import (SimClock, allocation_tier, build_engine,
                                     build_tiers, poisson_workload)

    tier = allocation_tier(a, mode="hardware")
    exact = [t for t in build_tiers(mode="hardware") if t.name == "exact"]
    t0 = time.perf_counter()
    eng = build_engine(cfg, params, tiers=tuple(exact) + (tier,),
                       slots_per_tier=4, max_len=32, prompt_buckets=(16,),
                       group_buckets=(1, 2, 4), seed=0, device=dev)
    eng.warmup()
    _sync(torch, dev)
    print(f"  (d) ladder (exact, autoalloc: NMED {tier.nmed:.6e}, "
          f"{tier.energy_per_mac_j * 1e12:.4f} pJ/MAC) built and warmed in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    wl = poisson_workload(ALLOC_REQUESTS, rate=20.0, vocab=cfg.vocab,
                          prompt_len=(8, 16), max_new=ALLOC_NEW,
                          tier_mix=ALLOC_MIX, seed=ALLOC_SEED)
    forwards = _count_forwards(eng)
    per_fwd = {}
    for _, family, _, ncols in a.alloc:
        k = _alloc_kernel(family, ncols, a.bits)
        if k is not None:
            per_fwd[k] = per_fwd.get(k, 0) + cfg.n_layers

    def run():
        t = time.perf_counter()
        res = eng.run(wl, clock=SimClock())
        _sync(torch, dev)
        if not all(r.done for r in res.values()):
            fail("(d) a request was not done")
        if {r.tier for r in res.values()} != {"exact", "autoalloc"}:
            fail(f"(d) tiers served: {sorted({r.tier for r in res.values()})}")
        if eng.steady_plan_misses() != 0:
            fail(f"(d) {eng.steady_plan_misses()} plan misses after warmup")
        return res, time.perf_counter() - t

    for k in forwards:
        forwards[k] = 0
    _reset_counts()
    res_a, secs = run()
    launches = _launch_counts()
    fw = dict(forwards)
    _expect_launches("(d) the allocation lane's run",
                     {k: v for k, v in launches.items() if v},
                     {k: v * fw["autoalloc"] for k, v in per_fwd.items()})
    eng.warmup()
    res_b, _ = run()
    if any(res_a[r.rid].tokens != res_b[r.rid].tokens for r in wl):
        fail("(d) the same workload served twice gave different tokens")
    print(f"    {len(wl)} requests, "
          f"{sum(len(r.tokens) for r in res_a.values())} tokens in "
          f"{secs:.1f}s (simulated clock), forwards {fw}, "
          f"launches {({k: v for k, v in launches.items() if v})} "
          f"({per_fwd} a forward of the allocation lane); no plan misses "
          "after warmup; served again: identical tokens", flush=True)

    # every module on the balanced tier's multiplier is the balanced tier
    bal = next(t for t in build_tiers(mode="hardware")
               if t.name == "balanced").cim
    table = tuple((m, bal.family, bal.compressor, bal.n_approx_cols)
                  for m in ALLOC_MODULES)
    toks = torch.as_tensor(np.stack([r.prompt[:8] for r in wl[:4]]),
                           device=dev)
    lens = torch.full((4,), 8, dtype=torch.int32, device=dev)
    out = []
    for cim in (CiMConfig(family="appro42", mode="hardware", alloc=table),
                bal):
        lm = LM(dataclasses.replace(cfg, cim=cim), dev)
        with torch.inference_mode():
            lg, caches = lm.prefill(params, {"tokens": toks, "lengths": lens,
                                             "max_len": 16})
            tok = lg[:, -1].argmax(-1, keepdim=True)
            dl, _ = lm.decode_step(params, caches, tok, lens)
        out.append((lg, dl))
    if not (torch.equal(out[0][0], out[1][0])
            and torch.equal(out[0][1], out[1][1])):
        fail("(d) an all-balanced alloc table's logits differ from the "
             "balanced tier's")
    print(f"    alloc table of all seven modules -> {table[0][1:]}: prefill "
          "and decode logits bitwise the balanced tier's", flush=True)

    b = eng.lanes["autoalloc"].backend
    b.reset()
    t = time.perf_counter()
    b.decode_round()
    _sync(torch, dev)
    dec = time.perf_counter() - t
    print(f"    autoalloc decode round (4 slots) {1e3 * dec:.1f} ms on "
          f"{power}", flush=True)
    _profile(torch, "autoalloc", b.decode_round, dec)
    b.reset()
    return launches


def alloc_phase(torch, power):
    """Phase 13: per-module accuracy allocation.  Returns the launches of
    (d)'s first served run."""
    from repro_torch.models.transformer import LM

    t_phase = time.perf_counter()
    dev = torch.device(ALLOC_DEVICE)
    alloc_characterize(torch, dev)
    alloc_smoke(torch, dev)
    cfg = _alloc_config()
    params = LM(cfg, dev).init(0)
    a = alloc_full(torch, cfg, params, dev)
    launches = alloc_serve(torch, cfg, params, a, power, dev)
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"  phase 13 took {time.perf_counter() - t_phase:.1f}s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 14: telemetry (obs/, launch/obs.py) at qwen3-1.7b's widths
# ---------------------------------------------------------------------------

# qwen3-1.7b's layers phase 14 serves (its checks hold at any depth)
OBS_LAYERS = 8
OBS_DEVICE = "cuda"


def _obs_config():
    from repro_torch.launch import obs

    return obs.config(OBS_LAYERS)


def obs_phase(torch, power):
    """Phase 14: launch/obs.py's two sections on the card.  The overhead
    runs (telemetry off and on in turn over one engine) are the phase's
    main path: tokens identical in every run (a), no plan built after
    warmup (b), live dispatch MACs = the meters' over the telemetry-on
    runs (c; all three checked inside `obs.overhead`), and exactly
    GEMMS_PER_LAYER x layers ``cim_gemm_fused`` launches a forward of
    the approximate lanes.  Then a decode round of each lane on the host
    clock and three profiled while the telemetry records: every
    approximate lane's profile must show the fused surrogate kernel (e).
    Then the trace section (d).  Returns the overhead runs' launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import obs
    from repro_torch.models.transformer import LM

    t_phase = time.perf_counter()
    dev = torch.device(OBS_DEVICE)
    cfg = _obs_config()
    full = get_config("qwen3-1.7b")
    if cfg.n_layers < full.n_layers:
        print(f"  CUT: {cfg.n_layers} of {full.n_layers} layers (widths "
              "unchanged)", flush=True)
    params = LM(cfg, dev).init(0)
    t = time.perf_counter()
    eng, tel = obs.overhead_engine(cfg, params, dev)
    _sync(torch, dev)
    print(f"  {cfg.name}: d_model {cfg.d_model}, {cfg.n_layers} layers; "
          f"{obs.MODE} ladder, telemetry attached, built and warmed in "
          f"{time.perf_counter() - t:.1f}s (energy meters profiled)",
          flush=True)
    wl = obs.overhead_workload(cfg)
    forwards = _count_forwards(eng)
    for k in forwards:
        forwards[k] = 0
    _reset_counts()
    t = time.perf_counter()
    ovh = obs.overhead(eng, tel, wl, dev)
    secs = time.perf_counter() - t
    launches = _launch_counts()
    fw = dict(forwards)
    per_fwd = GEMMS_PER_LAYER * cfg.n_layers
    _expect_launches("phase 14's overhead runs",
                     {k: v for k, v in launches.items() if v},
                     {"cim_gemm_fused":
                      per_fwd * (fw["balanced"] + fw["economy"])})
    print(f"  overhead ({secs:.1f}s): {len(ovh['pairs'])} off/on pairs over "
          f"one engine, {len(wl)} requests, {ovh['tokens']} tokens a run, "
          f"identical in every run; forwards {fw}, launches "
          f"{({k: v for k, v in launches.items() if v})} ({per_fwd} a "
          f"forward of balanced and economy); plan misses after warmup "
          f"{ovh['steady_plan_misses']}; MACs live {ovh['macs_live']:.0f} "
          f"= the meters' {ovh['macs_meters']:.0f}", flush=True)
    for i, p in enumerate(ovh["pairs"]):
        print(f"    pair {i}: tokens/s off {p['off']:.3f}, on {p['on']:.3f}, "
              f"on/off {p['on'] / p['off']:.4f}", flush=True)
    print(f"  on {power}: tokens/s off median "
          f"{ovh['tokens_per_s_off_median']:.3f}, on median "
          f"{ovh['tokens_per_s_on_median']:.3f}; on/off median "
          f"{ovh['ratio_median']:.4f} (spread {ovh['ratio_spread'][0]:.4f} - "
          f"{ovh['ratio_spread'][1]:.4f}): overhead "
          f"{100 * ovh['overhead_frac']:.2f}%, BENCH_obs's "
          f"{100 * obs.BOUND:.0f}% "
          f"{'met' if ovh['overhead_within_bound'] else 'missed'} (not "
          "gated); estimated J/token (FreePDK45 model) " + ", ".join(
              f"{n} {v:.6e}" for n, v in ovh["energy_per_token_j"].items()),
          flush=True)

    # where the time goes while recording: a pool decode round per lane
    for name, lane in eng.lanes.items():
        b = lane.backend
        b.reset()
        t = time.perf_counter()
        b.decode_round()
        _sync(torch, dev)
        dec = time.perf_counter() - t
        print(f"    {name:<9} decode round (4 slots) {1e3 * dec:.1f} ms on "
              f"{power}", flush=True)
        med = _profile(torch, name, b.decode_round, dec)
        if name != "exact" and (med is None or med["by_class"].get(
                "CiM surrogate kernel", 0.0) <= 0.0):
            fail(f"(e) {name}: no profile of its decode round showed the "
                 "fused surrogate kernel")
        b.reset()
    rnd = obs.round_ab(eng, tel, dev)
    print(f"  decode rounds, {obs.ROUND_PAIRS} adjacent off/on pairs a lane "
          f"on {power}: " + "; ".join(
              f"{n} off {d['off_ms_median']:.2f} ms, on/off "
              f"{d['ratio_median']:.4f} ({d['ratio_spread'][0]:.4f} - "
              f"{d['ratio_spread'][1]:.4f})" for n, d in rnd.items()),
          flush=True)
    tel.detach()
    del eng, tel
    gc.collect()

    t = time.perf_counter()
    eng, tel = obs.trace_engine(cfg, params, dev)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        trc = obs.trace(eng, tel, cfg, dev, os.path.join(tmp, "trace.json"))
    tel.detach()
    print(f"  trace ({time.perf_counter() - t:.1f}s, spec k = 2, sentinels, "
          f"a forced trip): {trc['spans']} spans "
          f"({', '.join(trc['span_names'])}), {trc['spans_dropped']} "
          f"dropped, {trc['trace_events']} trace events loaded back; trips "
          f"{[(d['lane'], d['reason']) for d in trc['trips']]}, "
          f"{trc['retries']} retries, {trc['n_failed']} failed; J/token "
          + ", ".join(f"{n} {v:.6e}"
                      for n, v in trc["energy_per_token_j"].items()),
          flush=True)
    del eng, tel, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"  phase 14 took {time.perf_counter() - t_phase:.1f}s", flush=True)
    return launches


# PyTorch ops whose kernels count as torch.matmul (cuBLAS names its
# kernels in several ways, so they are told by the op that launched them)
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def _kernel_class(name: str, matmul_kernels) -> str:
    low = name.lower()
    # the mesh path's GEMM partials (the conv partials share the conv tile
    # kernel's instantiations with the fused convs: "CiM conv kernel")
    if "quantintout" in low:
        return "CiM partial kernel"
    if "int8_mma_conv" in low:
        return "CiM conv kernel"
    if "surrogate_partial" in low:
        return "CiM surrogate partial"
    if "int8_mma_dense" in low or "surrogate_cluster" in low:
        return "CiM surrogate kernel"
    if "convsrc" in low or "conv_tile_kernel" in low:
        return "CiM conv kernel"
    if "lutcore" in low:
        return "CiM LUT kernel"
    if "nibblecore" in low:
        return "CiM nibble kernel"
    if "intsqcore" in low:
        return "CiM surrogate kernel"
    if "logcore" in low:
        return "CiM log kernel"
    if "attn_kernel" in low or "attn_cluster_kernel" in low:
        return "CiM attention kernel"
    if "slstm_kernel" in low or "slstm_cluster" in low:
        return "sLSTM scan"
    if name in matmul_kernels:
        return "torch.matmul"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other"


# the kernel classes of the port's own CUDA kernels (each launch counted
# by its wrapper's CudaKernel.launches)
PORT_CLASSES = ("CiM conv kernel", "CiM LUT kernel", "CiM nibble kernel",
                "CiM surrogate kernel", "CiM log kernel",
                "CiM attention kernel", "sLSTM scan", "CiM partial kernel",
                "CiM surrogate partial")


# this process's profiled calls: their count, and the seconds they took
# in all and beyond the calls themselves (the profiler's start, stop and
# the reading of its events), printed with the script's total; and how
# many of them lost records of their padding, and at most how many
PROFILE_COST = {"calls": 0, "s": 0.0, "beyond_s": 0.0, "pad_lost_calls": 0,
                "pad_lost_max": 0}
# A long-lived process's profiler loses the first records of a session
# now and then: in whole runs on an H100 phase 14's decode rounds showed
# 32-40 fewer kernels than the same rounds profiled in a fresh process,
# the same count in every profile of a run, and once that count passed
# the round's first fused GEMM (its ~35th kernel) every profile of the
# lane lost it.  Each profiled call is framed by PROFILE_PAD one-thread
# spin kernels (torch.cuda._sleep) on either side, inside the session and
# outside the call's CUDA events; they take such losses and are left out
# of everything a profile reports.
PROFILE_PAD = 128
PAD_KERNEL = "spin_kernel"


def _profile_read(prof):
    """What `_profile_once` reads of a finished torch.profiler run, from
    its raw events: as the profiler's own event list (`prof.events()`)
    gives it, the same names filtered out and demangled, a runtime event
    on the thread of the op it was linked to, an event's parent the
    innermost synchronous CPU event around it on its thread; but without
    building that list, which costs ~2 s of host time for a decode
    round's ~25,000 events.  Returns the device events as (name, start
    ns, end ns), the count of top-level aten ops, and the names of the
    kernels that MATMUL_OPS launched."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    names = {}

    def name(raw):
        if raw not in names:
            names[raw] = _rewrite_name(name=raw, with_wildcard=True)
        return names[raw]

    evs = [(name(e.name()), e) for e in prof.profiler.kineto_results.events()
           if not _filter_name(e.name())
           and not getattr(e, "is_hidden_event", lambda: False)()]
    cpu = [(n, e, not e.is_async()
            and e.start_thread_id() == e.end_thread_id())
           for n, e in evs if e.device_type() == DeviceType.CPU]
    thread, matmul_ids = {}, set()
    for n, e, sync in cpu:
        if sync and not e.linked_correlation_id():
            thread[e.correlation_id()] = e.start_thread_id()
            if n in MATMUL_OPS:
                matmul_ids.add(e.correlation_id())
    stacks, n_ops = {}, 0
    tree = [(thread.get(e.linked_correlation_id(), e.start_thread_id())
             if e.linked_correlation_id() else e.start_thread_id(),
             e.start_ns(), -e.end_ns(), i, n)
            for i, (n, e, sync) in enumerate(cpu) if sync]
    for th, start, neg_end, _, n in sorted(tree):
        stack = stacks.setdefault(th, [])
        while stack and (start >= stack[-1] or -neg_end > stack[-1]):
            stack.pop()
        n_ops += not stack and n.startswith("aten::")
        stack.append(-neg_end)
    n_ops += sum(1 for n, _, sync in cpu
                 if not sync and n.startswith("aten::"))
    dev = [(n, e.start_ns(), e.end_ns(), e.linked_correlation_id())
           for n, e in evs if e.device_type() == DeviceType.CUDA]
    return ([(n, s, t) for n, s, t, _ in dev], n_ops,
            {n for n, _, _, link in dev if link in matmul_ids})


def _profile_once(torch, run):
    """One call of `run` under torch.profiler, with CUDA events around it:
    a dict of the host ms, the top-level ops, the kernels, the device
    busy ms (the union of the kernels' intervals; None if no kernel was
    seen), the event span ms (first to last event on the stream), device
    time by kernel class and by kernel, and the port's kernels the call
    launched (its launch counters) against those the profiler saw.  Its
    cost is added to PROFILE_COST."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t_all = time.perf_counter()
    counts0 = _launch_counts()
    before = sum(counts0.values())
    start = torch.cuda.Event(enable_timing=True)
    end_ev = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(0)
        t = time.perf_counter()
        start.record()
        run()
        end_ev.record()
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    counts1 = _launch_counts()
    launched = sum(counts1.values()) - before
    kern, n_ops, matmul_kernels = _profile_read(prof)
    pads = sum(PAD_KERNEL in n for n, _, _ in kern)
    kern = [k for k in kern if PAD_KERNEL not in k[0]]
    if pads < 2 * PROFILE_PAD:
        PROFILE_COST["pad_lost_calls"] += 1
        PROFILE_COST["pad_lost_max"] = max(PROFILE_COST["pad_lost_max"],
                                           2 * PROFILE_PAD - pads)
    busy_ns, end = 0, float("-inf")
    for s, e in sorted((s, e) for _, s, e in kern):
        if e > end:
            busy_ns += e - max(s, end)
            end = e
    by_class, by_name, seen, port_names = {}, {}, 0, {}
    for name, s, e in kern:
        us = (e - s) / 1e3
        c = _kernel_class(name, matmul_kernels)
        by_class[c] = by_class.get(c, 0.0) + us
        by_name[name] = by_name.get(name, 0.0) + us
        seen += c in PORT_CLASSES
        if c in PORT_CLASSES:
            port_names[name] = port_names.get(name, 0) + 1
    took_s = time.perf_counter() - t_all
    PROFILE_COST["calls"] += 1
    PROFILE_COST["s"] += took_s
    PROFILE_COST["beyond_s"] += took_s - wall_ms / 1e3
    return {"wall_ms": wall_ms, "n_ops": n_ops, "n_kern": len(kern),
            "busy_ms": busy_ns / 1e6 if kern else None,
            "span_ms": start.elapsed_time(end_ev), "by_class": by_class,
            "by_name": by_name, "launched": launched, "seen": seen,
            "port_names": port_names,
            "launched_by": {k: v - counts0[k] for k, v in counts1.items()
                            if v != counts0[k]}}


def _profile(torch, lane: str, run, unprofiled_s: float, reps: int = 3,
             made=None):
    """`reps` calls of `run` (a pool decode round, a CNN forward, a decode
    step), each under torch.profiler (or, with `made`, the records of
    `_profile_once` another process made, taken in order; phase 9's rank
    0): the Python-level PyTorch ops it
    dispatched, the kernels it launched, the union of their device
    intervals against the call's time (the device's idle share) and
    against the CUDA events' span, as the median and the spread (min -
    max) of the calls, and device time by kernel class and by kernel of
    the median call.  A profile that lost kernels (no kernel at all, or
    fewer of the port's kernels than its launch counters say the call
    launched: CUPTI drops some now and then) is not a measurement: it is
    printed, left out of the median, and made again, at most twice more.
    Returns the median call's record, None if every profile lost
    kernels."""
    runs, attempts = [], 0
    while len(runs) < reps and attempts < reps + 2:
        if made is not None and attempts == len(made):
            break
        attempts += 1
        r = (_profile_once(torch, run) if made is None
             else made[attempts - 1])
        if r["busy_ms"] is None or r["seen"] < r["launched"]:
            print(f"    {lane:<9} profile {attempts} lost kernels: it saw "
                  f"{r['seen']} of the {r['launched']} port kernels the call "
                  f"launched ({r['n_kern']} kernels in all, busy "
                  f"{r['busy_ms']} ms, event span {r['span_ms']:.2f} ms); "
                  f"left out; launched {r.get('launched_by')}, seen "
                  f"{r.get('port_names')}", flush=True)
            continue
        runs.append(r)
    dropped = attempts - len(runs)
    if not runs:
        print(f"    {lane:<9} {attempts} profiled runs: device time not "
              f"measured (every profile lost kernels)", flush=True)
        return None
    runs.sort(key=lambda r: r["busy_ms"])
    med = runs[len(runs) // 2]
    busy = [r["busy_ms"] for r in runs]
    span = sorted(r["span_ms"] for r in runs)
    idle = sorted(100 * (1 - r["busy_ms"] / r["wall_ms"]) for r in runs)
    print(f"    {lane:<9} {len(runs)} profiled runs: median "
          f"{med['wall_ms']:.1f} ms host clock ({1e3 * unprofiled_s:.1f} ms "
          f"unprofiled), {med['n_ops']} top-level ops, {med['n_kern']} "
          f"kernels ({med['seen']} of the port's, its counters "
          f"{med['launched']}); device busy median {med['busy_ms']:.2f} ms "
          f"(spread {min(busy):.2f} - {max(busy):.2f}), CUDA-event span "
          f"median {span[len(span) // 2]:.2f} ms (spread {span[0]:.2f} - "
          f"{span[-1]:.2f}), idle median {idle[len(idle) // 2]:.1f}% "
          f"(spread {idle[0]:.1f} - {idle[-1]:.1f}%) of the profiled runs, "
          f"{100 * max(0.0, 1 - med['busy_ms'] / (1e3 * unprofiled_s)):.1f}"
          f"% of the unprofiled one; {dropped} profile(s) left out",
          flush=True)
    print("      by class (ms, median run): " + ", ".join(
        f"{c} {us / 1e3:.2f}" for c, us in
        sorted(med["by_class"].items(), key=lambda kv: -kv[1])), flush=True)
    for n, us in sorted(med["by_name"].items(), key=lambda kv: -kv[1])[:5]:
        print(f"      {us / 1e3:8.3f} ms  {n[:110]}", flush=True)
    return med


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _shape_key(r):
    """A timed row's shape for the kernels line, led by its path or
    variant where the kernel has several."""
    where = r.get("path") or r.get("variant")
    dims = list(r["shape"] if "shape" in r else r["geometry"])
    return [where, *dims] if where else dims


LAST_PHASE = 14


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="serve only this many layers (0 = all 28)")
    ap.add_argument("--phases", type=int, nargs="+", default=None,
                    metavar="N",
                    help=f"run phases 1, 2 and these of 3-{LAST_PHASE} "
                         "only, and print no result lines (default: all)")
    args = ap.parse_args(argv)
    if args.phases is not None and not set(args.phases) <= set(
            range(3, LAST_PHASE + 1)):
        ap.error(f"--phases takes phases 3 to {LAST_PHASE}")
    return args


def main():
    args = parse_args()

    def want(n):
        return args.phases is None or n in args.phases
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
    built = build.build(build.SOURCES)
    for name, (secs, report) in built.items():
        print(f"  {name}.cu: {secs:.1f}s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"    {line.strip()}")
    print(f"  {len(built)} sources built in {time.perf_counter() - t0:.1f}s",
          flush=True)
    log_clocks(build)
    tensor_core_check(build)
    nibble_int_check(build)
    attn_instances_check(build)

    def took(n, t):
        print(f"  phase {n} took {time.perf_counter() - t:.1f}s", flush=True)

    if want(3):
        print("[3] kernels against their plain versions", flush=True)
        t3 = time.perf_counter()
        rows = check_kernels(torch, sms, clock_hz)
        conv_rows = check_conv(torch, sms, clock_hz)
        partial_rows = check_partials(torch, sms, clock_hz)
        attn_rows = check_attention(torch, sms, clock_hz)
        surr_rows = check_surrogate(torch, sms, clock_hz)
        slstm_rows = check_slstm(torch, sms, clock_hz)
        took(3, t3)

    if want(4):
        print("[4] reference: the LM on the card against the CPU", flush=True)
        t4 = time.perf_counter()
        check_reference(torch)
        check_norm_rows(torch)
        took(4, t4)

    if want(5):
        print("[5] serve", flush=True)
        t5 = time.perf_counter()
        launches = serve(torch, args.layers, power, attn=False)
        gc.collect()                      # phase 5's engine is gone
        torch.cuda.empty_cache()
        took(5, t5)

    if want(6):
        print("[6] serve with CiM attention", flush=True)
        t6 = time.perf_counter()
        attn_launches = serve(torch, 0, power, attn=True)
        gc.collect()                      # phase 6's engine is gone
        torch.cuda.empty_cache()
        took(6, t6)

    if want(7):
        print("[7] Table IV on the card", flush=True)
        cnn_launches, _ = table4(torch)
        gc.collect()
        torch.cuda.empty_cache()

    if want(8):
        print("[8] surrogate: the compiler's default mode", flush=True)
        t8 = time.perf_counter()
        surr_launches = surrogate_macro(torch)
        serve_launches = serve(torch, 0, power, attn=False, mode="surrogate")
        gc.collect()                      # phase 8's engine is gone
        torch.cuda.empty_cache()
        conv_launches = surrogate_conv(torch)
        for k, v in serve_launches.items():
            surr_launches[k] += v + conv_launches[k]
        gc.collect()
        torch.cuda.empty_cache()
        took(8, t8)

    if want(9):
        print("[9] mesh: (data 2, model 2) on four gloo ranks", flush=True)
        t9 = time.perf_counter()
        mesh_launches = mesh_phase(torch, power)
        print(f"  phase 9 took {time.perf_counter() - t9:.1f}s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()

    if want(10):
        print("[10] xlstm-125m: prefill and lockstep decode on the hardware "
              "ladder", flush=True)
        xlstm_launches = xlstm_phase(torch, power)
        gc.collect()
        torch.cuda.empty_cache()

    if want(11):
        print("[11] speculative decoding and per-token scales", flush=True)
        spec_launches, spec_checks = spec_phase(torch, power, sms, clock_hz)
        gc.collect()
        torch.cuda.empty_cache()

    if want(12):
        print("[12] fault injection and lane sentinels", flush=True)
        fault_launches, fault_checks, mag_rows = fault_phase(
            torch, power, sms, clock_hz)
        gc.collect()
        torch.cuda.empty_cache()

    if want(13):
        print("[13] per-module allocation", flush=True)
        alloc_launches = alloc_phase(torch, power)
        gc.collect()
        torch.cuda.empty_cache()

    if want(14):
        print("[14] telemetry", flush=True)
        obs_launches = obs_phase(torch, power)
    if args.phases is not None:
        print(f"  phases 1, 2 and {args.phases} passed in "
              f"{time.perf_counter() - t_start:.1f}s (a partial run: no "
              "result lines)", flush=True)
        return

    kernels = []
    # the GEMM rows sum the eight LM shapes and, for the fused forms (the
    # CNN's fc, f32 operands) and the nibble rows, the CNN's fc shape,
    # with the launches of the main paths that run them (5: the LM
    # ladder, 7: the CNN, 8: the surrogate macro, ladder and convs, 9: the
    # mesh frontends and the mesh ladder, 10: the xLSTM ladder, 11: the
    # per-token GEMMs, the per-token lanes' decode_multi, and the spec
    # engine's drafter, 12: the faulted ladder's run, 13: the allocation
    # lane's first served run, 14: the telemetry's overhead runs;
    # `check_launches`:
    # phase 11's calls held against those, the M = 4 and M = 64 GEMMs and
    # the sequential decode_steps, and phase 12's (a) and (d)); the
    # partial rows the shard-local
    # shapes (phase 9's launches); the
    # conv rows the CNN's five geometries on the families' variants; the
    # attention rows the serving decode and prefill geometries on the
    # paths the ladder runs (lut for balanced, log for economy); the
    # surrogate rows the eight LM shapes, cim_gemm_fused both as phase 8
    # serves them (bf16, no noise) and as its macro runs them (f32, with
    # noise), cim_gemm_core without SQ (the form torch._int_mm computes,
    # at the shapes it accepts: library_shapes)
    main = {}
    for name, rs in rows.items():
        fc = name.startswith("nibble") or name.endswith("fused")
        shapes = MAIN_SHAPES + ([CNN_FC] if fc else [])
        main[name] = ([r for r in rs if r["shape"] in shapes],
                      launches[name] + cnn_launches[name]
                      + mesh_launches[name] + xlstm_launches[name]
                      + spec_launches.get(name, 0)
                      + fault_launches.get(name, 0)
                      + alloc_launches.get(name, 0))
    for name, rs in conv_rows.items():
        main[name] = ([r for r in rs if r["main"]],
                      cnn_launches[name] + surr_launches[name]
                      + mesh_launches[name])
    # the partials: the shard-local shapes, launched on phase 9's mesh path
    # (cim_gemm_partial by its surrogate ladder and shard GEMMs)
    for name, rs in partial_rows.items():
        main[name] = (rs, mesh_launches[name])
    for name, rs in attn_rows.items():
        main[name] = ([r for r in rs if "ms" in r and r["path"] in
                       ("lut", "log")], attn_launches[name])
    for name, rs in surr_rows.items():
        main[name] = ([r for r in rs if r["main"]],
                      surr_launches[name] + obs_launches.get(name, 0)
                      + mesh_launches.get(name, 0))
    # the sLSTM recurrence: the full-width cases (xlstm-125m's 4 heads of
    # 192 at batch 4, T = 1, 37, 512, from zero and from a state), launched
    # on phase 10's path
    main["slstm_scan"] = ([r for r in slstm_rows["slstm_scan"]
                           if r["shape"] in SLSTM_FULL and "ms" in r],
                          xlstm_launches["slstm_scan"])
    # the faulted table's form of lut_matmul: the eight LM shapes, launched
    # on phase 12's faulted balanced lane
    main["lut_matmul_mag"] = (mag_rows, fault_launches.get("lut_matmul_mag",
                                                           0))
    every = {**rows, **conv_rows, **attn_rows, **surr_rows, **partial_rows,
             **slstm_rows, "lut_matmul_mag": mag_rows}
    checks = {k: spec_checks.get(k, 0) + fault_checks.get(k, 0)
              for k in set(spec_checks) | set(fault_checks)}
    for name, (timed, n_launch) in main.items():
        ops_ms = sum(r["bound_ms"] for r in timed
                     if r["bound_by"] == "operations")
        bytes_ms = sum(r["bound_ms"] for r in timed
                       if r["bound_by"] == "bytes")
        lib = [r for r in timed if r.get("library_ms") is not None]
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": n_launch,
            "max_abs_err": max(r["max_abs_err"] for r in every[name]),
            "ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": (sum(r["library_ms"] for r in lib) if lib
                           else None),
            "bound_share": (sum(r["bound_ms"] for r in timed)
                            / sum(r["ms"] for r in timed)),
            "shapes": [_shape_key(r) for r in timed],
        })
        if checks.get(name):
            kernels[-1]["check_launches"] = checks[name]
        if timed and all("warm_ms" in r for r in timed):
            kernels[-1]["warm_ms"] = sum(r["warm_ms"] for r in timed)
        if timed and all("template_ms" in r for r in timed):
            kernels[-1]["template_ms"] = sum(r["template_ms"] for r in timed)
        if name in conv_rows:          # each variant's row sum apart
            var = {}
            for r in timed:
                var[r["variant"]] = var.get(r["variant"], 0.0) + r["ms"]
            kernels[-1]["variants"] = var
        if lib and len(lib) != len(timed):
            kernels[-1]["library_shapes"] = [list(r["shape"]) for r in lib]
            kernels[-1]["ms_library_shapes"] = sum(r["ms"] for r in lib)
    print(f"  total {time.perf_counter() - t_start:.1f}s; of it "
          f"{PROFILE_COST['calls']} profiled calls in this process "
          f"{PROFILE_COST['s']:.1f}s, {PROFILE_COST['beyond_s']:.1f}s of "
          "that beyond the calls themselves; "
          f"{PROFILE_COST['pad_lost_calls']} of them lost records of their "
          f"padding, at most {PROFILE_COST['pad_lost_max']} of "
          f"{2 * PROFILE_PAD}", flush=True)
    print(power)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
