"""LUT-gather GEMMs: CUDA kernels for Hopper and their plain versions.

The compiled CiM macro *is* a product LUT (core/luts.py); these
functions execute it, in the JAX package's two table layouts:

  * the **full table** — ``lut_matmul`` (int8 operands -> int32, the
    oracle surface) and ``lut_matmul_fused`` (f32 or bf16 operands ->
    f32, with the per-tensor ``sx`` / per-column ``sw`` quantization on
    load and the ``(acc * sx) * sw`` epilogue inside one kernel), over
    the int16 signed-product table of kernels/ops.py (the 8-bit table
    fits shared memory only as int16; every entry is checked to fit);
    ``lut_matmul_mag``, the int form over the table of magnitude
    products as uint16, the signs restored from the operands: the form
    of a faulted table (core/faults.py), whose entries do not fit int16;
  * the **nibble sub-tables** — ``nibble_lut_matmul`` and
    ``nibble_lut_matmul_fused``, the same two forms over four
    2^{b/2} x 2^{b/2} int32 sub-tables on saturated magnitudes, for the
    half-word-decomposable multipliers (core/luts.nibble_sub_luts);
  * the **partial** forms ``lut_matmul_partial`` and
    ``nibble_lut_matmul_partial`` — the fused forms with the epilogue
    off: f32 or bf16 operands quantized on load against caller-supplied
    (global) scales, the raw int32 (M, N) sum out.  The mesh path runs
    them on a shard's slice of K and sums the shards' partials, exactly,
    before the ``(acc * sx) * sw`` epilogue.

On CUDA tensors each launches its kernel (csrc/lut_gemm.cu,
csrc/nibble_gemm.cu) or raises; on CPU tensors it runs the plain PyTorch
version beside it, which repeats the kernel's arithmetic
(kernels/ref.py).  Every form (and the log forms of mitchell_gemm.py up
to 8 bits) launches the split-K cluster kernel of csrc/cluster_gemm.cuh,
cut by ``cluster_plan``: the fused forms quantize on load and flush the
epilogue, the partial forms quantize and write the raw int32 sum, the
int forms (``lut_matmul``, ``lut_matmul_mag``, ``nibble_lut_matmul``)
take int8 operands and write the raw int32 sum (the nibble forms fold
the four sub-tables into two signed ones, two gathers a product; the
nibble int form saturates its operands' magnitudes at qmax in the
kernel, as the reference does).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from .build import INT, PTR, CudaKernel, on_cuda, query, require, stream_of
from .ref import (gather_full, lut_matmul_ref, nibble_matmul_ref,
                  nibble_sum, quantize_tile)

# every form is the split-K cluster kernel: its operands (int8 x, w, the
# table, out; or float x, x_bf16, w, w_bf16, the table, sx, sw, out), M, K,
# N, bits, then the launch plan (rows, splits, k_split) and the stream
_PLAN_ARGS = [INT, INT, INT]
_INT_ARGS = [PTR, PTR, PTR, PTR, INT, INT, INT, INT] + _PLAN_ARGS + [PTR]
_FUSED_ARGS = [PTR, INT, PTR, INT, PTR, PTR, PTR, PTR, INT, INT, INT,
               INT] + _PLAN_ARGS + [PTR]
_INT = CudaKernel("lut_gemm", "lut_gemm_int8_cluster", _INT_ARGS)
_INT_MAG = CudaKernel("lut_gemm", "lut_gemm_int8_mag_cluster", _INT_ARGS)
_FUSED = CudaKernel("lut_gemm", "lut_gemm_fused", _FUSED_ARGS)
_PARTIAL = CudaKernel("lut_gemm", "lut_gemm_partial", _FUSED_ARGS)
_NIB_INT = CudaKernel("nibble_gemm", "nibble_gemm_int8_cluster", _INT_ARGS)
_NIB_FUSED = CudaKernel("nibble_gemm", "nibble_gemm_fused", _FUSED_ARGS)
_NIB_PARTIAL = CudaKernel("nibble_gemm", "nibble_gemm_partial", _FUSED_ARGS)

# the kernels of this module by wrapper name (chip_smoke.py reads and
# resets their launch counts)
KERNELS = {"lut_matmul": _INT, "lut_matmul_mag": _INT_MAG,
           "lut_matmul_fused": _FUSED,
           "lut_matmul_partial": _PARTIAL,
           "nibble_lut_matmul": _NIB_INT,
           "nibble_lut_matmul_fused": _NIB_FUSED,
           "nibble_lut_matmul_partial": _NIB_PARTIAL}

_FLOATS = (torch.float32, torch.bfloat16)

# the split-K cluster kernel (csrc/cluster_gemm.cuh): a block owns
# CLUSTER_ROWS[i] rows and CLUSTER_BN columns and walks one slice of K, a
# multiple of CLUSTER_BK (its stages: 64 k for bf16 and int8 operands, 32
# where either is f32); the slices of a tile, at most CLUSTER_MAX_SPLITS,
# form one thread-block cluster
CLUSTER_ROWS = (4, 16, 64)
CLUSTER_BN, CLUSTER_BK, CLUSTER_MAX_SPLITS = 64, 64, 8
# the nibble forms' row tiles (ClusterNibbleCore::MAX_ROWS): a prefill's
# rows in 16-row tiles, two blocks an SM (on an H100 a 64-row tile ran
# 1.2x slower at M = 64: launch/cluster_sweep.py --only nibble)
NIBBLE_ROWS = (4, 16)
# the magnitude form's row tiles (ClusterMagLutCore::MAX_ROWS): two
# registers a staged weight element leave 64 accumulators no room
MAG_ROWS = (4, 16)
# the row tiles of each cluster kernel entry that has its own
ROW_TILES = {"nibble_gemm_fused": NIBBLE_ROWS,
             "nibble_gemm_partial": NIBBLE_ROWS,
             "nibble_gemm_int8_cluster": NIBBLE_ROWS,
             "lut_gemm_int8_mag_cluster": MAG_ROWS}
# a block's fixed cost (prologue, table, partial sums) in K steps, in the
# plan's cost
_BLOCK_STEPS = 2


class ClusterPlan(NamedTuple):
    rows: int       # output rows a block (one of the kernel's row tiles)
    tiles: int      # output tiles: ceil(M / rows) x ceil(N / CLUSTER_BN)
    splits: int     # K slices a tile, one cluster (1..CLUSTER_MAX_SPLITS)
    k_split: int    # K a slice, a multiple of CLUSTER_BK


def cluster_plan(m: int, k: int, n: int,
                 capacity: Callable[[int, int], int],
                 row_tiles: Sequence[int] = CLUSTER_ROWS) -> ClusterPlan:
    """How one (M, K) x (K, N) call of a split-K cluster kernel is cut.

    The rows a block are the fewest of `row_tiles` (the kernel's row
    tiles, ascending: CLUSTER_ROWS for csrc/cluster_gemm.cuh) that hold M
    (the largest past it, the tiles then repeat over M).
    ``capacity(rows, splits)`` is the number of clusters of `splits`
    blocks the card holds at once (a cluster's blocks share one GPC, so
    it is not the SM count over the cluster size; 0: none fits).  K is
    split into the slices that minimize waves x (steps a slice +
    _BLOCK_STEPS), a wave being ``capacity`` clusters; ties go to fewer
    slices.  Every slice holds at
    least one step: ``splits * k_split >= K > (splits - 1) * k_split``
    (one slice for K = 0)."""
    rows = next((r for r in row_tiles if m <= r), row_tiles[-1])
    tiles = -(-m // rows) * -(-n // CLUSTER_BN)
    steps = -(-k // CLUSTER_BK)
    best = None
    for want in range(1, min(CLUSTER_MAX_SPLITS, steps) + 1):
        per = -(-steps // want)
        splits = -(-steps // per)
        held = capacity(rows, splits)
        if held <= 0:
            continue
        cost = -(-tiles // held) * (per + _BLOCK_STEPS)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    if best is None and steps:
        raise ValueError(f"no cluster of the kernel for {rows} rows fits "
                         "the device")
    _, splits, per = best or (0, 1, 1)
    return ClusterPlan(rows, tiles, splits, per * CLUSTER_BK)


@functools.lru_cache(maxsize=None)
def _capacity(library: str, symbol: str, device: int, args: tuple,
              rows: int, splits: int) -> int:
    """The C capacity query `symbol` (csrc/cluster_gemm.cuh
    cluster_capacity, csrc/surrogate_cluster.cuh sg_capacity) of `rows`
    and `splits` on CUDA device `device`, `args` the query's arguments
    between them; cached."""
    with torch.cuda.device(device):
        return query(library, symbol, rows, *args, splits)


def fused_plan(kern: CudaKernel, x, w, *lead,
               row_tiles: Optional[Sequence[int]] = None) -> ClusterPlan:
    """The plan of one call of the split-K cluster kernel `kern` on x's
    device, cut by the device's cluster capacity (its C query
    ``<symbol>_capacity``, of the instantiation `kern` launches, whose
    arguments after the rows are `lead`, then, for float operands,
    x_bf16 and w_bf16 (an int form's query takes int8 alone): the bits
    of lut_gemm_fused, nibble_gemm_fused, their partial forms and the int
    LUT, magnitude and nibble forms, the log forms' bits and compensated, cim_gemm_fused's
    variant), over the entry's row tiles (`row_tiles`, else ROW_TILES or
    CLUSTER_ROWS)."""
    if row_tiles is None:
        row_tiles = ROW_TILES.get(kern.symbol, CLUSTER_ROWS)
    m, k = x.shape
    args = lead if x.dtype == torch.int8 else (
        *lead, int(x.dtype == torch.bfloat16),
        int(w.dtype == torch.bfloat16))
    dev = x.device.index if x.device.index is not None else 0
    return cluster_plan(m, k, w.shape[1], functools.partial(
        _capacity, kern.library, kern.symbol + "_capacity", dev, args),
        row_tiles)


def launch_cluster(kern: CudaKernel, x, w, table, sx, sw, m, k, n, bits,
                   *flags, out_dtype=torch.float32) -> torch.Tensor:
    """One planned launch of the cluster kernel: x (M,K), w (K,N) ->
    (M,N) of `out_dtype`: f32/bf16 operands to f32 for a fused form, to
    int32 for a partial one (its epilogue off); int8 operands to int32
    for an int form (no scales: `sx`, `sw` None).  `table` the LUT, the
    magnitude table or the nibble sub-tables, None for the log kernel;
    `flags` its trailing int arguments before the plan (compensated)."""
    plan = fused_plan(kern, x, w, bits, *flags)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    tab = () if table is None else (table.data_ptr(),)
    if x.dtype == torch.int8:
        operands = (x.data_ptr(), w.data_ptr(), *tab)
    else:
        operands = (x.data_ptr(), int(x.dtype == torch.bfloat16),
                    w.data_ptr(), int(w.dtype == torch.bfloat16), *tab,
                    sx.data_ptr(), sw.data_ptr())
    kern(*operands, out.data_ptr(), m, k, n, bits, *flags, plan.rows,
         plan.splits, plan.k_split, stream_of(x))
    return out


def _shapes(x: torch.Tensor, w: torch.Tensor):
    require(x.dim() == 2 and w.dim() == 2,
            f"2-D operands expected, got {tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    k2, n = w.shape
    require(k == k2, f"contraction mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    return m, k, n


def check_table(lut: torch.Tensor, bits: int) -> None:
    """The int16 full table, as every full-LUT kernel takes it."""
    require(2 <= bits <= 8, f"the LUT kernel takes 2..8-bit operands, got {bits}")
    require(lut.dtype == torch.int16 and lut.is_contiguous()
            and lut.numel() == 1 << (2 * bits),
            f"table must be {1 << (2 * bits)} contiguous int16 entries")
    require(lut.data_ptr() % 16 == 0, "table must be 16-byte aligned")


def mag_entries(bits: int) -> int:
    """Entries of the magnitude table as `lut_matmul_mag` takes it: the
    2^{b-1} x 2^{b-1} magnitude products, zero-padded to 16 bytes (the
    kernel copies its table in 16-byte words)."""
    return max(1 << (2 * (bits - 1)), 8)


def check_mag_table(mag: torch.Tensor, bits: int) -> None:
    """The uint16 magnitude table, as the magnitude-table kernel takes it."""
    require(2 <= bits <= 8, f"the LUT kernel takes 2..8-bit operands, got {bits}")
    require(mag.dtype == torch.uint16 and mag.is_contiguous()
            and mag.numel() == mag_entries(bits),
            f"magnitude table must be {mag_entries(bits)} contiguous uint16 "
            "entries")
    require(mag.data_ptr() % 16 == 0, "table must be 16-byte aligned")


def signed_from_magnitude(mag_flat: torch.Tensor, bits: int) -> torch.Tensor:
    """The flat (2^{2b},) int32 signed table of a magnitude table: entry
    (a + 2^{b-1}, b + 2^{b-1}) = sign(a) sign(b) mag[min(|a|, qmax),
    min(|b|, qmax)], the construction of core/luts.signed_product_lut
    and core/faults.faulted_signed_lut_flat."""
    half = 1 << (bits - 1)
    # uint16 widened through its int16 view (casts of uint16 itself are
    # not supported on every device)
    m = (mag_flat[:half * half].view(torch.int16).to(torch.int32)
         & 0xFFFF).reshape(half, half)
    vals = torch.arange(-half, half, device=mag_flat.device)
    mags = torch.clamp(vals.abs(), max=half - 1)
    signs = torch.sign(vals).to(torch.int32)
    return (m[mags][:, mags] * signs[:, None] * signs[None, :]).reshape(-1)


def check_subs(subs: torch.Tensor, bits: int) -> None:
    """The four nibble sub-tables, as every nibble kernel takes them."""
    require(2 <= bits <= 8 and bits % 2 == 0,
            f"the nibble kernels take 2..8-bit operands of even width, got "
            f"{bits}")
    require(subs.dtype == torch.int32 and subs.is_contiguous()
            and subs.numel() == 4 << bits,
            f"sub-tables must be {4 << bits} contiguous int32 entries")
    require(subs.data_ptr() % 16 == 0, "sub-tables must be 16-byte aligned")


def _check_range(t: torch.Tensor, bits: int) -> None:
    """Operands index the table, so they must lie in [-2^{b-1}, 2^{b-1})
    (always so for int8 at 8 bits, which needs no reduction)."""
    if (t.dtype == torch.int8 and bits == 8) or t.numel() == 0:
        return
    half = 1 << (bits - 1)
    require(-half <= int(t.min()) and int(t.max()) < half,
            f"{bits}-bit operands must lie in [{-half}, {half})")


# ---------------------------------------------------------------------------
# plain versions of the fused and partial forms (the int forms' are
# ref.lut_matmul_ref and ref.nibble_matmul_ref); CPU tensors, and
# chip_smoke.py also runs them on the card.  A partial form is its fused
# form without the epilogue.
# ---------------------------------------------------------------------------


def epilogue(acc, sx, sw) -> torch.Tensor:
    """(acc * sx) * sw in that order: the int32 sum in real units."""
    return ((acc.to(torch.float32) * sx.reshape(()).to(torch.float32))
            * sw.reshape(1, -1).to(torch.float32))


def lut_matmul_partial_plain(x, w, lut_flat, sx, sw,
                             bits: int = 8) -> torch.Tensor:
    half = 1 << (bits - 1)
    ia = quantize_tile(x.to(torch.float32), sx.reshape(()).float(),
                       half - 1) + half
    ib = quantize_tile(w.to(torch.float32), sw.reshape(1, -1).float(),
                       half - 1) + half
    return gather_full(lut_flat, ia, ib, 1 << bits)


def lut_matmul_fused_plain(x, w, lut_flat, sx, sw,
                           bits: int = 8) -> torch.Tensor:
    return epilogue(lut_matmul_partial_plain(x, w, lut_flat, sx, sw, bits),
                    sx, sw)


def nibble_lut_matmul_partial_plain(x, w, subs_flat, sx, sw,
                                    bits: int = 8) -> torch.Tensor:
    qmax = (1 << (bits - 1)) - 1
    a = quantize_tile(x.to(torch.float32), sx.reshape(()).float(), qmax)
    b = quantize_tile(w.to(torch.float32), sw.reshape(1, -1).float(), qmax)
    return nibble_sum(subs_flat, a, b, bits)


def nibble_lut_matmul_fused_plain(x, w, subs_flat, sx, sw,
                                  bits: int = 8) -> torch.Tensor:
    return epilogue(nibble_lut_matmul_partial_plain(x, w, subs_flat, sx, sw,
                                                    bits), sx, sw)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def lut_matmul(xq: torch.Tensor, wq: torch.Tensor, lut_flat: torch.Tensor,
               bits: int = 8) -> torch.Tensor:
    """Bit-exact signed LUT GEMM: int8 xq (M,K), wq (K,N) -> int32 (M,N).

    Operands must lie in [-2^{b-1}, 2^{b-1}) (checked: outside it the
    kernel would read past its table); -2^{b-1} indexes the table's
    saturating row exactly as ``ref.lut_matmul_ref`` does."""
    m, k, n = _shapes(xq, wq)
    cuda = on_cuda(xq, wq, lut_flat)
    _check_range(xq, bits)
    _check_range(wq, bits)
    if not cuda:
        return lut_matmul_ref(xq, wq, lut_flat, bits)
    require(xq.dtype == torch.int8 and wq.dtype == torch.int8,
            f"int8 operands expected, got {xq.dtype}, {wq.dtype}")
    require(xq.is_contiguous() and wq.is_contiguous(),
            "operands must be contiguous")
    check_table(lut_flat, bits)
    return launch_cluster(_INT, xq, wq, lut_flat, None, None, m, k, n, bits,
                          out_dtype=torch.int32)


def lut_matmul_mag_plain(xq: torch.Tensor, wq: torch.Tensor,
                         mag_flat: torch.Tensor,
                         bits: int = 8) -> torch.Tensor:
    """The plain version of `lut_matmul_mag`: the gather from the int32
    signed table built from `mag_flat` (``ref.lut_matmul_ref``, the
    function the reference computes over its faulted table)."""
    return lut_matmul_ref(xq, wq, signed_from_magnitude(mag_flat, bits), bits)


def lut_matmul_mag(xq: torch.Tensor, wq: torch.Tensor, mag_flat: torch.Tensor,
                   bits: int = 8) -> torch.Tensor:
    """Bit-exact signed LUT GEMM over a table of magnitude products: int8
    xq (M,K), wq (K,N) -> int32 (M,N).

    ``mag_flat`` holds uf[|a|, |b|] for |a|, |b| <= qmax as uint16
    (`mag_entries` entries); the product of a and b is sign(a) sign(b)
    uf[min(|a|, qmax), min(|b|, qmax)], so the result equals
    ``lut_matmul`` over the signed table built from it
    (`signed_from_magnitude`).  It is the form of the faulted table
    (core/faults.py), whose entries do not fit the int16 signed table."""
    m, k, n = _shapes(xq, wq)
    cuda = on_cuda(xq, wq, mag_flat)
    _check_range(xq, bits)
    _check_range(wq, bits)
    if not cuda:
        return lut_matmul_mag_plain(xq, wq, mag_flat, bits)
    require(xq.dtype == torch.int8 and wq.dtype == torch.int8,
            f"int8 operands expected, got {xq.dtype}, {wq.dtype}")
    require(xq.is_contiguous() and wq.is_contiguous(),
            "operands must be contiguous")
    check_mag_table(mag_flat, bits)
    return launch_cluster(_INT_MAG, xq, wq, mag_flat, None, None, m, k, n,
                          bits, out_dtype=torch.int32)


def _check_fused(x, w, sx, sw, n: int) -> None:
    require(x.dtype in _FLOATS and w.dtype in _FLOATS,
            f"f32/bf16 operands expected, got {x.dtype}, {w.dtype}")
    require(x.is_contiguous() and w.is_contiguous(),
            "operands must be contiguous")
    require(sx.dtype == torch.float32 and sx.numel() == 1,
            "sx must be one f32 element")
    require(sw.dtype == torch.float32 and sw.numel() == n
            and sw.is_contiguous(), f"sw must be {n} contiguous f32")


def lut_matmul_fused(x: torch.Tensor, w: torch.Tensor, lut_flat: torch.Tensor,
                     sx: torch.Tensor, sw: torch.Tensor,
                     bits: int = 8) -> torch.Tensor:
    """Fused-quantization LUT GEMM: f32/bf16 x (M,K), w (K,N) -> f32 (M,N).

    ``sx`` is the per-tensor scale (one element), ``sw`` the per-column
    scale (N elements); both f32 on the operands' device.  Bit-identical
    to quantize -> ``lut_matmul`` -> ``(acc * sx) * sw``."""
    m, k, n = _shapes(x, w)
    if not on_cuda(x, w, lut_flat, sx, sw):
        return lut_matmul_fused_plain(x, w, lut_flat, sx, sw, bits)
    _check_fused(x, w, sx, sw, n)
    check_table(lut_flat, bits)
    return launch_cluster(_FUSED, x, w, lut_flat, sx, sw, m, k, n, bits)


def nibble_lut_matmul(xq: torch.Tensor, wq: torch.Tensor,
                      subs_flat: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Bit-exact signed GEMM over the four nibble sub-tables: int8 xq
    (M,K), wq (K,N) -> int32 (M,N).

    ``subs_flat`` is core.luts.nibble_sub_luts(spec).ravel() as int32,
    order [S_hh, S_hl, S_lh, S_ll].  Magnitudes saturate at qmax
    (|-2^{b-1}| -> qmax, and below 8 bits every int8 magnitude past
    qmax), so the result equals ``lut_matmul`` over the spec's full table
    for every operand that table takes.  Even widths of 2..8 bits."""
    m, k, n = _shapes(xq, wq)
    if not on_cuda(xq, wq, subs_flat):
        return nibble_matmul_ref(xq, wq, subs_flat, bits)
    require(xq.dtype == torch.int8 and wq.dtype == torch.int8,
            f"int8 operands expected, got {xq.dtype}, {wq.dtype}")
    require(xq.is_contiguous() and wq.is_contiguous(),
            "operands must be contiguous")
    check_subs(subs_flat, bits)
    return launch_cluster(_NIB_INT, xq, wq, subs_flat, None, None, m, k, n,
                          bits, out_dtype=torch.int32)


def nibble_lut_matmul_fused(x: torch.Tensor, w: torch.Tensor,
                            subs_flat: torch.Tensor, sx: torch.Tensor,
                            sw: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Fused-quantization nibble GEMM: f32/bf16 x (M,K), w (K,N) -> f32
    (M,N), scales as ``lut_matmul_fused``.  Bit-identical to quantize ->
    ``nibble_lut_matmul`` -> ``(acc * sx) * sw``."""
    m, k, n = _shapes(x, w)
    if not on_cuda(x, w, subs_flat, sx, sw):
        return nibble_lut_matmul_fused_plain(x, w, subs_flat, sx, sw, bits)
    _check_fused(x, w, sx, sw, n)
    check_subs(subs_flat, bits)
    return launch_cluster(_NIB_FUSED, x, w, subs_flat, sx, sw, m, k, n,
                          bits)


def lut_matmul_partial(x: torch.Tensor, w: torch.Tensor,
                       lut_flat: torch.Tensor, sx: torch.Tensor,
                       sw: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Shard-local LUT GEMM over a slice of K: f32/bf16 x (M, K_shard), w
    (K_shard, N) -> the raw int32 (M, N) sum, quantized on load against
    the supplied global scales (``sx`` one element, ``sw`` N); the
    caller sums the shards' partials and applies the epilogue.
    Bit-identical to quantize -> ``lut_matmul``."""
    m, k, n = _shapes(x, w)
    if not on_cuda(x, w, lut_flat, sx, sw):
        return lut_matmul_partial_plain(x, w, lut_flat, sx, sw, bits)
    _check_fused(x, w, sx, sw, n)
    check_table(lut_flat, bits)
    return launch_cluster(_PARTIAL, x, w, lut_flat, sx, sw, m, k, n, bits,
                          out_dtype=torch.int32)


def nibble_lut_matmul_partial(x: torch.Tensor, w: torch.Tensor,
                              subs_flat: torch.Tensor, sx: torch.Tensor,
                              sw: torch.Tensor,
                              bits: int = 8) -> torch.Tensor:
    """Shard-local nibble GEMM: as ``lut_matmul_partial`` over the four
    sub-tables.  Bit-identical to quantize -> ``nibble_lut_matmul``."""
    m, k, n = _shapes(x, w)
    if not on_cuda(x, w, subs_flat, sx, sw):
        return nibble_lut_matmul_partial_plain(x, w, subs_flat, sx, sw, bits)
    _check_fused(x, w, sx, sw, n)
    check_subs(subs_flat, bits)
    return launch_cluster(_NIB_PARTIAL, x, w, subs_flat, sx, sw, m, k, n,
                          bits, out_dtype=torch.int32)
