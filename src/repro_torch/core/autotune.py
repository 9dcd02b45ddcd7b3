"""Block-size resolution for the kernels, and the plan caches' shape
buckets.

The reference resolves every kernel's tile through a measured sweep on
the TPU (with a disk cache) and a shape-clipped heuristic elsewhere.
The port needs neither: each CUDA kernel that launches on a served path
cuts its own launch from the shape and the device's capacity, queried
from the instantiation it launches (`cudaOccupancyMaxActiveClusters` or
the occupancy API, cached), and the C entry refuses a plan it does not
take:

  * the split-K cluster GEMMs (the fused and partial LUT, nibble and log
    GEMMs, the int LUT, magnitude-table and log GEMMs, and the fused
    surrogate GEMM): kernels.approx_matmul
    `cluster_plan` / `fused_plan` pick the row tile and the K split that
    minimize waves x steps;
  * the LUT and log convs and their partial forms (csrc/conv_tile.cuh):
    kernels.conv_gemm `conv_plan` picks the micro-tile and the persistent
    grid;
  * CiM attention (csrc/attn_cluster.cuh): kernels.attn_gemm
    `attn_cluster_plan` picks the query tile, the kv split and the ring
    tile;
  * the sLSTM scan: kernels.slstm_scan `cluster_plan` picks the cluster
    size (or the streamed kernel for heads no cluster holds).

launch/cluster_sweep.py measures every choice beside the plan's.  The
kernels left on the template of csrc/cim_gemm.cuh (9..16-bit log
operands, and `cim_gemm_core` with SQ) run one tile fixed at compile
time, and the int8 tensor-core kernels (csrc/int8_mma.cuh) choose their
K split or pixel tile at launch from the shape alone.  No
GEMM or conv plan enters the numerics: the integer sums are exact
whatever the split, and the surrogate's SQ is exact on the tensor cores.
This module keeps the attention heuristic and the attention and conv
plan caches' bucketing.

For attention the block is a (bq, bk) pair, and ``bk`` is part of the
numerics: the online softmax is tiled along the kv axis, so the float
result depends on it.  The port therefore resolves the reference's
``bk`` for every entry, on both devices.  ``bq`` is free on Hopper (a
query row's result does not depend on which rows share its block); the
CUDA kernels pick their own (the template kernels.attn_gemm.ATTN_BQ, the
cluster kernel attn_gemm.attn_cluster_plan).

`set_obs_sink` installs the telemetry sink (obs/) the reference's
autotune tells of each block resolution.  With no sweep and no disk
cache, the port's outcomes are two of the reference's four: "heuristic"
when `heuristic_attn_block` resolves a block, and "mem_hit" when its
in-memory memo already holds it ("disk_hit" and "sweep" never occur).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

AttnBlock = Tuple[int, int]

# the reference's defaults, keyed by its kernel names (entries of the
# port map to these through core/approx_gemm._ATTN_REF_NAMES)
DEFAULT_ATTN_BLOCKS: Dict[str, AttnBlock] = {
    "pallas_attn_mxu": (128, 128),
    "pallas_attn_lut": (32, 128),
    "pallas_attn_nibble": (64, 128),
    "pallas_attn_log": (16, 128),
    # the plain fallback tiles its kv loop by bk too
    "attn_xla": (32, 128),
}


def bucket(v: int) -> int:
    """Next power of two >= v (floor 8): the plan caches' shape key."""
    b = 8
    while b < v:
        b <<= 1
    return b


def bucket_attn(b: int, heads: int, kv_heads: int, sq: int, skv: int,
                head_dim: int) -> Tuple[int, ...]:
    """Attention-shape bucketing (the attention plan cache's key): powers
    of two on batch and the two sequence axes; heads, kv_heads and
    head_dim exact."""
    return (bucket(b), heads, kv_heads, bucket(sq), bucket(skv), head_dim)


def bucket_conv(b: int, h: int, w: int, c: int, kh: int, kw: int,
                stride: int = 1) -> Tuple[int, ...]:
    """Conv-shape bucketing (the conv plan cache's key): powers of two on
    the data dims, the kernel taps and stride exact — they change the
    kernel's index arithmetic, not just its tiling."""
    return (bucket(b), bucket(h), bucket(w), bucket(c), kh, kw, stride)


def _clip_attn_block(block: AttnBlock, sq: int, skv: int) -> AttnBlock:
    bq, bk = block
    return (max(8, min(bq, bucket(sq))), max(8, min(bk, bucket(skv))))


_mem_cache: Dict[Tuple[str, int, int], AttnBlock] = {}
_lock = threading.Lock()
_OBS_SINK: List[Optional[object]] = [None]


def set_obs_sink(sink) -> Optional[object]:
    """Install the autotune telemetry sink (must expose
    ``autotune(key, outcome)``); returns the previous one."""
    prev = _OBS_SINK[0]
    _OBS_SINK[0] = sink
    return prev


def _obs_autotune(key: str, outcome: str) -> None:
    sink = _OBS_SINK[0]
    if sink is not None:
        sink.autotune(key=key, outcome=outcome)


def clear_memory_cache() -> None:
    with _lock:
        _mem_cache.clear()


def heuristic_attn_block(kernel: str, sq: int, skv: int) -> AttnBlock:
    """The reference's block for `kernel` (a reference kernel name),
    clipped to the bucketed sequence lengths; memoized, each resolution
    told to the sink as "heuristic" or "mem_hit"."""
    key = (kernel, sq, skv)
    with _lock:
        block = _mem_cache.get(key)
    if block is not None:
        _obs_autotune(f"{kernel}:q{sq}:kv{skv}", "mem_hit")
        return block
    block = _clip_attn_block(DEFAULT_ATTN_BLOCKS.get(kernel, (32, 128)),
                             sq, skv)
    with _lock:
        _mem_cache[key] = block
    _obs_autotune(f"{kernel}:q{sq}:kv{skv}", "heuristic")
    return block
