"""Block-size resolution for the kernels, and the plan caches' shape
buckets.

The reference resolves every kernel's tile through a measured sweep on
the TPU and a shape-clipped heuristic elsewhere.  This module ports the
attention heuristic and the attention and conv plan caches' bucketing;
the measured sweep and its disk cache are a later slice (ROADMAP queue
A 4).  The CUDA GEMM and conv kernels (csrc/cim_gemm.cuh) run one tile
fixed at compile time, which no plan chooses; the int8 tensor-core
kernels (csrc/int8_mma.cuh) choose their K split or pixel tile at launch
from the shape alone, and D is exact whatever they choose.  That holds for the fused
surrogate kernel too: the reference's candidates for it, (64..256,
128..256, 128..256) blocks, are shaped for the TPU's 128 x 128 matrix
unit and VMEM.  On Hopper the template's 16 x 64 output block with a
32-deep K step serves it as it serves the LUT and log GEMMs (256
threads, four rows each; the integer core keeps the int32 D and, with
noise, the f32 SQ sums in registers), and no block enters its numerics:
D is exact and SQ is summed in K order whatever the tile.

For attention the block is a (bq, bk) pair, and ``bk`` is part of the
numerics: the online softmax is tiled along the kv axis, so the float
result depends on it.  The port therefore resolves the reference's
``bk`` for every entry, on both devices.  ``bq`` is free on Hopper (a
query row's result does not depend on which rows share its block); the
CUDA kernels pick their own (the template kernels.attn_gemm.ATTN_BQ, the
cluster kernel attn_gemm.attn_cluster_plan).
"""

from __future__ import annotations

from typing import Dict, Tuple

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


def heuristic_attn_block(kernel: str, sq: int, skv: int) -> AttnBlock:
    """The reference's block for `kernel` (a reference kernel name),
    clipped to the bucketed sequence lengths."""
    return _clip_attn_block(DEFAULT_ATTN_BLOCKS.get(kernel, (32, 128)),
                            sq, skv)
