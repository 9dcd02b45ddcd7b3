"""Implicit-GEMM CiM convolution: CUDA kernels for Hopper and their plain
versions.

A (kh, kw, stride) convolution under kh//2, kw//2 zero padding (SAME at
stride 1) is a GEMM with

    M = B*OH*OW   (batch-major output pixels)
    K = kh*kw*C   (tap-major, then channel: the im2col column order)
    N = C_out

Three fused-quantization entry points, as in the JAX package (f32 x
(B, H, W, C) and f32 w3 (kh*kw, C, N) in, f32 (B, OH, OW, N) out, the
per-tensor ``sx`` / per-out-channel ``sw`` quantization on load and the
``(acc * sx) * sw`` epilogue inside one kernel):

  * ``conv_lut_fused`` — the full signed-product table, or the nibble
    sub-tables (``nibble=True``);
  * ``conv_log_fused`` — the Mitchell / Log-our log-domain product;
  * ``conv_mxu_fused`` — the exact product (exact mode) on the int8
    tensor cores, summed exactly in int32 where the reference summed the
    dequantized products in f32 per tap: the two differ by f32 rounding
    only.

and the mesh path's two partial forms, the LUT and log forms with the
epilogue off (``conv_lut_partial`` with ``nibble=``, ``conv_log_partial``):
an image and tap stack over a slice of the input channels, quantized
against caller-supplied (global) scales, the raw int32 (B, OH, OW, N)
sum out; the caller sums the shards' partials and applies the epilogue.

The LUT and log integer cores are bit-identical to im2col + the GEMM
kernels.  On CUDA tensors each launches csrc/conv_gemm.cu or raises; the
kernel gathers the patch matrix from the image by index arithmetic, so
neither a padded plane nor an im2col tensor is held anywhere.  The LUT
and log entries up to 8 bits, fused and partial, run csrc/conv_tile.cuh's
kernel (a block a spatial tile and all of N, the halo and the tap stack
staged once, a persistent grid; a fused form and its partial share an
instantiation and a plan, the epilogue picked at launch), its launch cut
by `conv_plan`; wider log operands (``conv_route``) run the tiled
template of csrc/cim_gemm.cuh.  On CPU
tensors each runs its plain version below (pad, then per tap: quantize
the shifted window and the weight tap, and add its gather, log or exact
integer sum), bit-identical to the kernel.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.approx_gemm import conv_out_hw

from .approx_matmul import check_table, check_subs
from .build import INT, PTR, CudaKernel, on_cuda, query, require, stream_of
from .ref import (gather_full, int_dot, log_sum, nibble_sum, quantize_tile,
                  taps)

# the LUT and log entries of the tile kernel also take the launch plan:
# rp, rn, ib, tr, tc, cc, tg, grid (conv_plan)
_LUT = CudaKernel("conv_gemm", "conv_lut_fused",
                  [PTR] * 6 + [INT] * 19 + [PTR])
_LOG = CudaKernel("conv_gemm", "conv_log_fused",
                  [PTR] * 5 + [INT] * 19 + [PTR])
_LOG_WIDE = CudaKernel("conv_gemm", "conv_log_fused_wide",
                       [PTR] * 5 + [INT] * 11 + [PTR])
_MXU = CudaKernel("conv_gemm", "conv_mxu_fused",
                  [PTR] * 5 + [INT] * 10 + [PTR])
_LUT_PARTIAL = CudaKernel("conv_gemm", "conv_lut_partial",
                          [PTR] * 6 + [INT] * 19 + [PTR])
_LOG_PARTIAL = CudaKernel("conv_gemm", "conv_log_partial",
                          [PTR] * 5 + [INT] * 19 + [PTR])
_LOG_PARTIAL_WIDE = CudaKernel("conv_gemm", "conv_log_partial_wide",
                               [PTR] * 5 + [INT] * 11 + [PTR])

# conv_log_fused_wide, conv_log_partial_wide: the other side of conv_route
# (9..16-bit log operands), on no Table IV path
KERNELS = {"conv_lut_fused": _LUT, "conv_log_fused": _LOG,
           "conv_log_fused_wide": _LOG_WIDE, "conv_mxu_fused": _MXU,
           "conv_lut_partial": _LUT_PARTIAL, "conv_log_partial": _LOG_PARTIAL,
           "conv_log_partial_wide": _LOG_PARTIAL_WIDE}

# the template's block (csrc/cim_gemm.cuh, 9..16-bit log):
# output pixels x channel chunk x out-channels, BM, BK, BN, fixed at
# compile time, and the outputs each thread accumulates per K step (its
# RPT)
TILE = (16, 32, 64)
ROWS_PER_THREAD = 4
# the exact core's tensor-core block (csrc/int8_mma.cuh): the int8 halo
# bytes, the weight tile's K bytes a group and its output channels
MXU_HALO, MXU_KCAP, MXU_BN = 16384, 576, 64
# the most taps it takes: one output pixel's halo, a 4-channel word a
# tap, must fit the int8 halo (plan_conv sends larger kernels to
# conv_im2col)
MXU_MAX_TAPS = MXU_HALO // 4


def _al(n: int) -> int:
    return (n + 15) // 16 * 16


# csrc/conv_tile.cuh: threads a block, columns an N tile, staged halo
# words, the widest operands, the weight region in staged weights and
# their bytes by form, the channels a staged word holds, the instantiated
# micro-tiles (pixels, columns) a thread, and the forms' kind numbers
TILE_THREADS = 256
TILE_NCAP = 64
TILE_HALO_WORDS = 8192
TILE_MAX_BITS = 8
TILE_W_ENTRIES = {"lut": 24576, "nibble": 18432, "mitchell": 18432,
                  "log_our": 18432}
TILE_W_BYTES = {"lut": 2, "nibble": 4, "mitchell": 4, "log_our": 4}
TILE_CPW = {"lut": 1, "nibble": 1, "mitchell": 2, "log_our": 1}
TILE_MICRO = ((4, 1), (8, 1), (4, 2), (8, 2), (2, 4), (4, 4), (8, 4))
TILE_KIND = {"lut": 0, "nibble": 1, "mitchell": 2, "log_our": 3}
# conv_plan's cost weights, fitted to launch/cluster_sweep.py's conv
# sweep on an H100 (the plan's micro-tile within 4% of the fastest at
# every Table IV conv and variant): a table gather's extra cost per
# 32 / (the columns a warp spans), for the bank conflicts of lanes on one
# column but other pixels (LUT rows are padded apart, the nibble's few
# distinct sub-table rows are not); and how much slower an SM runs its
# work as one block than as the blocks it can hold
_GATHER_SPREAD = {"lut": 0.1, "nibble": 0.5}
_LONE_BLOCK = 1.2
# a tile form's core (gemm_smem_bytes', the planner's)
_CORE_OF = {"lut": "lut", "nibble": "nibble", "mitchell": "log",
            "log_our": "log"}


def table_layout(form: str, bits: int) -> Tuple[int, int, int]:
    """(row bytes, rows, row stride) of the tile kernel's table in shared
    memory (csrc/conv_tile.cuh tab_layout): LUT rows of 2^bits int16,
    nibble rows of hb = 2^(bits//2) int32 (4 hb of them), each row 16
    bytes past the one before where its bytes are a multiple of 16 and at
    least 32, so that rows spread over the banks; (0, 0, 0) for the log
    forms."""
    if form == "lut":
        row, rows = 2 << bits, 1 << bits
    elif form == "nibble":
        hb = 1 << (bits // 2)
        row, rows = 4 * hb, 4 * hb
    else:
        return 0, 0, 0
    return row, rows, row + (16 if row % 16 == 0 and row >= 32 else 0)


def conv_route(core: str, bits: int) -> str:
    """The kernel a conv of `core` ("lut", "nibble" or "log") at `bits`
    launches on the card, fused or partial alike: "tile"
    (csrc/conv_tile.cuh) up to TILE_MAX_BITS, "template"
    (csrc/cim_gemm.cuh, the C entries conv_log_fused_wide and
    conv_log_partial_wide) for the log core's 9..16 bits.  Every geometry
    takes its bits' route."""
    if core not in ("lut", "nibble", "log"):
        raise ValueError(f"no tile route for core {core!r}")
    return "tile" if bits <= TILE_MAX_BITS else "template"


def tile_smem_bytes(form: str, bits: int) -> int:
    """Dynamic shared memory of one block of csrc/conv_tile.cuh's kernel
    for `form` ("lut", "nibble", "mitchell" or "log_our"): the laid-out
    table (`table_layout`), an mbarrier (16 bytes), TILE_HALO_WORDS words
    of staged halo and the weight region (ct_smem_bytes), one total
    whatever the geometry."""
    _, rows, stride = table_layout(form, bits)
    return (_al(rows * stride) + 16 + 4 * TILE_HALO_WORDS
            + _al(TILE_W_ENTRIES[form] * TILE_W_BYTES[form]))


def template_smem_bytes(core: str, bits: int) -> int:
    """Dynamic shared memory of one block of csrc/cim_gemm.cuh's conv
    template for `core` ("lut", "nibble" or "log"): the table, then the
    staged A (BM x BK) and B (BK x BN) tiles (the full table's int32 row
    offsets and int16 column indices; int4 nibble offsets or log
    decompositions).  Only the log core's 9..16 bits launch it
    (`gemm_smem_bytes`); the LUT and nibble totals are the template's
    layout for those cores, which the tests hold the planner's gate and
    routes to."""
    bm, bk, bn = TILE
    if core == "lut":
        return _al((1 << (2 * bits)) * 2) + _al(4 * bm * bk) + 2 * bk * bn
    if core == "nibble":
        return _al(16 << bits) + _al(16 * bm * bk) + 16 * bk * bn
    if core == "log":
        return _al(16 * bm * bk) + 16 * bk * bn
    raise ValueError(f"unknown core {core!r}")


def gemm_smem_bytes(core: str, bits: int) -> int:
    """Dynamic shared memory of one block of the fused conv kernel for
    `core` ("lut", "nibble", "log" or "mxu") at `bits`: up to
    TILE_MAX_BITS csrc/conv_tile.cuh's (`tile_smem_bytes`; mitchell and
    log_our share one total), the log core's 9..16 bits the template's
    (`template_smem_bytes`).  For the exact core, int8_mma.cuh's
    tensor-core kernel: the int8 input halo, the int8 K-major weight tile
    (MXU_BN rows of MXU_KCAP bytes, each padded by 16) and one int offset
    a k word, 54,848 bytes whatever the geometry and the width (the
    kernel takes channels in chunks and taps in groups to fit it)."""
    if core == "mxu":
        return MXU_HALO + MXU_BN * (MXU_KCAP + 16) + MXU_KCAP
    if conv_route(core, bits) == "template":
        return template_smem_bytes(core, bits)
    return tile_smem_bytes("mitchell" if core == "log" else core, bits)


class ConvTilePlan(NamedTuple):
    """One launch of csrc/conv_tile.cuh's kernel (`conv_plan`)."""

    rp: int         # pixels a thread
    rn: int         # columns a thread
    ib: int         # a tile: images, output rows, output columns
    tr: int
    tc: int
    hr: int         # its halo: rows, columns
    hc: int
    cc: int         # channels a chunk (a multiple of 4), its staged words
    ccw: int
    ps: int         # the halo's pixel stride in words (odd)
    tg: int         # taps a weight group
    nt: int         # columns an N tile, column groups, pixel groups, the
    ng: int         # N tile padded to ng * rn
    pg: int
    ntp: int
    tiles: int      # output tiles, and the persistent blocks over them
    grid: int
    chunks: int     # channel chunks, tap groups, N tiles
    groups: int
    n_tiles: int
    whole: bool     # the whole tap stack staged once a block
    smem: int


def _pixel_stride(ccw: int) -> int:
    """The halo's pixel stride in words: the chunk's words, made odd."""
    return ccw + 1 if ccw % 2 == 0 else ccw


def _tile_geometry(form, bits, b, oh, ow, c, n, kh, kw, stride, rp, rn, ib,
                   tr, tc, cc, tg) -> Optional[ConvTilePlan]:
    """The plan's derived numbers, as ct_make_args derives them; None
    where the kernel refuses the plan."""
    nt = min(n, TILE_NCAP)
    ng = -(-nt // rn)
    pg = TILE_THREADS // ng
    ntp = ng * rn
    if pg < 1 or ib * tr * tc > pg * rp or not (
            1 <= ib <= b and 1 <= tr <= oh and 1 <= tc <= ow):
        return None
    hr, hc = (tr - 1) * stride + kh, (tc - 1) * stride + kw
    if cc < 4 or cc % 4 or cc > -(-c // 4) * 4:
        return None
    ccw = cc // TILE_CPW[form]
    ps = _pixel_stride(ccw)
    taps = kh * kw
    if (ib * hr * hc * ps > TILE_HALO_WORDS or not 1 <= tg <= taps
            or tg * ccw * ntp > TILE_W_ENTRIES[form]):
        return None
    tiles = -(-b // ib) * -(-oh // tr) * -(-ow // tc)
    chunks, groups, n_tiles = -(-c // cc), -(-taps // tg), -(-n // nt)
    return ConvTilePlan(rp, rn, ib, tr, tc, hr, hc, cc, ccw, ps, tg, nt, ng,
                        pg, ntp, tiles, 0, chunks, groups, n_tiles,
                        n_tiles == 1 and chunks == 1 and groups == 1,
                        gemm_smem_bytes(_CORE_OF[form], bits))


def _tile_candidate(form, bits, b, oh, ow, c, n, kh, kw, stride, rp, rn):
    """The tile, chunk and group conv_plan takes for micro-tile (rp, rn),
    or None where not even one output pixel's 4-channel halo fits."""
    nt = min(n, TILE_NCAP)
    slots = (TILE_THREADS // -(-nt // rn)) * rp
    tc = min(ow, slots)
    tr = min(oh, slots // tc)
    ib = min(b, slots // (tr * tc)) if tr == oh else 1
    cpw = TILE_CPW[form]

    def halo(ib, tr, tc, cc):
        return (ib * ((tr - 1) * stride + kh) * ((tc - 1) * stride + kw)
                * _pixel_stride(cc // cpw))

    while halo(ib, tr, tc, 4) > TILE_HALO_WORDS:
        if ib > 1:
            ib //= 2
        elif tr > 1:
            tr //= 2
        elif tc > 1:
            tc //= 2
        else:
            return None
    ntp = -(-nt // rn) * rn
    cpad = -(-c // 4) * 4
    cmax = 4
    while (cmax + 4 <= cpad and halo(ib, tr, tc, cmax + 4) <= TILE_HALO_WORDS
           and (cmax + 4) // cpw * ntp <= TILE_W_ENTRIES[form]):
        cmax += 4
    if (cmax // cpw) * ntp > TILE_W_ENTRIES[form]:
        return None
    chunks = -(-cpad // cmax)
    cc = -(-cpad // (4 * chunks)) * 4      # equal chunks, multiples of 4
    taps = kh * kw
    tg = min(taps, TILE_W_ENTRIES[form] // ((cc // cpw) * ntp))
    tg = -(-taps // -(-taps // tg))
    return ib, tr, tc, cc, tg


def conv_plan(core: str, bits: int, b: int, h: int, w: int, c: int, n: int,
              kh: int, kw: int, stride: int, sms: int,
              blocks_per_sm: Union[int, Callable[[int, int], int]],
              force: Optional[Tuple[int, int]] = None) -> ConvTilePlan:
    """How one call of csrc/conv_tile.cuh's kernel is cut, for `core`
    ("lut", "nibble", "mitchell" or "log_our") at `bits` on a (b, h, w, c)
    image and an N = `n` tap stack of kh x kw taps at `stride`.

    For each micro-tile (rp, rn) of TILE_MICRO (only `force` if given):
    the N tile is min(N, TILE_NCAP) columns in ng = ceil(nt / rn) column
    groups, so a block of TILE_THREADS threads holds pg = TILE_THREADS //
    ng pixel groups and pg * rp pixel slots.  The tile fills them with
    whole output rows (whole images where a plane is smaller), then is
    halved (images, rows, columns) until its halo of one 4-channel chunk
    fits TILE_HALO_WORDS.  The channels are cut into the fewest equal
    chunks (multiples of 4) whose halo and one tap of weights fit, the
    taps into the fewest equal groups whose weights fit the form's
    region.  ``blocks_per_sm(rp, rn)`` (or an int) is the blocks of that
    instantiation an SM holds (0: none fits); the grid is min(tiles,
    sms * blocks_per_sm), each block looping over the tiles.  The plan
    taken minimizes the time an SM takes: a tile's work (N tiles x k
    words x (rp * rn * p + rp + rn + 4): a thread's products, p = 1 plus
    a table gather's bank conflicts, its operand loads and its loop)
    times the tiles an SM runs (tiles / sms rounded up), or, where the
    grid leaves an SM fewer blocks than it holds, _LONE_BLOCK times the
    work of a wave (tiles / (sms x blocks_per_sm) rounded up); ties go
    to the larger rp * rn, then the larger rp."""
    if core not in TILE_KIND:
        raise ValueError(f"no tile form {core!r}")
    require(2 <= bits <= TILE_MAX_BITS,
            f"the tile conv kernel takes 2..{TILE_MAX_BITS}-bit operands, "
            f"got {bits}")
    oh, ow = conv_out_hw(h, w, kh, kw, stride)
    per_sm = (blocks_per_sm if callable(blocks_per_sm)
              else (lambda rp, rn: blocks_per_sm))
    best = None
    for rp, rn in ([force] if force else TILE_MICRO):
        cut = _tile_candidate(core, bits, b, oh, ow, c, n, kh, kw, stride, rp,
                              rn)
        if cut is None:
            continue
        geo = _tile_geometry(core, bits, b, oh, ow, c, n, kh, kw, stride, rp,
                             rn, *cut)
        held = sms * per_sm(rp, rn)
        if geo is None or held <= 0:
            continue
        # a thread's serial work a tile: its products (a gather's bank
        # conflicts on top), its operand loads and the loop a k word
        per = 1 + _GATHER_SPREAD.get(core, 0.0) * 32 / min(geo.ng, 32)
        work = (geo.n_tiles * geo.chunks * geo.ccw * kh * kw
                * (rp * rn * per + rp + rn + 4))
        cost = max(-(-geo.tiles // sms) * work,
                   _LONE_BLOCK * -(-geo.tiles // held) * work)
        key = (cost, -rp * rn, -rp)
        if best is None or key < best[0]:
            best = (key, geo._replace(grid=min(geo.tiles, held)))
    if best is None:
        raise ValueError(f"no tile of the conv kernel fits {kh}x{kw} taps "
                         f"({core}, micro-tile {force or TILE_MICRO})")
    return best[1]


@functools.lru_cache(maxsize=None)
def _tile_capacity(device: int, kind: int, bits: int, rp: int,
                   rn: int) -> int:
    """conv_tile_capacity (the C query) on CUDA device `device`, cached."""
    with torch.cuda.device(device):
        return query("conv_gemm", "conv_tile_capacity", kind, bits, rp, rn)


def device_plan(form: str, bits: int, x, w3, kh: int, kw: int, stride: int,
                force: Optional[Tuple[int, int]] = None) -> ConvTilePlan:
    """`conv_plan` of one call on x's device: its SM count and the
    instantiations' residency (conv_tile_capacity); cached by shape."""
    dev = x.device.index if x.device.index is not None else 0
    return _device_plan(form, bits, *x.shape, w3.shape[2], kh, kw, stride,
                        dev, force)


@functools.lru_cache(maxsize=1024)
def _device_plan(form, bits, b, h, w, c, n, kh, kw, stride, dev, force):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return conv_plan(form, bits, b, h, w, c, n, kh, kw, stride, sms,
                     functools.partial(_tile_capacity, dev, TILE_KIND[form],
                                       bits), force=force)


def _geometry(x, w3, kh: int, kw: int, stride: int):
    require(kh % 2 == 1 and kw % 2 == 1,
            f"even conv kernels ({kh}x{kw}) need asymmetric padding, which "
            "the symmetric kh//2 scheme cannot express")
    require(stride >= 1, f"stride must be >= 1, got {stride}")
    require(x.dim() == 4 and w3.dim() == 3,
            f"x (B,H,W,C) and w3 (kh*kw,C,N) expected, got "
            f"{tuple(x.shape)}, {tuple(w3.shape)}")
    b, h, w, c = x.shape
    require(tuple(w3.shape[:2]) == (kh * kw, c),
            f"w3 {tuple(w3.shape)} does not match {kh}x{kw} taps over {c} "
            "channels")
    return b, h, w, c, w3.shape[2]


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; chip_smoke.py also runs them on the card)
# ---------------------------------------------------------------------------


def _conv_plain(x, w3, sx, sw, bits, kh, kw, stride, tap_sum,
                epilogue: bool = True):
    b, h, w, c, n = _geometry(x, w3, kh, kw, stride)
    oh, ow = conv_out_hw(h, w, kh, kw, stride)
    qmax = (1 << (bits - 1)) - 1
    sx = sx.reshape(()).to(torch.float32)
    sw = sw.reshape(1, -1).to(torch.float32)
    xp = torch.nn.functional.pad(x.to(torch.float32),
                                 (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    acc = torch.zeros((b * oh * ow, n), dtype=torch.int32, device=x.device)
    for t, a2 in taps(xp, kh, kw, oh, ow, stride):
        aq = quantize_tile(a2, sx, qmax)
        bq = quantize_tile(w3[t].to(torch.float32), sw, qmax)
        acc += tap_sum(aq, bq)
    if not epilogue:
        return acc.reshape(b, oh, ow, n)
    return ((acc.to(torch.float32) * sx) * sw).reshape(b, oh, ow, n)


def _lut_tap_sum(table, bits: int, nibble: bool):
    half = 1 << (bits - 1)
    if nibble:
        def tap_sum(aq, bq):
            return nibble_sum(table, aq, bq, bits)
    else:
        def tap_sum(aq, bq):
            return gather_full(table, aq + half, bq + half, 1 << bits)
    return tap_sum


def conv_lut_fused_plain(x, w3, table, sx, sw, bits: int = 8, kh: int = 3,
                         kw: int = 3, stride: int = 1,
                         nibble: bool = False) -> torch.Tensor:
    return _conv_plain(x, w3, sx, sw, bits, kh, kw, stride,
                       _lut_tap_sum(table, bits, nibble))


def conv_lut_partial_plain(x, w3, table, sx, sw, bits: int = 8, kh: int = 3,
                           kw: int = 3, stride: int = 1,
                           nibble: bool = False) -> torch.Tensor:
    return _conv_plain(x, w3, sx, sw, bits, kh, kw, stride,
                       _lut_tap_sum(table, bits, nibble), epilogue=False)


def conv_mxu_fused_plain(x, w3, sx, sw, bits: int = 8, kh: int = 3,
                         kw: int = 3, stride: int = 1) -> torch.Tensor:
    return _conv_plain(x, w3, sx, sw, bits, kh, kw, stride, int_dot)


def conv_log_fused_plain(x, w3, sx, sw, bits: int = 8,
                         compensated: bool = True, kh: int = 3, kw: int = 3,
                         stride: int = 1) -> torch.Tensor:
    def tap_sum(aq, bq):
        return log_sum(aq, bq, bits, compensated)
    return _conv_plain(x, w3, sx, sw, bits, kh, kw, stride, tap_sum)


def conv_log_partial_plain(x, w3, sx, sw, bits: int = 8,
                           compensated: bool = True, kh: int = 3,
                           kw: int = 3, stride: int = 1) -> torch.Tensor:
    def tap_sum(aq, bq):
        return log_sum(aq, bq, bits, compensated)
    return _conv_plain(x, w3, sx, sw, bits, kh, kw, stride, tap_sum,
                       epilogue=False)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_operands(x, w3, sx, sw, n: int) -> None:
    require(x.dtype == torch.float32 and w3.dtype == torch.float32,
            f"f32 operands expected, got {x.dtype}, {w3.dtype}")
    require(x.is_contiguous() and w3.is_contiguous(),
            "operands must be contiguous")
    require(sx.dtype == torch.float32 and sx.numel() == 1,
            "sx must be one f32 element")
    require(sw.dtype == torch.float32 and sw.numel() == n
            and sw.is_contiguous(), f"sw must be {n} contiguous f32")


def _check_lut(x, w3, table, sx, sw, bits, kh, kw, stride, nibble):
    b, h, w, c, n = _geometry(x, w3, kh, kw, stride)
    _check_operands(x, w3, sx, sw, n)
    if nibble:
        check_subs(table, bits)
    else:
        check_table(table, bits)
    return b, h, w, c, n


def _launch_tile(kern: CudaKernel, form: str, x, w3, table, sx, sw, bits, kh,
                 kw, stride, flag, partial, force=None):
    """csrc/conv_tile.cuh's launch (an entry up to 8 bits: f32 out, or the
    raw int32 sum where `partial`) with the plan of `device_plan`
    (`force`: its micro-tile; cached, so the shared-memory total is read
    from gemm_smem_bytes at every launch)."""
    b, h, w, c, n = _geometry(x, w3, kh, kw, stride)
    plan = device_plan(form, bits, x, w3, kh, kw, stride, force)
    oh, ow = conv_out_hw(h, w, kh, kw, stride)
    out = torch.empty((b, oh, ow, n),
                      dtype=torch.int32 if partial else torch.float32,
                      device=x.device)
    tab = () if table is None else (table.data_ptr(),)
    kern(x.data_ptr(), w3.data_ptr(), *tab, sx.data_ptr(), sw.data_ptr(),
         out.data_ptr(), b, h, w, c, n, kh, kw, stride, bits, int(flag),
         gemm_smem_bytes(_CORE_OF[form], bits), plan.rp, plan.rn, plan.ib,
         plan.tr, plan.tc, plan.cc, plan.tg, plan.grid, stream_of(x))
    return out


def _conv_lut_tile(x, w3, table, sx, sw, bits, kh, kw, stride, nibble,
                   partial=False, force=None):
    _check_lut(x, w3, table, sx, sw, bits, kh, kw, stride, nibble)
    require(2 <= bits <= TILE_MAX_BITS,
            f"the LUT conv kernel takes 2..{TILE_MAX_BITS}-bit operands, got "
            f"{bits}")
    return _launch_tile(_LUT_PARTIAL if partial else _LUT,
                        "nibble" if nibble else "lut", x, w3, table, sx, sw,
                        bits, kh, kw, stride, nibble, partial, force)


def conv_lut_fused(x: torch.Tensor, w3: torch.Tensor, table: torch.Tensor,
                   sx: torch.Tensor, sw: torch.Tensor, bits: int = 8,
                   kh: int = 3, kw: int = 3, stride: int = 1,
                   nibble: bool = False) -> torch.Tensor:
    """LUT-family implicit-GEMM conv: f32 x (B,H,W,C), w3 (kh*kw,C,N) ->
    f32 (B,OH,OW,N).  ``table`` is the int16 full signed-product table
    (``nibble=False``) or the raveled int32 nibble sub-tables
    (``nibble=True``); ``sx`` one f32 element, ``sw`` N f32.
    Bit-identical integer core to im2col + ``lut_matmul`` /
    ``nibble_lut_matmul``."""
    _geometry(x, w3, kh, kw, stride)
    if not on_cuda(x, w3, table, sx, sw):
        return conv_lut_fused_plain(x, w3, table, sx, sw, bits, kh, kw,
                                    stride, nibble)
    return _conv_lut_tile(x, w3, table, sx, sw, bits, kh, kw, stride, nibble)


def conv_lut_partial(x: torch.Tensor, w3: torch.Tensor, table: torch.Tensor,
                     sx: torch.Tensor, sw: torch.Tensor, bits: int = 8,
                     kh: int = 3, kw: int = 3, stride: int = 1,
                     nibble: bool = False) -> torch.Tensor:
    """Shard-local LUT-family conv over a slice of the input channels:
    f32 x (B,H,W,C_shard), w3 (kh*kw,C_shard,N) -> the raw int32
    (B,OH,OW,N) sum, quantized on load against the supplied global
    scales; tables as ``conv_lut_fused``.  The caller sums the shards'
    partials and applies the epilogue."""
    _geometry(x, w3, kh, kw, stride)
    if not on_cuda(x, w3, table, sx, sw):
        return conv_lut_partial_plain(x, w3, table, sx, sw, bits, kh, kw,
                                      stride, nibble)
    return _conv_lut_tile(x, w3, table, sx, sw, bits, kh, kw, stride, nibble,
                          partial=True)


def _launch_log(kern: CudaKernel, x, w3, sx, sw, bits, compensated, kh, kw,
                stride, out_dtype):
    """The template's launch (9..16-bit log, fused or partial)."""
    b, h, w, c, n = _geometry(x, w3, kh, kw, stride)
    _check_operands(x, w3, sx, sw, n)
    require(2 <= bits <= 16,
            f"the log kernel takes 2..16-bit operands, got {bits}")
    oh, ow = conv_out_hw(h, w, kh, kw, stride)
    out = torch.empty((b, oh, ow, n), dtype=out_dtype, device=x.device)
    kern(x.data_ptr(), w3.data_ptr(), sx.data_ptr(), sw.data_ptr(),
         out.data_ptr(), b, h, w, c, n, kh, kw, stride, bits,
         int(compensated), template_smem_bytes("log", bits), stream_of(x))
    return out


def _conv_log_tile(x, w3, sx, sw, bits, compensated, kh, kw, stride,
                   partial=False, force=None):
    _, _, _, _, n = _geometry(x, w3, kh, kw, stride)
    _check_operands(x, w3, sx, sw, n)
    require(2 <= bits <= TILE_MAX_BITS,
            f"the tile log conv kernel takes 2..{TILE_MAX_BITS}-bit "
            f"operands, got {bits}")
    return _launch_tile(_LOG_PARTIAL if partial else _LOG,
                        "log_our" if compensated else "mitchell", x, w3, None,
                        sx, sw, bits, kh, kw, stride, compensated, partial,
                        force)


def _conv_tile_forced(x, w3, table, sx, sw, form: str, bits: int, kh: int,
                      kw: int, stride: int, force: Tuple[int, int],
                      partial: bool = False):
    """The LUT (`form` "lut", "nibble") or log ("mitchell", "log_our")
    conv, fused or (`partial`) its partial form, on the tile kernel with
    the micro-tile `force` (rp, rn) and the rest of its plan as conv_plan
    cuts it (tests, chip_smoke.py, launch/cluster_sweep.py)."""
    if form in ("lut", "nibble"):
        return _conv_lut_tile(x, w3, table, sx, sw, bits, kh, kw, stride,
                              form == "nibble", partial, force)
    return _conv_log_tile(x, w3, sx, sw, bits, form == "log_our", kh, kw,
                          stride, partial, force)


def conv_log_fused(x: torch.Tensor, w3: torch.Tensor, sx: torch.Tensor,
                   sw: torch.Tensor, bits: int = 8, compensated: bool = True,
                   kh: int = 3, kw: int = 3, stride: int = 1) -> torch.Tensor:
    """Log-family implicit-GEMM conv (mitchell, or log_our when
    `compensated`): shapes and scales as ``conv_lut_fused``.
    Bit-identical integer core to im2col + ``mitchell_matmul``."""
    _geometry(x, w3, kh, kw, stride)
    if not on_cuda(x, w3, sx, sw):
        return conv_log_fused_plain(x, w3, sx, sw, bits, compensated, kh, kw,
                                    stride)
    if conv_route("log", bits) == "template":
        return _launch_log(_LOG_WIDE, x, w3, sx, sw, bits, compensated, kh,
                           kw, stride, torch.float32)
    return _conv_log_tile(x, w3, sx, sw, bits, compensated, kh, kw, stride)


def conv_log_partial(x: torch.Tensor, w3: torch.Tensor, sx: torch.Tensor,
                     sw: torch.Tensor, bits: int = 8,
                     compensated: bool = True, kh: int = 3, kw: int = 3,
                     stride: int = 1) -> torch.Tensor:
    """Shard-local log-family conv over a slice of the input channels:
    shapes as ``conv_lut_partial``, the raw int32 sum out."""
    _geometry(x, w3, kh, kw, stride)
    if not on_cuda(x, w3, sx, sw):
        return conv_log_partial_plain(x, w3, sx, sw, bits, compensated, kh,
                                      kw, stride)
    if conv_route("log", bits) == "template":
        return _launch_log(_LOG_PARTIAL_WIDE, x, w3, sx, sw, bits,
                           compensated, kh, kw, stride, torch.int32)
    return _conv_log_tile(x, w3, sx, sw, bits, compensated, kh, kw, stride,
                          partial=True)


def conv_mxu_fused(x: torch.Tensor, w3: torch.Tensor, sx: torch.Tensor,
                   sw: torch.Tensor, bits: int = 8, kh: int = 3, kw: int = 3,
                   stride: int = 1) -> torch.Tensor:
    """Exact-family implicit-GEMM conv (exact mode): shapes and scales as
    ``conv_lut_fused``; the exact integer products summed in int32, then
    ``(acc * sx) * sw``."""
    b, h, w, c, n = _geometry(x, w3, kh, kw, stride)
    if not on_cuda(x, w3, sx, sw):
        return conv_mxu_fused_plain(x, w3, sx, sw, bits, kh, kw, stride)
    _check_operands(x, w3, sx, sw, n)
    require(2 <= bits <= 8,
            f"the exact conv kernel takes 2..8-bit operands, got {bits}")
    require(kh * kw <= MXU_MAX_TAPS,
            f"the exact conv kernel takes at most {MXU_MAX_TAPS} taps (one "
            f"pixel's halo), got {kh}x{kw}")
    oh, ow = conv_out_hw(h, w, kh, kw, stride)
    out = torch.empty((b, oh, ow, n), dtype=torch.float32, device=x.device)
    _MXU(x.data_ptr(), w3.data_ptr(), sx.data_ptr(), sw.data_ptr(),
         out.data_ptr(), b, h, w, c, n, kh, kw, stride, bits,
         gemm_smem_bytes("mxu", bits), stream_of(x))
    return out
