"""The CiM convs' tile kernel on the CPU.  csrc/conv_tile.cuh runs
``conv_lut_fused`` (full table and nibble sub-tables) and
``conv_log_fused`` (mitchell, log_our) up to 8 bits, and their partial
forms ``conv_lut_partial`` and ``conv_log_partial`` (the raw int32 sum);
`conv_gemm.conv_plan` cuts each launch into spatial tiles with all of N,
channel chunks and tap groups over a persistent grid.  Here: the plan's
tiles cover every output pixel and column once, its chunks and groups
every (tap, channel) once, its halos stay inside the padded image and its
shared memory is the planner's total, also at the mesh path's shard
geometries; a plain torch walk of the plan (the kernel's staged forms,
halo and weight layouts, index arithmetic and int32 sums per tile) is
bitwise the plain versions, partial and fused; the route between the
tile kernel and the template, and the planner's gate, are as before.
The kernel itself runs only on the card (tests/test_torch_gpu.py)."""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import approx_gemm as ag
from repro_torch.core.approx_gemm import ConvParams, conv_out_hw, plan_conv
from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.kernels import conv_gemm as cg
from repro_torch.kernels import ops
from repro_torch.kernels.build import SMEM_BYTES

FORMS = ("lut", "nibble", "mitchell", "log_our")
# the blocks an SM holds by form on an H100 (the 8-bit table leaves room
# for one; the others fit two), and its SMs
PER_SM = {"lut": 1, "nibble": 2, "mitchell": 2, "log_our": 2}
SMS = 132

# (B, H, W, C, N, kh, kw, stride): the Table IV CNN's five convs at the
# evaluation batch, tests/test_conv.py's ragged shapes, stride 2 with 5x5
# and 7x7 taps, C in {3, 17, 96} and N in {1, 7, 16, 17, 80}, and one
# ResNet-18 conv2_x layer
CNN = [(256, 16, 16, 3, 16, 3, 3, 1), (256, 16, 16, 16, 16, 3, 3, 1),
       (256, 8, 8, 16, 32, 3, 3, 1), (256, 8, 8, 32, 32, 3, 3, 1),
       (256, 4, 4, 32, 64, 3, 3, 1)]
RAGGED = [(2, 9, 10, 5, 7, 3, 3, 1), (1, 7, 7, 3, 4, 5, 5, 1),
          (3, 8, 6, 4, 5, 1, 1, 1), (2, 10, 9, 3, 6, 3, 3, 2)]
EDGES = [(2, 13, 13, 3, 16, 5, 5, 2), (2, 30, 30, 3, 64, 7, 7, 2),
         (3, 12, 12, 17, 80, 3, 3, 1), (1, 20, 60, 96, 24, 3, 3, 1),
         (2, 11, 7, 17, 1, 3, 3, 1), (2, 9, 9, 3, 7, 3, 3, 1),
         (5, 4, 4, 8, 17, 3, 3, 1), (4, 56, 56, 64, 64, 3, 3, 1)]
# the mesh path's conv partials (chip_smoke.py check_partials): the CNN's
# convs with the input channels halved where they split; conv 1 (C = 3,
# not split) is CNN[0]
SHARDS = [(256, 16, 16, 8, 16, 3, 3, 1), (256, 8, 8, 8, 32, 3, 3, 1),
          (256, 8, 8, 16, 32, 3, 3, 1), (256, 4, 4, 16, 64, 3, 3, 1)]
GEOMS = CNN + RAGGED + EDGES + SHARDS


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch ops, restored after it
    (its ops are small; next to the other test workers torch's default
    pool waits on cores they hold)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _plans(form, geom, bits=8):
    """The plan conv_plan takes, then every micro-tile it could take."""
    b, h, w, c, n, kh, kw, s = geom
    args = (form, bits, b, h, w, c, n, kh, kw, s, SMS, PER_SM[form])
    out = [cg.conv_plan(*args)]
    for micro in cg.TILE_MICRO:
        try:
            out.append(cg.conv_plan(*args, force=micro))
        except ValueError:        # no tile of that micro-tile fits
            pass
    return out


def _tiles(plan, b, oh, ow):
    """(b0, oy0, ox0) of each tile, in the kernel's tile order."""
    tc_n, tr_n = -(-ow // plan.tc), -(-oh // plan.tr)
    for t in range(plan.tiles):
        tci, r = t % tc_n, t // tc_n
        tri, r = r % tr_n, r // tr_n
        yield r * plan.ib, tri * plan.tr, tci * plan.tc


def _slots(plan):
    """(slot pixel p, its tile coordinates ib, ty, tx) of every live
    thread's pixel slots p = pg + i pg_count < P."""
    tile_px = plan.tr * plan.tc
    p_all = plan.ib * tile_px
    for pg in range(plan.pg):
        for i in range(plan.rp):
            p = pg + i * plan.pg
            if p < p_all:
                ib, rr = divmod(p, tile_px)
                yield p, ib, *divmod(rr, plan.tc)


def _real(plan, b, oh, ow):
    """Every (tile, slot) of a real output pixel: arrays of the tile's
    (b0, oy0, ox0) and the slot's (ib, ty, tx), broadcast."""
    t = np.array(list(_tiles(plan, b, oh, ow)))[:, None, :]
    sl = np.array([x[1:] for x in _slots(plan)])[None, :, :]
    at = t + sl
    keep = (at[..., 0] < b) & (at[..., 1] < oh) & (at[..., 2] < ow)
    return (np.broadcast_to(t, at.shape)[keep],
            np.broadcast_to(sl, at.shape)[keep], at[keep])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("geom", GEOMS, ids=str)
def test_tiles_cover_every_output_pixel_and_column_once(form, geom):
    b, h, w, c, n, kh, kw, s = geom
    oh, ow = conv_out_hw(h, w, kh, kw, s)
    for plan in _plans(form, geom):
        assert plan.tiles >= plan.grid >= 1
        assert len(set(x[0] for x in _slots(plan))) == min(
            plan.ib * plan.tr * plan.tc, plan.pg * plan.rp)
        _, _, at = _real(plan, b, oh, ow)
        seen = np.zeros((b, oh, ow), np.int64)
        np.add.at(seen, (at[:, 0], at[:, 1], at[:, 2]), 1)
        assert (seen == 1).all(), plan
        cols = np.zeros(n, np.int64)
        for n0 in range(0, n, plan.nt):
            nt = min(plan.nt, n - n0)
            for cgi, j in itertools.product(range(plan.ng), range(plan.rn)):
                if cgi * plan.rn < nt and cgi * plan.rn + j < nt:
                    cols[n0 + cgi * plan.rn + j] += 1
        assert (cols == 1).all() and plan.ng * plan.pg <= cg.TILE_THREADS
        assert plan.n_tiles == -(-n // plan.nt)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("geom", GEOMS, ids=str)
def test_chunks_and_groups_cover_every_tap_and_channel_once(form, geom):
    b, h, w, c, n, kh, kw, s = geom
    cpw = cg.TILE_CPW[form]
    for plan in _plans(form, geom):
        seen = np.zeros((kh * kw, c), np.int64)
        for c0 in range(0, c, plan.cc):
            for t0 in range(0, kh * kw, plan.tg):
                for tl in range(min(plan.tg, kh * kw - t0)):
                    for wd in range(plan.ccw):
                        for u in range(cpw):
                            ch = c0 + wd * cpw + u
                            if ch < c:
                                seen[t0 + tl, ch] += 1
        assert (seen == 1).all(), plan
        assert plan.cc % 4 == 0 and plan.ccw * cpw == plan.cc
        assert plan.tg * plan.ccw * plan.ntp <= cg.TILE_W_ENTRIES[form]
        assert plan.whole == (plan.chunks == plan.groups == plan.n_tiles
                              == 1)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("geom", GEOMS, ids=str)
def test_halos_fit_and_stay_inside_the_padded_image(form, geom):
    """Each tile's halo fits TILE_HALO_WORDS at an odd pixel stride, and
    every halo element a real output pixel reads lies inside the padded
    image and inside the tile's halo window."""
    b, h, w, c, n, kh, kw, s = geom
    oh, ow = conv_out_hw(h, w, kh, kw, s)
    ph, pw = kh // 2, kw // 2
    for plan in _plans(form, geom):
        assert plan.ps % 2 == 1 and plan.ps >= plan.ccw
        assert plan.ib * plan.hr * plan.hc * plan.ps <= cg.TILE_HALO_WORDS
        t, sl, _ = _real(plan, b, oh, ow)
        ty, tx = sl[:, 1], sl[:, 2]
        # the window's last row and column inside the halo
        assert (ty * s + kh <= plan.hr).all() and (tx * s + kw <= plan.hc).all()
        iy = t[:, 1] * s - ph + ty * s
        ix = t[:, 2] * s - pw + tx * s
        assert (iy >= -ph).all() and (iy + kh - 1 <= h - 1 + ph).all()
        assert (ix >= -pw).all() and (ix + kw - 1 <= w - 1 + pw).all()


@pytest.mark.parametrize("bits", range(2, 17))
def test_shared_memory_is_the_planners_total(bits):
    """The tile kernel's layout (table, mbarrier, halo, weight region)
    is gemm_smem_bytes of its core up to 8 bits, the same for every
    geometry and within a block's limit; wider log operands take the
    template's total."""
    for form, core in (("lut", "lut"), ("nibble", "nibble"),
                       ("mitchell", "log"), ("log_our", "log")):
        if bits > cg.TILE_MAX_BITS:
            if core == "log":
                assert cg.conv_route(core, bits) == "template"
                assert cg.gemm_smem_bytes(core, bits) == \
                    cg.template_smem_bytes(core, bits) <= SMEM_BYTES
            continue
        assert cg.conv_route(core, bits) == "tile"
        total = cg.tile_smem_bytes(form, bits)
        assert total == cg.gemm_smem_bytes(core, bits) <= SMEM_BYTES
        assert cg.template_smem_bytes(core, bits) <= SMEM_BYTES
        for geom in (CNN[1], EDGES[1], EDGES[3]):
            b, h, w, c, n, kh, kw, s = geom
            plan = cg.conv_plan(form, bits, b, h, w, c, n, kh, kw, s, SMS,
                                PER_SM[form])
            assert plan.smem == total


def test_plan_fills_the_card_at_the_cnn_convs():
    """At the CNN's convs the plan leaves no thread slot empty and no
    column past N, launches at most one block a resident slot, and the
    whole tap stack fits the weight region (a block keeps it when one
    chunk holds the channels)."""
    for form in FORMS:
        for geom in CNN:
            b, h, w, c, n, kh, kw, s = geom
            plan = cg.conv_plan(form, 8, b, h, w, c, n, kh, kw, s, SMS,
                                PER_SM[form])
            assert plan.ib * plan.tr * plan.tc == plan.pg * plan.rp
            assert plan.ng * plan.rn == plan.nt == n
            assert plan.grid == min(plan.tiles, SMS * PER_SM[form])
            stack = kh * kw * -(-c // 4) * 4 // cg.TILE_CPW[form] * n
            assert stack <= cg.TILE_W_ENTRIES[form]
            assert plan.whole == (plan.chunks == 1)


def test_plan_refuses_what_no_tile_holds():
    with pytest.raises(ValueError, match="2..8-bit"):
        cg.conv_plan("mitchell", 9, 2, 8, 8, 4, 4, 3, 3, 1, SMS, 2)
    with pytest.raises(ValueError, match="no tile"):
        cg.conv_plan("lut", 8, 1, 99, 99, 4, 4, 99, 99, 1, SMS, 1)
    with pytest.raises(ValueError, match="no tile"):
        cg.conv_plan("lut", 8, 2, 8, 8, 4, 4, 3, 3, 1, SMS, 0)


# --- a plain walk of the plan: the kernel's staged forms and layouts ------

def _u32(v):
    return v & 0xFFFFFFFF


def _sbyte(word, i):
    b = (word >> (8 * i)) & 0xFF
    return (b ^ 0x80) - 0x80


def _dp4a(a, b):
    return sum(_sbyte(a, i) * _sbyte(b, i) for i in range(4))


def _log_parts(v, bits):
    """(sign, mag, k, q) as cim_gemm.cuh's decompose()."""
    s = torch.sign(v)
    mag = v.abs()
    k = torch.zeros_like(mag)
    for i in range(1, bits):
        k = torch.where(mag >= (1 << i), torch.full_like(mag, i), k)
    q = torch.where(mag == 0, torch.zeros_like(mag), mag - (1 << k))
    return s, mag, k, q


def _x_bytes(v, bits):
    s, mag, k, _ = _log_parts(v, bits)
    return ((s * mag) & 0xFF) | (((s * (1 << k)) & 0xFF) << 8)


def _w_bytes(v, bits):
    s, _, k, q = _log_parts(v, bits)
    return ((s * (1 << k)) & 0xFF) | (((s * q) & 0xFF) << 8)


def _comp_pow_word(v, bits):
    """comp_pow_word: 2^c(q) in byte 3, q in byte 2."""
    q = _log_parts(v, bits)[3]
    m = torch.zeros_like(q)
    for i in range(1, bits):
        m = torch.where(q >= (1 << i), torch.full_like(q, i), m)
    c = torch.where(q == 0, torch.zeros_like(q),
                    m + ((q << 1) >= 3 * (1 << m)).to(q.dtype))
    return ((1 << c) << 24) | (q << 16)


def _nibble_word(v, bits, x_side):
    """NibbleCore::stage_a / stage_b as TileNibble packs them: byte
    offsets into the laid-out sub-tables (rows `stride` apart)."""
    h = bits >> 1
    hb, qmax = 1 << h, (1 << (bits - 1)) - 1
    stride = cg.table_layout("nibble", bits)[2]
    mag = v.abs().clamp(max=qmax)
    hi, lo, s = mag >> h, mag & (hb - 1), torch.sign(v)
    if x_side:                      # rows hi and 2 hb + lo
        first, second = hi * stride, (2 * hb + lo) * stride
    else:                           # column hi; row hb, column lo
        first, second = hi * 4, hb * stride + lo * 4
    return _u32(first | (second << 13) | ((s & 3) << 30))


def _x_word(form, q0, q1, bits):
    if form == "lut":
        return (q0 + (1 << (bits - 1))) * cg.table_layout("lut", bits)[2]
    if form == "nibble":
        return _nibble_word(q0, bits, True)
    if form == "mitchell":
        return _x_bytes(q0, bits) | (_x_bytes(q1, bits) << 16)
    return _x_bytes(q0, bits) | _comp_pow_word(q0, bits)


def _w_word(form, q0, q1, bits):
    if form == "lut":
        return (q0 + (1 << (bits - 1))) * 2
    if form == "nibble":
        return _nibble_word(q0, bits, False)
    if form == "mitchell":
        return _w_bytes(q0, bits) | (_w_bytes(q1, bits) << 16)
    return _w_bytes(q0, bits) | _comp_pow_word(q0, bits)


def _laid_out(form, table, bits):
    """The table as the kernel lays it out in shared memory: its bytes,
    row by row at the layout's stride, as int16 (LUT) or int32 (nibble)
    entries indexed by byte offset / entry size."""
    row, rows, stride = cg.table_layout(form, bits)
    src = table.reshape(-1).contiguous().numpy().view(np.uint8)
    out = np.zeros(rows * stride, np.uint8)
    for r in range(rows):
        out[r * stride:r * stride + row] = src[r * row:(r + 1) * row]
    kind = np.int16 if form == "lut" else np.int32
    return torch.from_numpy(out.view(kind).astype(np.int64))


def _products(form, a, b, tab):
    """The kernel's product of staged words: a (P, 1) x b (1, NTP); `tab`
    the laid-out table."""
    if form == "lut":
        return tab[(a + b) // 2]
    if form == "nibble":
        ax, ay, sa = a & 0x1FFF, (a >> 13) & 0x1FFF, _sbyte(a >> 24, 0) >> 6
        bx, by, sb = b & 0x1FFF, (b >> 13) & 0x1FFF, _sbyte(b >> 24, 0) >> 6
        mag = tab[(ax + bx) // 4] + tab[(ax + by) // 4] \
            + tab[(ay + bx) // 4] + tab[(ay + by) // 4]
        return sa * sb * mag
    if form == "mitchell":
        return _dp4a(a, b)
    bd, bc = b & 0xFFFF, b & 0xFFFF0000
    mx, mn = torch.maximum(a, bc), torch.minimum(a, bc)
    comp = ((mn >> 16) & 0xFF) * (mx >> 24)
    sa = torch.where(_sbyte(a, 0) < 0, -1, 0)
    sb = torch.where(_sbyte(bd, 0) < 0, -1, 0)
    return _dp4a(a, bd) + comp * ((sa ^ sb) | 1)


def _walk(form, plan, xq, wq, table, bits):
    """The kernel's arithmetic over `plan`, tile by tile: the halo of each
    chunk staged from the quantized image into a flat word array at the
    plan's pixel stride, the weights of each group k-word major over the
    padded N tile, a thread slot's pixel read at its halo base + the
    tap's offset + the channel word, products summed in int32 per tile.
    xq (B, H, W, C) and wq (taps, C, N) are the quantized operands;
    returns the int32 (B, OH, OW, N) sum."""
    b, h, w, c = xq.shape
    taps, _, n = wq.shape
    kh, kw, s = plan.kh, plan.kw, plan.stride
    oh, ow = conv_out_hw(h, w, kh, kw, s)
    ph, pw = kh // 2, kw // 2
    cpw = cg.TILE_CPW[form]
    if table is not None:
        table = _laid_out(form, table, bits)
    out = torch.zeros((b * oh * ow, n), dtype=torch.int64)
    slots = list(_slots(plan.p))
    p = plan.p
    for b0, oy0, ox0 in _tiles(p, b, oh, ow):
        hb = torch.tensor([((ib * p.hr + ty * s) * p.hc + tx * s) * p.ps
                           for _, ib, ty, tx in slots])
        om = torch.tensor([((b0 + ib) * oh + oy0 + ty) * ow + ox0 + tx
                           if b0 + ib < b and oy0 + ty < oh and ox0 + tx < ow
                           else -1 for _, ib, ty, tx in slots])
        for n0 in range(0, n, p.nt):
            nt = min(p.nt, n - n0)
            acc = torch.zeros((len(slots), p.ntp), dtype=torch.int64)
            for c0 in range(0, c, p.cc):
                # the halo: (ib, hy, hx) pixels x ps words
                halo = torch.zeros((p.ib, p.hr, p.hc, p.ps), dtype=torch.int64)
                q = torch.zeros((p.ib, p.hr, p.hc, p.cc), dtype=torch.int64)
                for ib in range(p.ib):
                    for hy in range(p.hr):
                        iy = oy0 * s - ph + hy
                        for hx in range(p.hc):
                            ix = ox0 * s - pw + hx
                            if (b0 + ib < b and 0 <= iy < h and 0 <= ix < w):
                                v = xq[b0 + ib, iy, ix, c0:c0 + p.cc]
                                q[ib, hy, hx, :v.numel()] = v
                halo[..., :p.ccw] = _x_word(form, q[..., 0::cpw],
                                            q[..., cpw - 1::cpw], bits)
                flat = halo.reshape(-1)
                for t0 in range(0, taps, p.tg):
                    ntap = min(p.tg, taps - t0)
                    wqs = torch.zeros((ntap, p.cc, p.ntp), dtype=torch.int64)
                    v = wq[t0:t0 + ntap, c0:c0 + p.cc, n0:n0 + nt]
                    wqs[:, :v.shape[1], :nt] = v
                    wt = _w_word(form, wqs[:, 0::cpw], wqs[:, cpw - 1::cpw],
                                 bits).reshape(-1, p.ntp)
                    ki, kj = divmod(t0, kw)
                    for tl in range(ntap):
                        toff = (ki * p.hc + kj) * p.ps
                        for cw in range(p.ccw):
                            a = flat[hb + toff + cw].reshape(-1, 1)
                            bw = wt[tl * p.ccw + cw].reshape(1, -1)
                            acc += _products(form, a, bw, table)
                        kj += 1
                        if kj == kw:
                            kj, ki = 0, ki + 1
            acc = _u32(acc)
            live = om >= 0
            out[om[live], n0:n0 + nt] = acc[live][:, :nt]
    out = torch.where(out >= 1 << 31, out - (1 << 32), out)
    return out.to(torch.int32).reshape(b, oh, ow, n)


class _Plan:
    def __init__(self, plan, kh, kw, stride):
        self.p, self.kh, self.kw, self.stride = plan, kh, kw, stride


def _operands(geom, seed):
    b, h, w, c, n, kh, kw, s = geom
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, w, c), np.float32))
    w3 = torch.from_numpy(
        rng.standard_normal((kh * kw, c, n), np.float32) * 0.1)
    sx, sw = ops._scales(x, w3.reshape(-1, n), 8)
    return x, w3, sx, sw


# batch 2: the CNN's convs, the ragged shapes, stride 2 with 5x5 taps,
# several N tiles (N 80), chunks of channels (C 96), and N = 1; then the
# shard geometries, whose walks are held to the partial forms alone
WALK = ([(2,) + g[1:] for g in CNN] + RAGGED
        + [EDGES[0], EDGES[2], (1, 6, 20, 96, 24, 3, 3, 1),
           (2, 5, 7, 17, 1, 3, 3, 1)])
SHARD_WALK = [(2,) + g[1:] for g in SHARDS]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("geom", WALK + SHARD_WALK, ids=str)
def test_plain_walk_of_the_plan_equals_the_plain_version(form, geom):
    """The walk's raw int32 sum is bitwise the partial form's plain
    version and, through the epilogue, the fused form's; at the shard
    geometries the scales are global ones, 1.25x the shard's own, as the
    mesh path supplies them, and the raw sum alone is held."""
    b, h, w, c, n, kh, kw, s = geom
    x, w3, sx, sw = _operands(geom, sum(geom))
    shard = geom in SHARD_WALK
    if shard:
        sx, sw = sx * 1.25, sw * 1.25
    qmax = 127
    xq = cg.quantize_tile(x, sx.reshape(()), qmax).long()
    wq = cg.quantize_tile(w3, sw.reshape(1, 1, -1), qmax).long()
    geo = dict(kh=kh, kw=kw, stride=s)
    table = None
    if form == "lut":
        table = ops.lut_table(MultiplierSpec("appro42", 8, True), "cpu")
    elif form == "nibble":
        table = ops.nibble_table(MultiplierSpec("exact", 8, True), "cpu")
    if table is not None:
        nib = form == "nibble"
        raw = cg.conv_lut_partial_plain(x, w3, table, sx, sw, nibble=nib,
                                        **geo)
        want = (None if shard else cg.conv_lut_fused_plain(
            x, w3, table, sx, sw, nibble=nib, **geo))
    else:
        comp = form == "log_our"
        raw = cg.conv_log_partial_plain(x, w3, sx, sw, compensated=comp,
                                        **geo)
        want = (None if shard else cg.conv_log_fused_plain(
            x, w3, sx, sw, compensated=comp, **geo))
    # the plan's own pick and, at the first geometries, every micro-tile
    plans = _plans(form, geom)
    for plan in plans[:1] if geom not in WALK[:2] else plans:
        acc = _walk(form, _Plan(plan, kh, kw, s), xq, wq, table, 8)
        assert acc.dtype == torch.int32 and torch.equal(acc, raw), plan
        if want is not None:
            assert torch.equal((acc.float() * sx) * sw, want), plan


def test_nibble_words_pack_every_operand_in_range():
    """The packed nibble fields stay below 2^13, their sums (the gathered
    byte offsets) inside the laid-out sub-tables, and the sign field
    decodes to the operand's sign, at every 8-bit operand."""
    v = torch.arange(-127, 128)
    a, b = _nibble_word(v, 8, True), _nibble_word(v, 8, False)
    for word in (a, b):
        assert int(word.min()) >= 0 and int(word.max()) < 1 << 32
        assert int(((word >> 26) & 0xF).max()) == 0
    row, rows, stride = cg.table_layout("nibble", 8)
    top = int(((a >> 13) & 0x1FFF).max() + ((b >> 13) & 0x1FFF).max())
    assert top + 4 <= rows * stride
    assert torch.equal(_sbyte(a >> 24, 0) >> 6, torch.sign(v))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_lut_rows_spread_over_the_banks(bits):
    """The laid-out LUT's row offsets address the gathered entry, and at 8
    bits the padded rows start on eight different bank offsets."""
    h = 1 << (bits - 1)
    row, rows, stride = cg.table_layout("lut", bits)
    v = torch.arange(-(h - 1), h)
    a, b = _x_word("lut", v, v, bits), _w_word("lut", v, v, bits)
    table = torch.arange(rows * rows, dtype=torch.int16).reshape(rows, rows)
    tab = _laid_out("lut", table, bits)
    got = tab[(a.reshape(-1, 1) + b.reshape(1, -1)) // 2]
    want = table.long()[(v + h).reshape(-1, 1), (v + h).reshape(1, -1)]
    assert torch.equal(got, want)
    if bits == 8:
        assert len({(r * stride // 4) % 32 for r in range(rows)}) == 8


# --- routing: the tile kernel up to 8 bits, the template above; the
# planner's gate and routes as before ---------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 8, 9, 12, 16])
def test_conv_route_is_the_bits_gate(bits):
    for core in ("lut", "nibble", "log"):
        assert cg.conv_route(core, bits) == (
            "tile" if bits <= 8 else "template")
    with pytest.raises(ValueError):
        cg.conv_route("mxu", 8)


def test_gate_and_routes_are_as_before():
    """`_conv_kernel_fits` admits every (entry, bits) the conv entries
    accept, as the template's model alone did, and `plan_conv` sends each
    family, mode and width to the same entry as before."""
    for name, core in ag._CONV_CORES.items():
        entry = ag._REGISTRY[name]
        for bits in range(2, entry.max_bits + 1):
            before = (core == "mxu"
                      or cg.template_smem_bytes(core, bits) <= SMEM_BYTES)
            assert ag._conv_kernel_fits(name, bits) == before is True
    cases = [("exact", "hardware", 8, MultiplierSpec("exact", 8, True),
              "cuda_conv_nibble"),
             ("appro42", "hardware", 8, MultiplierSpec("appro42", 8, True),
              "cuda_conv_lut"),
             ("appro42", "hardware", 8,
              MultiplierSpec("appro42", 8, True, n_approx_cols=4),
              "cuda_conv_nibble"),
             ("appro42", "hardware", 4, MultiplierSpec("appro42", 4, True),
              "cuda_conv_nibble"),
             ("appro42", "hardware", 8,
              MultiplierSpec("appro42", 8, True, "orplane", 10),
              "cuda_conv_lut"),
             ("mitchell", "hardware", 8, None, "cuda_conv_log"),
             ("log_our", "hardware", 8, None, "cuda_conv_log"),
             ("log_our", "hardware", 12, None, "cuda_conv_log"),
             ("mitchell", "hardware", 16, None, "cuda_conv_log"),
             ("exact", "exact", 8, None, "cuda_conv_mxu")]
    for fam, mode, bits, spec, want in cases:
        for geom in (CNN[0], CNN[4], (4, 56, 56, 64, 64, 3, 3, 1),
                     (2, 30, 30, 3, 64, 7, 7, 2)):
            b, h, w, c, n, kh, kw, s = geom
            got = plan_conv(fam, mode, bits, b, h, w, c, n,
                            ConvParams(kh, kw, s), "cuda", spec=spec)
            assert got.entry.name == want, (fam, bits, geom)
            cpu = plan_conv(fam, mode, bits, b, h, w, c, n,
                            ConvParams(kh, kw, s), "cpu", spec=spec)
            assert cpu.entry.name == want.replace("cuda", "torch")
    # a geometry whose scales the implicit kernels cannot reproduce goes
    # to the oracle, as before
    odd = plan_conv("mitchell", "hardware", 8, 2, 10, 10, 4, 4,
                    ConvParams(1, 1, 2), "cuda")
    assert odd.entry.name == "conv_im2col"


class _Recorder:
    def __init__(self, kern):
        self.symbol, self.argtypes, self.calls = (kern.symbol, kern.argtypes,
                                                  [])

    def __call__(self, *args):
        assert len(args) == len(self.argtypes), self.symbol
        self.calls.append(args)


def _card_side(monkeypatch):
    monkeypatch.setattr(cg, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cg, "stream_of", lambda t: 0)

    cache = {}

    def plan(form, bits, x, w3, kh, kw, stride, force=None):
        """device_plan's H100 answer, cached by shape as device_plan is."""
        key = (form, bits, *x.shape, w3.shape[2], kh, kw, stride, force)
        if key not in cache:
            b, h, w, c = x.shape
            cache[key] = cg.conv_plan(form, bits, b, h, w, c, w3.shape[2],
                                      kh, kw, stride, SMS, PER_SM[form],
                                      force=force)
        return cache[key]

    monkeypatch.setattr(cg, "device_plan", plan)
    rec = {name: _Recorder(getattr(cg, name))
           for name in ("_LUT", "_LOG", "_LOG_WIDE", "_LUT_PARTIAL",
                        "_LOG_PARTIAL", "_LOG_PARTIAL_WIDE")}
    for name, r in rec.items():
        monkeypatch.setattr(cg, name, r)
    return rec


@pytest.mark.parametrize("bits", [4, 8, 12, 16])
@pytest.mark.parametrize("compensated", [False, True])
def test_fused_log_takes_the_route_of_its_bits(monkeypatch, bits,
                                               compensated):
    """Up to 8 bits conv_log_fused launches the tile entry with the plan
    (rp, rn, ib, tr, tc, cc, tg, grid) and the planner's total, above it
    the template's entry conv_log_fused_wide; the partial takes the same
    route through its own entries (conv_log_partial with the same plan,
    conv_log_partial_wide), an int32 out."""
    rec = _card_side(monkeypatch)
    geom = CNN[2]
    x, w3, sx, sw = _operands(geom, 3)
    out = cg.conv_log_fused(x, w3, sx, sw, bits=bits,
                            compensated=compensated)
    assert out.shape == (256, 8, 8, 32) and out.dtype == torch.float32
    tile = bits <= 8
    used, idle = ("_LOG", "_LOG_WIDE")[::1 if tile else -1]
    (args,) = rec[used].calls
    assert not rec[idle].calls
    assert args[5:15] == (256, 8, 8, 16, 32, 3, 3, 1, bits,
                          int(compensated))
    if tile:
        plan = cg.conv_plan("log_our" if compensated else "mitchell", bits,
                            256, 8, 8, 16, 32, 3, 3, 1, SMS, 2)
        assert args[15:24] == (cg.gemm_smem_bytes("log", bits), plan.rp,
                               plan.rn, plan.ib, plan.tr, plan.tc, plan.cc,
                               plan.tg, plan.grid)
    else:
        assert args[15] == cg.template_smem_bytes("log", bits)
    fused_args = args
    part = cg.conv_log_partial(x, w3, sx, sw, bits=bits,
                               compensated=compensated)
    assert part.shape == (256, 8, 8, 32) and part.dtype == torch.int32
    used, idle = ("_LOG_PARTIAL", "_LOG_PARTIAL_WIDE")[::1 if tile else -1]
    (args,) = rec[used].calls
    assert not rec[idle].calls
    assert args[5:] == fused_args[5:]
    if tile:
        assert args[15] == cg.gemm_smem_bytes("log", bits)
    else:
        assert args[15] == cg.template_smem_bytes("log", bits)


@pytest.mark.parametrize("nibble", [False, True])
def test_fused_lut_launches_the_tile_kernel(monkeypatch, nibble):
    rec = _card_side(monkeypatch)
    geom = CNN[4]
    x, w3, sx, sw = _operands(geom, 4)
    spec = MultiplierSpec("exact", 8, True)
    table = (ops.nibble_table(spec, "cpu") if nibble
             else ops.lut_table(spec, "cpu"))
    cg.conv_lut_fused(x, w3, table, sx, sw, nibble=nibble)
    (args,) = rec["_LUT"].calls
    form = "nibble" if nibble else "lut"
    plan = cg.conv_plan(form, 8, 256, 4, 4, 32, 64, 3, 3, 1, SMS,
                        PER_SM[form])
    assert args[15] == int(nibble)
    assert args[16:25] == (cg.gemm_smem_bytes(form, 8), plan.rp, plan.rn,
                           plan.ib, plan.tr, plan.tc, plan.cc, plan.tg,
                           plan.grid)
    fused_args = args
    part = cg.conv_lut_partial(x, w3, table, sx, sw, nibble=nibble)
    assert part.dtype == torch.int32
    (args,) = rec["_LUT_PARTIAL"].calls
    assert args[15] == int(nibble)
    assert args[16:25] == (cg.gemm_smem_bytes(form, 8), plan.rp, plan.rn,
                           plan.ib, plan.tr, plan.tc, plan.cc, plan.tg,
                           plan.grid)
    assert args[6:] == fused_args[6:]


def test_every_launch_reads_the_planners_total(monkeypatch):
    """The plan is cached by shape, but each launch passes the current
    gemm_smem_bytes, so the kernel's refusal of another total holds at
    every call (tests/test_torch_gpu.py patches it on the card)."""
    rec = _card_side(monkeypatch)
    x, w3, sx, sw = _operands(CNN[2], 5)
    cg.conv_log_fused(x, w3, sx, sw, compensated=False)
    real = cg.gemm_smem_bytes
    monkeypatch.setattr(cg, "gemm_smem_bytes", lambda *a: real(*a) + 16)
    cg.conv_log_fused(x, w3, sx, sw, compensated=False)
    first, second = rec["_LOG"].calls
    assert second[15] == first[15] + 16 == real("log", 8) + 16
