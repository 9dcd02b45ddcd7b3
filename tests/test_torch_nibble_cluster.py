"""The nibble forms of the split-K cluster GEMM on the CPU.

csrc/cluster_gemm.cuh runs ``nibble_lut_matmul_fused`` and
``nibble_lut_matmul_partial`` with its ClusterNibbleCore: once a block it
folds the four sub-tables [S_hh, S_hl, S_lh, S_ll] into one table of
signed rows, row v = -qmax..qmax holding sign(v) (Q_h[|v|] | Q_l[|v|]),
Q_h[am][bh] = S_hh[am >> h][bh] + S_lh[am & (hb-1)][bh] and Q_l[am][bl] =
S_hl[am >> h][bl] + S_ll[am & (hb-1)][bl]; an x operand stages as the
byte offset of its row, a weight as the byte offsets of its two columns
and its sign, and a product is sign(b) (row[bh] + row[bl]).  Here a plain
torch model of that fold and of those staged forms is held against
``ref.nibble_sum`` and the reference's ``_gather_nibble`` on every operand
pair at 2, 4, 6 and 8 bits (the exact family, appro42 with its
approximate columns in the low half-word, and random sub-tables at the
int32 limit that ``ops._subs_np`` admits, row 0 nonzero), with every
gather of a warp in one bank line; the kernel's rank-order split-K sum of
those products against the plain partial; the whole fused form against
the JAX kernel; the launch plan at the LM and shard shapes; and the
wrappers' card side (faked): the cluster entries with the plan.  The int
form ``nibble_lut_matmul`` (int8 operands, IntOut) runs the same core,
its staging saturating both magnitudes at qmax (int8 -128, and below 8
bits every magnitude past qmax, which the quantized forms never meet):
its staged products on every int8 pair, its split-K sum, the whole int
form against the JAX kernel, its plan at the served shapes and its card
side.  The kernels themselves run only on the card
(tests/test_torch_gpu.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.approx_matmul import _gather_nibble
from repro.kernels.approx_matmul import nibble_lut_matmul as j_int
from repro.kernels.approx_matmul import nibble_lut_matmul_fused as j_fused
from repro_torch.kernels import approx_matmul, ops
from repro_torch.kernels import ref as tref

BITS = (2, 4, 6, 8)
INT32_MAX = (1 << 31) - 1
# the shared-memory bank line: 32 words
LINE_WORDS = 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch ops, restored after it
    (small ops next to the other test workers: see
    tests/test_torch_slstm_plan.py)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _wrap32(v):
    return ((v + (1 << 31)) % (1 << 32)) - (1 << 31)


def _random_subs(bits, seed=0):
    """Four non-negative sub-tables whose largest entries sum to within 4
    of 2^31 - 1 (the most ``ops._subs_np`` admits), no entry 0: rows and
    columns 0 nonzero."""
    hb = 1 << (bits // 2)
    top = INT32_MAX // 4
    rng = np.random.default_rng(seed + bits)
    subs = rng.integers(1, top + 1, (4, hb * hb), dtype=np.int64)
    subs[:, rng.integers(0, hb * hb)] = top
    worst = int(subs.max(axis=1).sum())
    assert INT32_MAX - 4 <= worst <= INT32_MAX and subs.min() > 0
    return torch.from_numpy(subs.astype(np.int32).ravel())


def _subs(kind, bits):
    if kind == "exact":
        return torch.from_numpy(ops._subs_np("exact", bits, "orplane", None))
    if kind == "appro42":     # approximate columns in the low half-word
        return torch.from_numpy(ops._subs_np("appro42", bits, "orplane",
                                             bits // 2))
    return _random_subs(bits)


# --- the kernel's forms, as cluster_gemm.cuh computes them ------------------

def table_bytes(bits):
    """ClusterNibbleCore::table_bytes: 2 qmax + 1 rows of 2 hb words."""
    return ((1 << bits) - 1) * (8 << (bits // 2))


def fold(subs, bits):
    """nibble_fold: word i of the folded table (int32 values as int64),
    computed word by word as the kernel's loop does."""
    h = bits // 2
    hb, qmax = 1 << h, (1 << (bits - 1)) - 1
    sz = hb * hb
    s = subs.to(torch.int64)
    i = torch.arange(table_bytes(bits) // 4)
    v = (i >> (h + 1)) - qmax
    c = i & (2 * hb - 1)
    am, col = v.abs(), c & (hb - 1)
    high = torch.where(c < hb, 0, sz) + (am >> h) * hb + col
    low = torch.where(c < hb, 2 * sz, 3 * sz) + (am & (hb - 1)) * hb + col
    return _wrap32(torch.sign(v) * (s[high] + s[low]))


def x_word(a, bits):
    """cl_stage_x: the byte offset of a's signed row."""
    return (a + (1 << (bits - 1)) - 1) << (bits // 2 + 3)


def w_regs(b, bits):
    """The weight's three registers: the byte offsets of columns bh and
    hb + bl, and sign(b)."""
    h = bits // 2
    mag = b.abs()
    return (mag >> h) * 4, ((1 << h) + (mag & ((1 << h) - 1))) * 4, \
        torch.sign(b)


def product(xw, regs, table):
    """sign(b) (row[bh] + row[bl]) in 32 bits, the two gathers at byte
    offsets xw + b0 and xw + b1 of the table."""
    b0, b1, sb = regs
    for off in (xw + b0, xw + b1):
        assert bool((off % 4 == 0).all())
        assert int(off.max()) < table.numel() * 4 and int(off.min()) >= 0
    return _wrap32(sb * (table[(xw + b0) // 4] + table[(xw + b1) // 4]))


def _all_values(bits):
    qmax = (1 << (bits - 1)) - 1
    return torch.arange(-qmax, qmax + 1, dtype=torch.int64)


@pytest.mark.parametrize("kind", ["exact", "appro42", "random"])
@pytest.mark.parametrize("bits", BITS)
def test_folded_products_equal_the_four_sub_tables_on_every_pair(bits,
                                                                 kind):
    """Every (a, b) in [-qmax, qmax]^2 (a quantized operand never leaves
    it): the folded table's product equals ref.nibble_sum and the
    reference's _gather_nibble bit for bit; a zero operand gives 0 though
    the random tables' row and column 0 are not 0."""
    subs = _subs(kind, bits)
    table = fold(subs, bits)
    assert table.numel() * 4 == table_bytes(bits)
    v = _all_values(bits)
    a, b = v[:, None], v[None, :]                      # (M, 1), (1, N)
    got = product(x_word(a, bits), w_regs(b, bits), table)
    want = tref.nibble_sum(subs, a.to(torch.int32), b.to(torch.int32), bits)
    assert torch.equal(got, want.to(torch.int64))
    h = bits // 2
    am, bm = jnp.asarray(a.abs().numpy(), jnp.int32), jnp.asarray(
        b.abs().numpy(), jnp.int32)
    ref = _gather_nibble(jnp.asarray(subs.numpy()), am, bm,
                         jnp.sign(jnp.asarray(a.numpy(), jnp.int32)),
                         jnp.sign(jnp.asarray(b.numpy(), jnp.int32)), h, 1)
    assert np.array_equal(got.numpy(), np.asarray(ref).astype(np.int64))
    zero = (a == 0) | (b == 0)
    assert not bool(got[zero].any())
    if kind == "random":
        assert int(subs.min()) > 0 and bool((got != 0).sum() > 0)


@pytest.mark.parametrize("bits", BITS)
def test_a_warps_gathers_lie_in_one_bank_line(bits):
    """A warp's 32 lanes are 32 columns at one row and one k: a is
    uniform, so both of its gathers read words of a's row, which lies in
    one 32-word bank line (2 hb words, 2 hb dividing 32, the row starting
    at a multiple of 2 hb): distinct words, distinct banks, one
    wavefront a gather."""
    hb = 1 << (bits // 2)
    assert LINE_WORDS % (2 * hb) == 0
    v = _all_values(bits)
    b0, b1, _ = w_regs(v, bits)
    for a in v:
        xw = x_word(a, bits)
        words = torch.cat([(xw + b0) // 4, (xw + b1) // 4])
        assert int(xw) % (8 * hb) == 0
        assert torch.unique(words // LINE_WORDS).numel() == 1
        assert torch.unique(words // (2 * hb)).numel() == 1


def _products(x, w, subs, sx, sw, bits):
    """The kernel's products on the CPU: x and w quantized on load, staged,
    and multiplied through the folded table: (M, K, N), each in 32 bits."""
    qmax = (1 << (bits - 1)) - 1
    a = tref.quantize_tile(x.float(), sx.reshape(()).float(), qmax).long()
    b = tref.quantize_tile(w.float(), sw.reshape(1, -1).float(), qmax).long()
    regs = tuple(r[None] for r in w_regs(b, bits))
    return product(x_word(a, bits)[:, :, None], regs, fold(subs, bits))


def _rank_order_sum(prods, k_split):
    """The kernel's partial form: each K slice of `k_split` (one block of
    the cluster) summed in 32 bits, the slices added in rank order (the
    flush through distributed shared memory), written as int32."""
    total = torch.zeros(prods.shape[0], prods.shape[2], dtype=torch.int64)
    for k0 in range(0, prods.shape[1], k_split):
        total = (total + prods[:, k0:k0 + k_split].sum(1)) % (1 << 32)
    return _wrap32(total).to(torch.int32)


H100_GPCS = (18,) * 6 + (12,) * 2      # 132 SMs


def _gpcs(sizes, per_sm):
    """Clusters of s blocks that GPCs of `sizes` SMs hold, per_sm blocks
    an SM (tests/test_torch_cluster_gemm.py's capacity model)."""
    return lambda rows, s: sum(g * per_sm // s for g in sizes)


def _plan(m, k, n):
    """The nibble kernel's plan on an H100-like card: its row tiles, two
    blocks an SM."""
    return approx_matmul.cluster_plan(m, k, n, _gpcs(H100_GPCS, 2),
                                      approx_matmul.NIBBLE_ROWS)


@pytest.mark.parametrize("kind", ["exact", "random"])
def test_rank_order_partial_sum_equals_the_plain_partial(kind):
    """At the plan's 8 slices of a long K (250,000 for the exact table,
    6,000 for the random tables at the int32 limit) with operands of
    110..127, one k in 64 of the weight negated, every sum passes 2^31 and
    wraps; the kernel's split-K sum of the folded products equals
    nibble_lut_matmul_partial_plain bit for bit, and its epilogue the
    fused plain version."""
    m, n, bits = 2, 3, 8
    k = 250_000 if kind == "exact" else 6_000
    rng = np.random.default_rng(7)
    qa = torch.from_numpy(rng.integers(110, 128, (m, k)))
    qb = torch.from_numpy(rng.integers(110, 128, (k, n)))
    qb[::64] *= -1                              # some negative products
    sx, sw = torch.tensor(0.5), torch.full((n,), 0.25)
    x, w = qa.float() * sx, qb.float() * sw      # quantize back to qa, qb
    subs = _subs(kind, bits)
    plan = _plan(m, k, n)
    assert plan.splits == approx_matmul.CLUSTER_MAX_SPLITS
    prods = _products(x, w, subs, sx, sw, bits)
    assert int(prods.sum(1).min()) >= 1 << 31      # every sum wraps
    want = approx_matmul.nibble_lut_matmul_partial_plain(x, w, subs, sx, sw)
    got = _rank_order_sum(prods, plan.k_split)
    assert want.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(approx_matmul.epilogue(got, sx, sw),
                       approx_matmul.nibble_lut_matmul_fused_plain(
                           x, w, subs, sx, sw))


@pytest.mark.parametrize("bits", BITS)
def test_kernel_model_equals_the_jax_fused_kernel(bits):
    """The whole fused form as the kernel computes it (quantize on load,
    the folded products, the plan's slices summed in rank order, (acc *
    sx) * sw) against the JAX package's nibble_lut_matmul_fused in
    interpret mode, bitwise, on the exact family's sub-tables."""
    m, k, n = 5, 200, 9
    qmax = (1 << (bits - 1)) - 1
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    sx = np.float32(np.abs(x).max() / np.float32(qmax))
    sw = (np.abs(w).max(axis=0) / np.float32(qmax)).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    tsx, tsw = torch.tensor(sx), torch.from_numpy(sw)
    subs = _subs("exact", bits)
    plan = _plan(m, k, n)
    acc = _rank_order_sum(_products(tx, tw, subs, tsx, tsw, bits),
                          plan.k_split)
    got = approx_matmul.epilogue(acc, tsx, tsw)
    want = np.asarray(j_fused(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(subs.numpy()), jnp.asarray(sx),
                              jnp.asarray(sw), bits=bits, interpret=True))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, approx_matmul.nibble_lut_matmul_fused_plain(
        tx, tw, subs, tsx, tsw, bits))


# --- the int form: int8 operands, saturated in the staging -----------------

def x_word_int(a, bits):
    """cl_stage_x on an int8 operand (IntOut): the row of sign(a) min(|a|,
    qmax)."""
    qmax = (1 << (bits - 1)) - 1
    return x_word(torch.clamp(a, -qmax, qmax), bits)


def w_regs_int(b, bits):
    """The weight's registers from an int8 operand: the columns of
    min(|b|, qmax), and sign(b)."""
    qmax = (1 << (bits - 1)) - 1
    bh, bl, _ = w_regs(torch.clamp(b.abs(), max=qmax), bits)
    return bh, bl, torch.sign(b)


def _int8_values():
    return torch.arange(-128, 128, dtype=torch.int64)


@pytest.mark.parametrize("kind", ["exact", "appro42", "random"])
@pytest.mark.parametrize("bits", BITS)
def test_int8_staging_saturates_on_every_int8_pair(bits, kind):
    """Every int8 pair, -128 and (below 8 bits) the magnitudes past qmax
    included: the saturated staged product equals ref.nibble_sum (the
    plain int form) and the reference's _gather_nibble on min(|a|, qmax),
    min(|b|, qmax), with every gather inside the folded table; a zero
    operand gives 0.  Unsaturated, -128 at 8 bits would stage row -1, a
    read before the table, and 128 the columns (8, 0)."""
    subs = _subs(kind, bits)
    table = fold(subs, bits)
    v = _int8_values()
    a, b = v[:, None], v[None, :]
    got = product(x_word_int(a, bits), w_regs_int(b, bits), table)
    want = tref.nibble_sum(subs, a.to(torch.int32), b.to(torch.int32), bits)
    assert torch.equal(got, want.to(torch.int64))
    qmax = (1 << (bits - 1)) - 1
    am = jnp.asarray(torch.clamp(a.abs(), max=qmax).numpy(), jnp.int32)
    bm = jnp.asarray(torch.clamp(b.abs(), max=qmax).numpy(), jnp.int32)
    ref = _gather_nibble(jnp.asarray(subs.numpy()), am, bm,
                         jnp.sign(jnp.asarray(a.numpy(), jnp.int32)),
                         jnp.sign(jnp.asarray(b.numpy(), jnp.int32)),
                         bits // 2, 1)
    assert np.array_equal(got.numpy(), np.asarray(ref).astype(np.int64))
    zero = (a == 0) | (b == 0)
    assert not bool(got[zero].any())
    if bits == 8:
        assert int(x_word(torch.tensor(-128), bits)) < 0
        bh, bl, _ = w_regs(torch.tensor(128), bits)
        assert (int(bh), int(bl)) == (8 * 4, 16 * 4)


def _int_products(qa, qb, subs, bits):
    """The int form's products on the CPU: (M, K, N), each in 32 bits."""
    regs = tuple(r[None] for r in w_regs_int(qb, bits))
    return product(x_word_int(qa, bits)[:, :, None], regs, fold(subs, bits))


@pytest.mark.parametrize("kind", ["exact", "random"])
def test_rank_order_int_sum_equals_the_plain_int_form(kind):
    """At the plan's 8 slices of a long K (250,000 for the exact table,
    6,000 for the random tables at the int32 limit), int8 operands of
    magnitude 110..127, -128 in x's first column, one k in 64 of the
    weight negated: every sum passes 2^31 and wraps; the kernel's split-K
    sum of the saturated products, written as int32, equals the plain int
    form bit for bit."""
    m, n, bits = 2, 3, 8
    k = 250_000 if kind == "exact" else 6_000
    rng = np.random.default_rng(17)
    qa = torch.from_numpy(rng.integers(110, 128, (m, k)))
    qb = torch.from_numpy(rng.integers(110, 128, (k, n)))
    qb[::64] *= -1
    qa[:, 0] = -128
    subs = _subs(kind, bits)
    plan = _plan(m, k, n)
    assert plan.splits == approx_matmul.CLUSTER_MAX_SPLITS
    prods = _int_products(qa, qb, subs, bits)
    assert int(prods.sum(1).abs().min()) >= 1 << 31    # every sum wraps
    want = approx_matmul.nibble_lut_matmul(qa.to(torch.int8),
                                           qb.to(torch.int8), subs)
    got = _rank_order_sum(prods, plan.k_split)
    assert want.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("kind", ["exact", "appro42"])
@pytest.mark.parametrize("bits", BITS)
def test_int_kernel_model_equals_the_jax_int_kernel(bits, kind):
    """The whole int form as the kernel computes it (the saturated staged
    products, the plan's slices summed in rank order) against the JAX
    package's nibble_lut_matmul in interpret mode, bitwise, on int8
    operands over the whole int8 range (-128 in x's first row; below 8
    bits most magnitudes lie past qmax)."""
    m, k, n = 5, 200, 9
    rng = np.random.default_rng(bits + 40)
    xq = rng.integers(-128, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-128, 128, (k, n)).astype(np.int8)
    xq[0, :3] = -128
    subs = _subs(kind, bits)
    plan = _plan(m, k, n)
    got = _rank_order_sum(_int_products(
        torch.from_numpy(xq).long(), torch.from_numpy(wq).long(), subs, bits),
        plan.k_split)
    want = np.asarray(j_int(jnp.asarray(xq), jnp.asarray(wq),
                            jnp.asarray(subs.numpy()), bits=bits,
                            interpret=True))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, approx_matmul.nibble_lut_matmul(
        torch.from_numpy(xq), torch.from_numpy(wq), subs, bits))


# --- the launch plan and the wrappers' card side ----------------------------

# chip_smoke.py's LM shapes (M = 4 and 64 times qwen3-1.7b's four weight
# shapes) and the mesh path's shard shapes (PARTIAL_SHAPES)
LM_SHAPES = [(m, k, n) for m in (4, 64)
             for (k, n) in ((2048, 2048), (2048, 1024), (2048, 6144),
                            (6144, 2048))]
SHARD_SHAPES = [(m, k, 2048) for m in (4, 64) for k in (1024, 3072)]


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("shape", LM_SHAPES + SHARD_SHAPES + [(256, 64, 10)],
                         ids=str)
def test_cluster_plan_at_the_lm_and_shard_shapes(shape, per_sm):
    """The nibble kernel's row tiles (NIBBLE_ROWS: a decode round in one
    tile of 4 rows, a prefill's 64 rows and the CNN fc's 256 in tiles of
    16), a split the device holds, K covered with no slice empty, and
    more than one slice where the tiles leave most of the card idle."""
    m, k, n = shape
    cap = _gpcs(H100_GPCS, per_sm)
    p = approx_matmul.cluster_plan(m, k, n, cap, approx_matmul.NIBBLE_ROWS)
    assert p.rows == min(m, 16)
    assert p.tiles == -(-m // p.rows) * -(-n // 64)
    assert cap(p.rows, p.splits) > 0
    assert p.k_split % approx_matmul.CLUSTER_BK == 0
    assert (p.splits - 1) * p.k_split < k <= p.splits * p.k_split
    assert p.tiles >= 96 or p.splits > 1 or k <= 64


# chip_smoke.py's SERVED_SHAPES: the per-token and faulted lanes' calls, M =
# 1, 2 (a decode round of one or two slots), 8, 16 (prompts over two
# slots) and 20 (the k = 4 verify), times the four LM (K, N)
SERVED_SHAPES = [(m, k, n) for m in (1, 2, 8, 16, 20)
                 for (k, n) in ((2048, 2048), (2048, 1024), (2048, 6144),
                                (6144, 2048))]


@pytest.mark.parametrize("shape", SERVED_SHAPES, ids=str)
def test_int_plan_at_the_served_shapes(shape):
    """The int form's plan over NIBBLE_ROWS (its entry's tiles in
    ROW_TILES) at two blocks an SM: the fewest row tiles that hold M, a
    split the device holds, K covered with no slice empty, a decode
    round's 32 tiles split to fill the card."""
    m, k, n = shape
    kern = approx_matmul.KERNELS["nibble_lut_matmul"]
    assert approx_matmul.ROW_TILES[kern.symbol] == approx_matmul.NIBBLE_ROWS
    cap = _gpcs(H100_GPCS, 2)
    p = _plan(m, k, n)
    assert p.rows == (4 if m <= 4 else 16)
    assert p.tiles == -(-m // p.rows) * (n // 64)
    assert cap(p.rows, p.splits) > 0
    assert p.k_split % approx_matmul.CLUSTER_BK == 0
    assert (p.splits - 1) * p.k_split < k <= p.splits * p.k_split
    if m <= 4 and n == 2048:
        assert p.splits > 1


class _Recorder:
    """A CudaKernel stand-in on the CPU: records each call (checked
    against the C entry's signature); `refuse` raises as a launch the
    device refuses does."""

    def __init__(self, kern, refuse=False):
        self.library, self.symbol = kern.library, kern.symbol
        self.argtypes, self.refuse, self.calls = kern.argtypes, refuse, []

    def __call__(self, *args):
        assert len(args) == len(self.argtypes), self.symbol
        if self.refuse:
            raise RuntimeError(f"{self.symbol}: CUDA error 1 at launch")
        self.calls.append(args)


def _card_side(monkeypatch, refuse=False):
    """approx_matmul's card side on CPU tensors: on_cuda says yes, the
    three nibble cluster entries (int, fused, partial) record, the plan
    reads an H100-like capacity from the launched kernel's own query."""
    monkeypatch.setattr(approx_matmul, "on_cuda", lambda *t: True)
    monkeypatch.setattr(approx_matmul, "stream_of", lambda t: 0)
    asked = set()

    def capacity(library, symbol, device, args, rows, splits):
        asked.add((library, symbol, args, rows))
        return _gpcs(H100_GPCS, 2)(rows, splits)

    monkeypatch.setattr(approx_matmul, "_capacity", capacity)
    rec = {}
    for name in ("_NIB_INT", "_NIB_FUSED", "_NIB_PARTIAL"):
        rec[name] = _Recorder(getattr(approx_matmul, name), refuse)
        monkeypatch.setattr(approx_matmul, name, rec[name])
    return rec, asked


@pytest.mark.parametrize("m", [4, 64])
@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("bits", BITS)
def test_nibble_wrappers_launch_the_cluster_kernel(monkeypatch, bits,
                                                   partial, m):
    """On a (faked) card the fused and partial wrappers launch the cluster
    entry (f32 out, or the raw int32 sum) with the plan from that entry's
    own capacity query over its row tiles (16 rows at M = 64), and never
    the int entry; a refused launch raises: nothing falls back."""
    k, n = 1024, 2048
    rng = np.random.default_rng(bits)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32)) * 0.02
    sx, sw = torch.ones(1), torch.ones(n)
    subs = _subs("exact", bits)
    rec, asked = _card_side(monkeypatch)
    call = (approx_matmul.nibble_lut_matmul_partial if partial
            else approx_matmul.nibble_lut_matmul_fused)
    out = call(x, w, subs, sx, sw, bits)
    used = "_NIB_PARTIAL" if partial else "_NIB_FUSED"
    assert out.dtype == (torch.int32 if partial else torch.float32)
    assert out.shape == (m, n)
    (args,) = rec[used].calls
    assert not any(r.calls for name, r in rec.items() if name != used)
    symbol = "nibble_gemm_partial" if partial else "nibble_gemm_fused"
    assert rec[used].symbol == symbol
    plan = _plan(m, k, n)
    assert plan.rows == min(m, 16)
    assert {a[:3] for a in asked} == {
        ("nibble_gemm", symbol + "_capacity", (bits, 1, 0))}
    assert {a[3] for a in asked} == {plan.rows}
    assert args[:4] == (x.data_ptr(), 1, w.data_ptr(), 0)
    assert args[4:12] == (subs.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                          out.data_ptr(), m, k, n, bits)
    assert args[12:15] == (plan.rows, plan.splits, plan.k_split)
    rec, _ = _card_side(monkeypatch, refuse=True)
    with pytest.raises(RuntimeError, match=symbol):
        call(x, w, subs, sx, sw, bits)


def test_nibble_wrappers_refuse_odd_widths_on_the_card(monkeypatch):
    """The nibble kernels take even widths of 2..8 bits only, the int form
    too."""
    rec, _ = _card_side(monkeypatch)
    x, w = torch.ones(4, 64), torch.ones(64, 64)
    xq, wq = torch.ones(4, 64, dtype=torch.int8), torch.ones(
        64, 64, dtype=torch.int8)
    for bits in (3, 7):
        subs = torch.zeros(4 << bits, dtype=torch.int32)
        with pytest.raises(ValueError, match="even width"):
            approx_matmul.nibble_lut_matmul_fused(x, w, subs, torch.ones(1),
                                                  torch.ones(64), bits)
        with pytest.raises(ValueError, match="even width"):
            approx_matmul.nibble_lut_matmul(xq, wq, subs, bits)
    assert not any(r.calls for r in rec.values())


@pytest.mark.parametrize("m", [1, 4, 20, 64])
@pytest.mark.parametrize("bits", BITS)
def test_nibble_int_form_launches_the_cluster_kernel(monkeypatch, bits, m):
    """On a (faked) card nibble_lut_matmul launches its cluster entry
    (nibble_gemm_int8_cluster: int8 operands, an int32 output, no scale)
    with the plan from that entry's own capacity query, whose arguments
    after the rows are (bits,) alone, over NIBBLE_ROWS; no other entry;
    operands past qmax go to the kernel, which saturates them (no range
    check refuses them); a refused launch raises: nothing falls back."""
    k, n = 1024, 2048
    rng = np.random.default_rng(bits + m)
    xq = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    xq[0, 0] = -128
    subs = _subs("exact", bits)
    rec, asked = _card_side(monkeypatch)
    out = approx_matmul.nibble_lut_matmul(xq, wq, subs, bits)
    assert out.dtype == torch.int32 and out.shape == (m, n)
    (args,) = rec["_NIB_INT"].calls
    assert not any(r.calls for name, r in rec.items() if name != "_NIB_INT")
    symbol = "nibble_gemm_int8_cluster"
    assert rec["_NIB_INT"].symbol == symbol
    plan = _plan(m, k, n)
    assert asked == {("nibble_gemm", symbol + "_capacity", (bits,),
                      plan.rows)}
    assert args == (xq.data_ptr(), wq.data_ptr(), subs.data_ptr(),
                    out.data_ptr(), m, k, n, bits, plan.rows, plan.splits,
                    plan.k_split, 0)
    with pytest.raises(ValueError, match="sub-tables"):
        approx_matmul.nibble_lut_matmul(xq, wq, subs[:-1].clone(), bits)
    with pytest.raises(ValueError, match="int8"):
        approx_matmul.nibble_lut_matmul(xq.int(), wq, subs, bits)
    _card_side(monkeypatch, refuse=True)
    with pytest.raises(RuntimeError, match=symbol):
        approx_matmul.nibble_lut_matmul(xq, wq, subs, bits)


def test_the_template_nibble_gemm_is_gone():
    """Every nibble entry is a cluster entry with its own capacity query:
    nibble_gemm.cu instantiates no tiled template GEMM (dense_int8) and
    exports no nibble_gemm_int8; cim_gemm.cuh keeps NibbleCore for the
    attention and conv tile kernels, which stage through it."""
    import pathlib

    csrc = pathlib.Path(approx_matmul.__file__).parent / "csrc"
    nib = [kern for name, kern in approx_matmul.KERNELS.items()
           if name.startswith("nibble")]
    assert sorted(k.symbol for k in nib) == [
        "nibble_gemm_fused", "nibble_gemm_int8_cluster",
        "nibble_gemm_partial"]
    src = (csrc / "nibble_gemm.cu").read_text()
    assert "dense_int8" not in src and "nibble_gemm_int8(" not in src
    for k in nib:
        assert f"int {k.symbol}(" in src
        assert f"int {k.symbol}_capacity(" in src
    assert "struct NibbleCore" in (csrc / "cim_gemm.cuh").read_text()
    for user in ("attn_cluster.cuh", "conv_tile.cuh"):
        assert "NibbleCore::stage_" in (csrc / user).read_text()
