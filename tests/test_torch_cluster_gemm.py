"""The split-K cluster GEMMs on the CPU.  csrc/cluster_gemm.cuh: a plain
torch model of its staged operands and product forms held against the
reference's ``_log_product`` (src/repro/kernels/mitchell_gemm.py), the
product rewrites it rests on at 8, 12 and 16 bits, the LUT's byte
offsets, its launch plan (``approx_matmul.cluster_plan``), the gate
between it and the tiled template (``mitchell_gemm.fused_route``), and
its partial forms (the mesh path's ``lut_matmul_partial`` and
``mitchell_matmul_partial``: the epilogue off, the rank-order uint32 sum
written as int32): their route and launch arguments, and a plain model
of their sum against the plain versions.
csrc/surrogate_cluster.cuh (``cim_gemm_fused``): the split of each square
into two s8 halves, a plain torch model of its split-K SQ held against
``ref.square_dot``, SQ's K limit, its variants and its plan.  The kernels
themselves run only on the card (tests/test_torch_gpu.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mitchell_gemm import _log_product
from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.kernels import approx_matmul, cim_gemm, mitchell_gemm, ops
from repro_torch.kernels import ref as tref


def _reference(a, b, bits, compensated):
    """_log_product of the JAX package on int32 vectors, as int64."""
    p = _log_product(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), bits,
                     compensated)
    return torch.from_numpy(np.asarray(p).astype(np.int64))


def _parts(v, bits):
    """(sign, mag, k, q) of int64 operands, k = the reference's capped
    leading-one position (0 for 0), q = mag - 2^k (0 for 0)."""
    s = torch.sign(v)
    mag = v.abs()
    k = tref.leading_one(mag, bits)
    q = torch.where(mag == 0, torch.zeros_like(mag), mag - (1 << k))
    return s, mag, k, q


def _comp_shift(q, bits):
    """c(q) = LoD(q) + round_up(q), 0 for q = 0."""
    m = tref.leading_one(q, bits)
    up = ((q << 1) >= 3 * (1 << m)).to(q.dtype)
    return torch.where(q == 0, torch.zeros_like(q), m + up)


# --- the staged forms, byte for byte as the kernel packs them -------------

def _byte(v):
    return v & 0xFF


def _signed_byte(word, i):
    b = (word >> (8 * i)) & 0xFF
    return (b ^ 0x80) - 0x80


def _x_bytes(v, bits):
    """log_x_bytes: (s mag, s 2^k) as two signed bytes, the first low."""
    s, mag, k, _ = _parts(v, bits)
    return _byte(s * mag) | (_byte(s * (1 << k)) << 8)


def _w_bytes(v, bits):
    """log_w_bytes: (s 2^k, s q)."""
    s, _, k, q = _parts(v, bits)
    return _byte(s * (1 << k)) | (_byte(s * q) << 8)


def _comp_word(v, bits):
    """comp_word: c(q) in byte 3, q in byte 2."""
    q = _parts(v, bits)[3]
    return (_comp_shift(q, bits) << 24) | (q << 16)


def _dp4a(a, b, acc):
    """__dp4a: acc + the dot product of the four signed bytes."""
    return acc + sum(_signed_byte(a, i) * _signed_byte(b, i)
                     for i in range(4))


def _wrap32(v):
    return ((v + (1 << 31)) % (1 << 32)) - (1 << 31)


def _mitchell_pair(a0, a1, b0, b1, bits):
    """One dp4a over a staged pair of k: the kernel's mitchell form."""
    aw = _x_bytes(a0, bits) | (_x_bytes(a1, bits) << 16)
    bw = _w_bytes(b0, bits) | (_w_bytes(b1, bits) << 16)
    return _dp4a(aw, bw, torch.zeros_like(a0))


def _log_our_word(a, b, bits):
    """The kernel's log_our form for one k: a dp4a on (A, B's dot word),
    then q_small << c_big from the unsigned min and max of A and B's
    compare word, signed by the two sign masks."""
    aw = _x_bytes(a, bits) | _comp_word(a, bits)
    bd, bc = _w_bytes(b, bits), _comp_word(b, bits)
    acc = _dp4a(aw, bd, torch.zeros_like(a))
    mx, mn = torch.maximum(aw, bc), torch.minimum(aw, bc)
    comp = ((mn >> 16) & 0xFF) << (mx >> 24)
    ma = torch.where(_signed_byte(aw, 0) < 0, -1, 0)
    mb = torch.where(b < 0, -1, 0)
    sg = torch.where((ma ^ mb) != 0, -1, 1)
    return _wrap32(acc + comp * sg)


def _all_pairs(lo, hi):
    v = torch.arange(lo, hi + 1, dtype=torch.int64)
    return v.repeat_interleave(v.numel()), v.repeat(v.numel())


def test_mitchell_byte_pairs_equal_the_reference_on_every_staged_pair():
    a, b = _all_pairs(-127, 127)       # the fused path clips to +-qmax
    want = _reference(a, b, 8, False)
    zero = torch.zeros_like(a)
    assert torch.equal(_mitchell_pair(a, zero, b, zero, 8), want)
    assert torch.equal(_mitchell_pair(zero, a, zero, b, 8), want)
    # two k a word: the dot product sums both
    perm = torch.randperm(a.numel(), generator=torch.Generator().manual_seed(0))
    got = _mitchell_pair(a, a[perm], b, b[perm], 8)
    assert torch.equal(got, want + want[perm])


def test_log_our_word_equals_the_reference_on_every_staged_pair():
    a, b = _all_pairs(-127, 127)
    assert torch.equal(_log_our_word(a, b, 8), _reference(a, b, 8, True))


@pytest.mark.parametrize("bits", [2, 3, 5, 7])
def test_staged_forms_hold_below_8_bits(bits):
    qmax = (1 << (bits - 1)) - 1
    a, b = _all_pairs(-qmax, qmax)
    zero = torch.zeros_like(a)
    assert torch.equal(_mitchell_pair(a, zero, b, zero, bits),
                       _reference(a, b, bits, False))
    assert torch.equal(_log_our_word(a, b, bits),
                       _reference(a, b, bits, True))


def _rewrites(a, b, bits, compensated):
    """The product rewrites, unpacked: mag1 2^k2 + q2 2^k1 for mitchell,
    plus min(q1, q2) << max(c1, c2) for log_our, signed."""
    s1, mag1, k1, q1 = _parts(a, bits)
    s2, mag2, k2, q2 = _parts(b, bits)
    p = (mag1 << k2) + (q2 << k1)
    if compensated:
        c = torch.maximum(_comp_shift(q1, bits), _comp_shift(q2, bits))
        p = p + (torch.minimum(q1, q2) << c)
    p = torch.where((mag1 == 0) | (mag2 == 0), torch.zeros_like(p), p)
    return _wrap32(s1 * s2 * p)


@pytest.mark.parametrize("compensated", [False, True])
def test_rewrites_hold_on_all_65536_8bit_pairs(compensated):
    a, b = _all_pairs(-128, 127)
    assert torch.equal(_rewrites(a, b, 8, compensated),
                       _reference(a, b, 8, compensated))


@pytest.mark.parametrize("bits", [12, 16])
@pytest.mark.parametrize("compensated", [False, True])
def test_rewrites_hold_on_a_sample_of_wide_pairs(bits, compensated):
    qmax = (1 << (bits - 1)) - 1
    rng = np.random.default_rng(bits * 2 + compensated)
    v = rng.integers(-qmax, qmax + 1, size=(2, 200_000))
    v[:, :64] = rng.choice([0, 1, -1, qmax, -qmax], size=(2, 64))
    a, b = torch.from_numpy(v[0]), torch.from_numpy(v[1])
    assert torch.equal(_rewrites(a, b, bits, compensated),
                       _reference(a, b, bits, compensated))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_lut_byte_offsets_address_the_gathered_entry(bits):
    h = 1 << (bits - 1)
    a, b = _all_pairs(-(h - 1), h - 1)
    row = ((a + h) << bits) * 2             # the staged x word
    colb = (b + h) * 2                      # the staged w register
    assert torch.equal((row + colb) // 2, (a + h) * (1 << bits) + (b + h))
    assert int((row + colb).max()) < (1 << (2 * bits)) * 2


SHAPES = [(1, 0, 5), (1, 1, 1), (4, 2048, 2048), (4, 2048, 6144),
          (4, 6144, 2048), (17, 33, 17), (64, 2048, 1024), (65, 6144, 7),
          (256, 64, 10), (2048, 768, 3072), (5, 31, 8), (130, 32, 2048),
          (3, 257, 1), (4, 10_000, 129)]


def _gpcs(sizes, per_sm):
    """A capacity model: clusters of s blocks a GPC of g SMs holds,
    per_sm blocks an SM, summed over the GPCs."""
    return lambda rows, s: sum(g * per_sm // s for g in sizes)


H100_GPCS = (18,) * 6 + (12,) * 2      # 132 SMs


@pytest.mark.parametrize("capacity", [
    _gpcs(H100_GPCS, 1), _gpcs(H100_GPCS, 2), _gpcs((1,), 1),
    lambda rows, s: 78 // s], ids=["lut", "log", "one_sm", "flat78"])
def test_cluster_plan_invariants(capacity):
    for m, k, n in SHAPES:
        p = approx_matmul.cluster_plan(m, k, n, capacity)
        assert p.rows in approx_matmul.CLUSTER_ROWS
        assert p.rows >= min(m, 64)
        assert p.tiles == -(-m // p.rows) * -(-n // 64)
        assert 1 <= p.splits <= approx_matmul.CLUSTER_MAX_SPLITS
        assert capacity(p.rows, p.splits) > 0 or k == 0
        assert p.k_split > 0 and p.k_split % approx_matmul.CLUSTER_BK == 0
        assert p.splits * p.k_split >= k                 # covers K
        if k > 0:
            assert (p.splits - 1) * p.k_split < k        # no empty slice
        else:
            assert p.splits == 1


def test_cluster_plan_counts_waves_by_the_clusters_a_gpc_holds():
    # 32 tiles at M = 4: four slices need 32 clusters of 4, one more than
    # six GPCs of 18 and two of 12 SMs hold (30): two waves; three slices
    # fit in one
    lut = _gpcs(H100_GPCS, 1)
    assert lut(4, 4) == 30 and lut(4, 3) == 44
    assert approx_matmul.cluster_plan(4, 2048, 2048, lut).splits == 3
    # the log kernel holds two blocks an SM: 32 clusters of 7 fit
    log = _gpcs(H100_GPCS, 2)
    assert approx_matmul.cluster_plan(4, 2048, 2048, log).splits == 7
    assert approx_matmul.cluster_plan(4, 2048, 1024, log).splits == 8
    # 96 tiles fill the LUT kernel's card at once: no split
    assert approx_matmul.cluster_plan(4, 2048, 6144, lut).splits == 1
    # a cluster size the device cannot hold is never chosen
    assert approx_matmul.cluster_plan(
        4, 2048, 1024, lambda r, s: 0 if s > 2 else 50).splits == 2
    with pytest.raises(ValueError, match="no cluster"):
        approx_matmul.cluster_plan(4, 64, 64, lambda r, s: 0)


def test_fused_route_is_the_bits_gate():
    for bits in range(2, 9):
        assert mitchell_gemm.fused_route(bits) == "cluster"
    for bits in range(9, 17):
        assert mitchell_gemm.fused_route(bits) == "tiled"
    for bits in (1, 17):
        with pytest.raises(ValueError, match="2..16-bit"):
            mitchell_gemm.fused_route(bits)


# --- the partial forms (the mesh path's shard-local GEMMs) ------------------

# the contraction-sharded wo and mlp.wo of qwen3-1.7b at model = 2, at a
# decode round (M = 4) and a prefill (M = 64): chip_smoke.py PARTIAL_SHAPES
SHARD_SHAPES = [(4, 1024, 2048), (4, 3072, 2048), (64, 1024, 2048),
                (64, 3072, 2048)]


@pytest.mark.parametrize("shape", SHARD_SHAPES, ids=str)
def test_cluster_plan_at_the_shard_shapes(shape):
    """Under the LUT kernel's and the log kernel's H100 capacities: one
    row tile, a split the device holds, K covered with no slice empty,
    and at M = 4 more than one slice (32 tiles leave most of the card
    idle unsplit)."""
    m, k, n = shape
    for per_sm in (1, 2):
        cap = _gpcs(H100_GPCS, per_sm)
        p = approx_matmul.cluster_plan(m, k, n, cap)
        assert p.rows == m and p.tiles == n // 64
        assert cap(p.rows, p.splits) > 0
        assert p.k_split % approx_matmul.CLUSTER_BK == 0
        assert (p.splits - 1) * p.k_split < k <= p.splits * p.k_split
        assert m != 4 or p.splits > 1


class _Recorder:
    """Stands in for a CudaKernel on the CPU: records each call's
    arguments, checked against the C entry's signature; `refuse` makes
    it raise as a launch the device refuses does."""

    def __init__(self, kern, refuse=False):
        self.library, self.symbol = kern.library, kern.symbol
        self.argtypes, self.refuse, self.calls = kern.argtypes, refuse, []

    def __call__(self, *args):
        assert len(args) == len(self.argtypes), self.symbol
        if self.refuse:
            raise RuntimeError(f"{self.symbol}: CUDA error 1 at launch")
        self.calls.append(args)


def _card_side(monkeypatch, module, names, refuse=False):
    """Run `module`'s wrappers' card side on CPU tensors: on_cuda says
    yes, the kernels `names` (module attributes) record instead of
    launching, and the plan reads an H100-like capacity (asked of the
    kernel's own query).  Returns the recorders and the queries asked."""
    monkeypatch.setattr(module, "on_cuda", lambda *t: True)
    monkeypatch.setattr(approx_matmul, "stream_of", lambda t: 0)
    monkeypatch.setattr(mitchell_gemm, "stream_of", lambda t: 0)
    asked = set()

    def capacity(library, symbol, device, args, rows, splits):
        asked.add(symbol)
        return _gpcs(H100_GPCS, 1)(rows, splits)

    monkeypatch.setattr(approx_matmul, "_capacity", capacity)
    rec = {}
    for name in names:
        rec[name] = _Recorder(getattr(module, name), refuse)
        monkeypatch.setattr(module, name, rec[name])
    return rec, asked


def _shard_operands(m=4, k=1024, n=2048):
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32) * 0.02)
    return (x.to(torch.bfloat16), w.to(torch.bfloat16),
            torch.ones(1), torch.ones(n))


@pytest.mark.parametrize("bits", [4, 8])
def test_lut_partial_launches_the_cluster_kernel(monkeypatch, bits):
    """The card side of lut_matmul_partial: the cluster kernel's partial
    entry with the plan from its own capacity query, an int32 output; a
    refused launch raises (no fallback to the template or the plain
    version)."""
    x, w, sx, sw = _shard_operands()
    lut = torch.zeros(1 << (2 * bits), dtype=torch.int16)
    rec, asked = _card_side(monkeypatch, approx_matmul,
                            ["_PARTIAL", "_FUSED"])
    out = approx_matmul.lut_matmul_partial(x, w, lut, sx, sw, bits)
    assert out.dtype == torch.int32 and out.shape == (4, 2048)
    (args,) = rec["_PARTIAL"].calls
    assert not rec["_FUSED"].calls
    assert rec["_PARTIAL"].symbol == "lut_gemm_partial"
    assert asked == {"lut_gemm_partial_capacity"}
    plan = approx_matmul.cluster_plan(4, 1024, 2048, _gpcs(H100_GPCS, 1))
    assert args[-4:-1] == (plan.rows, plan.splits, plan.k_split)
    assert args[7:12] == (out.data_ptr(), 4, 1024, 2048, bits)
    _card_side(monkeypatch, approx_matmul, ["_PARTIAL"], refuse=True)
    with pytest.raises(RuntimeError, match="lut_gemm_partial"):
        approx_matmul.lut_matmul_partial(x, w, lut, sx, sw, bits)


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("bits", [2, 8, 9, 16])
def test_log_partial_takes_the_route_of_its_bits(monkeypatch, bits,
                                                 compensated):
    """The card side of mitchell_matmul_partial follows fused_route: up to
    8 bits the cluster kernel's partial entry (planned, compensated
    before the plan), above it the tiled template's; int32 out either
    way; a refused cluster launch raises."""
    x, w, sx, sw = _shard_operands()
    rec, asked = _card_side(monkeypatch, mitchell_gemm,
                            ["_PARTIAL", "_PARTIAL_WIDE"])
    out = mitchell_gemm.mitchell_matmul_partial(x, w, sx, sw, bits,
                                                compensated)
    assert out.dtype == torch.int32 and out.shape == (4, 2048)
    cluster = mitchell_gemm.fused_route(bits) == "cluster"
    assert cluster == (bits <= 8)
    used, idle = ("_PARTIAL", "_PARTIAL_WIDE")[::1 if cluster else -1]
    (args,) = rec[used].calls
    assert not rec[idle].calls
    assert args[6:11] == (out.data_ptr(), 4, 1024, 2048, bits)
    assert args[11] == int(compensated)
    if cluster:
        plan = approx_matmul.cluster_plan(4, 1024, 2048,
                                          _gpcs(H100_GPCS, 1))
        assert args[12:15] == (plan.rows, plan.splits, plan.k_split)
        assert asked == {"log_gemm_partial_capacity"}
        _card_side(monkeypatch, mitchell_gemm, ["_PARTIAL"], refuse=True)
        with pytest.raises(RuntimeError, match="log_gemm_partial"):
            mitchell_gemm.mitchell_matmul_partial(x, w, sx, sw, bits,
                                                  compensated)
    else:
        assert len(args) == 13 and not asked


def _rank_order_sum(prods, k_split):
    """The cluster kernel's partial form on int64 products (M, K, N): each
    K slice of `k_split` (one block of the cluster) summed in uint32, the
    slices' sums added in rank order in uint32 (the flush through
    distributed shared memory), the result written as int32."""
    total = torch.zeros(prods.shape[0], prods.shape[2], dtype=torch.int64)
    for k0 in range(0, prods.shape[1], k_split):
        total = (total + prods[:, k0:k0 + k_split].sum(1)) % (1 << 32)
    return _wrap32(total).to(torch.int32)


@pytest.mark.parametrize("core", ["lut", "mitchell", "log_our"])
def test_rank_order_partial_sum_equals_the_plain_partial(core):
    """At K = 250,000 with operands of 110..127 (one k in 64 with b
    negated) every sum passes 2^31 and wraps; the kernel's split-K uint32 sum, in the plan's slices, written
    as int32, equals the plain partial versions bit for bit."""
    m, k, n = 2, 250_000, 3
    rng = np.random.default_rng(7)
    qa = torch.from_numpy(rng.integers(110, 128, (m, k)))
    qb = torch.from_numpy(rng.integers(110, 128, (k, n)))
    qb[::64] *= -1                    # some negative products
    sx, sw = torch.tensor(0.5), torch.full((n,), 0.25)
    x, w = qa.float() * sx, qb.float() * sw     # quantize back to qa, qb
    plan = approx_matmul.cluster_plan(m, k, n, _gpcs(H100_GPCS, 1))
    assert plan.splits == approx_matmul.CLUSTER_MAX_SPLITS
    if core == "lut":
        lut = ops.lut_table(MultiplierSpec("appro42", 8, True, "orplane",
                                           10), "cpu")
        prods = lut.long()[((qa + 128) << 8)[:, :, None]
                           + (qb + 128)[None]]
        want = approx_matmul.lut_matmul_partial_plain(x, w, lut, sx, sw)
    else:
        comp = core == "log_our"
        prods = tref.log_product(qa[:, :, None], qb[None], 8, comp)
        want = mitchell_gemm.mitchell_matmul_partial_plain(x, w, sx, sw, 8,
                                                           comp)
    assert int(prods.sum(1).min()) >= 1 << 31      # every sum wraps
    got = _rank_order_sum(prods, plan.k_split)
    assert want.dtype == torch.int32 and torch.equal(got, want)



# --- the fused surrogate GEMM (csrc/surrogate_cluster.cuh) ------------------

def _halves(q):
    """sg_put's split of q^2 into h = q^2 >> 7 and l = q^2 & 127."""
    sq = q * q
    return sq >> 7, sq & 127


@pytest.mark.parametrize("bits", range(2, 9))
def test_square_halves_are_valid_s8_and_recombine_exactly(bits):
    qmax = (1 << (bits - 1)) - 1
    a, b = _all_pairs(-qmax, qmax)
    ha, la = _halves(a)
    hb, lb = _halves(b)
    for v in (ha, la, hb, lb):
        assert int(v.min()) >= 0 and int(v.max()) <= 127
        # packed as a byte and read back as a signed one, unchanged
        assert torch.equal(_signed_byte(_byte(v), 0), v)
    got = (ha * hb << 14) + ((ha * lb + la * hb) << 7) + la * lb
    assert torch.equal(got, a * a * b * b)


def _split_k_sq(a, b, k_split):
    """The kernel's SQ: per K slice the four int32 sums HH, HL, LH, LL of
    the squares' halves (each checked below 2^31), summed over the slices
    with 32-bit wrap, combined in 64 bits as 2^14 HH + 2^7 (HL + LH) + LL
    and rounded once to f32."""
    ha, la = _halves(a.to(torch.int64))
    hb, lb = _halves(b.to(torch.int64))
    k = a.shape[1]
    sums = [torch.zeros(a.shape[0], b.shape[1], dtype=torch.int64)
            for _ in range(4)]
    for k0 in range(0, max(k, 1), k_split):
        sl = slice(k0, k0 + k_split)
        for i, (x, y) in enumerate(((ha, hb), (ha, lb), (la, hb), (la, lb))):
            part = x[:, sl] @ y[sl]
            assert part.numel() == 0 or int(part.max()) < 1 << 31
            sums[i] = (sums[i] + part) % (1 << 32)
    hh, hl, lh, ll = sums
    return ((hh << 14) + ((hl + lh) << 7) + ll).to(torch.float32)


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 31, 7), (5, 70, 17),
                                   (17, 257, 33), (4, 2048, 8)], ids=str)
@pytest.mark.parametrize("k_split", [64, 128, 1024])
def test_split_k_sq_model_equals_square_dot(shape, k_split):
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + k + n)
    # (a's range, b's range): random, every operand +-127 (the largest
    # squares), small magnitudes
    for (alo, ahi), (blo, bhi) in ((((-127, 127),) * 2),
                                   ((127, 127), (127, 127)),
                                   ((-127, -127), (127, 127)),
                                   (((-7, 7),) * 2)):
        a = torch.from_numpy(rng.integers(alo, ahi + 1, size=(m, k)))
        b = torch.from_numpy(rng.integers(blo, bhi + 1, size=(k, n)))
        assert torch.equal(_split_k_sq(a, b, k_split),
                           tref.square_dot(a, b))


def test_split_k_sq_model_holds_at_the_largest_sums():
    # every operand 127 at K just below the limit: LL = 127^2 K < 2^31,
    # and SQ (about 2^44) rounds once
    k = cim_gemm.SQ_MAX_K - 1
    a = torch.full((1, k), 127, dtype=torch.int64)
    b = torch.full((k, 1), -127, dtype=torch.int64)
    assert 127 * 127 * k < 1 << 31 < 127 * 127 * (cim_gemm.SQ_MAX_K + 1)
    assert torch.equal(_split_k_sq(a, b, 16_704), tref.square_dot(a, b))


def test_sq_k_limit_refuses_at_133144():
    assert cim_gemm.SQ_MAX_K == 133_144
    cim_gemm.check_sq_k(133_143)
    for k in (133_144, 200_000):
        with pytest.raises(ValueError, match="SQ exactly"):
            cim_gemm.check_sq_k(k)


def test_surrogate_variants_follow_the_plain_version():
    eps = torch.zeros(1, 1)
    assert cim_gemm.variant(None, 1.0, 1e-4) == cim_gemm.SERVED
    assert cim_gemm.variant(eps, 0.0, 0.0) == cim_gemm.SERVED
    assert cim_gemm.variant(eps, 3.3, 0.0) == cim_gemm.NOISE
    assert cim_gemm.variant(eps, 0.0, 2e-4) == cim_gemm.NOISE_SQ
    assert cim_gemm.variant(eps, 1480.0, 2.1e-4) == cim_gemm.NOISE_SQ


@pytest.mark.parametrize("capacity", [
    _gpcs(H100_GPCS, 1), _gpcs(H100_GPCS, 2), _gpcs((1,), 1),
    lambda rows, s: 78 // s], ids=["one_an_sm", "two_an_sm", "one_sm",
                                   "flat78"])
def test_surrogate_plan_invariants(capacity):
    shapes = SHAPES + [(65536, 27, 16), (65536, 288, 64), (16, 64, 64),
                       (130, 6144, 2048)]
    for m, k, n in shapes:
        p = approx_matmul.cluster_plan(m, k, n, capacity,
                                       cim_gemm.FUSED_ROWS)
        assert p.rows in cim_gemm.FUSED_ROWS
        assert p.rows == (16 if m <= 16 else 64)
        assert p.tiles == -(-m // p.rows) * -(-n // 64)
        assert 1 <= p.splits <= approx_matmul.CLUSTER_MAX_SPLITS
        assert capacity(p.rows, p.splits) > 0 or k == 0
        assert p.k_split > 0 and p.k_split % approx_matmul.CLUSTER_BK == 0
        assert p.splits * p.k_split >= k                 # covers K
        if k > 0:
            assert (p.splits - 1) * p.k_split < k        # no empty slice
        else:
            assert p.splits == 1
