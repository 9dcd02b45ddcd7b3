"""The int forms of the split-K cluster GEMM on the CPU: ``lut_matmul``,
``lut_matmul_mag`` and ``mitchell_matmul`` on csrc/cluster_gemm.cuh with
int8 operands (IntOut: no scale read, the raw int32 sum out).

A plain torch model of the magnitude form's staged operands (the byte
offset of row min(|a|, qmax) and sign(a); the byte offset of column
min(|b|, qmax) and sign(b)) held against the gather from
``signed_from_magnitude``'s int32 table on every operand pair at 2..8
bits, faulted and clean; the log forms' byte packing on int8 operands
(-128 included, which no quantized operand reaches) against the
reference's ``_log_product``, and the int8 staging against the quantized
path's; the rank-order split-K sum of each int form against its plain
version; the launch plan at the per-token and faulted lanes' shapes; and
the wrappers' card side: the cluster entries up to 8 bits, the template
for 9..16-bit log operands, log_our's domain below 8 bits.  The kernels
themselves run only on the card (tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

from repro_torch.core.faults import FaultConfig
from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.kernels import approx_matmul, mitchell_gemm, ops
from repro_torch.kernels import ref as tref
from test_torch_cluster_gemm import (H100_GPCS, _all_pairs, _card_side,
                                     _gpcs, _log_our_word, _mitchell_pair,
                                     _rank_order_sum, _reference, _wrap32)

BITS = tuple(range(2, 9))
FAULT = FaultConfig(p_sa0=0.05, p_sa1=0.05, seed=3)


def _mag_table(bits, faulted):
    spec = MultiplierSpec("appro42", bits, True, "orplane")
    return ops.magnitude_lut(spec, FAULT if faulted else None, "cpu")


# --- the magnitude form's staged operands ----------------------------------

def _mag_x(a, bits):
    """The staged x: (byte offset of row min(|a|, qmax), sign(a))."""
    qmax = (1 << (bits - 1)) - 1
    return torch.clamp(a.abs(), max=qmax) << bits, torch.sign(a)


def _mag_w(b, bits):
    """The staged w registers: (byte offset min(|b|, qmax) * 2, sign(b))."""
    qmax = (1 << (bits - 1)) - 1
    return torch.clamp(b.abs(), max=qmax) * 2, torch.sign(b)


def _mag_products(a, b, mag, bits):
    """The kernel's product: sign(a) sign(b) uf[byte (offA + offB) / 2],
    the uint16 read at the summed byte offset, in uint32 (as int32)."""
    (oa, sa), (ob, sb) = _mag_x(a, bits), _mag_w(b, bits)
    words = mag.view(torch.int16).to(torch.int64) & 0xFFFF
    return _wrap32(sa * sb * words[(oa + ob) // 2])


@pytest.mark.parametrize("faulted", [True, False], ids=["faulted", "clean"])
@pytest.mark.parametrize("bits", BITS)
def test_magnitude_staging_equals_the_signed_table_on_every_pair(bits,
                                                                 faulted):
    """Every operand pair of the b-bit range, -2^{b-1} included (it
    saturates to qmax, as signed_from_magnitude builds the table): the
    staged product equals the gather from the int32 signed table, and
    every read lies inside the kernel's table copy."""
    half = 1 << (bits - 1)
    a, b = _all_pairs(-half, half - 1)
    mag = _mag_table(bits, faulted)
    signed = approx_matmul.signed_from_magnitude(mag, bits).to(torch.int64)
    want = signed[(a + half) * (1 << bits) + (b + half)]
    assert torch.equal(_mag_products(a, b, mag, bits), want)
    (oa, _), (ob, _) = _mag_x(a, bits), _mag_w(b, bits)
    table_bytes = -(-((1 << (2 * (bits - 1))) * 2) // 16) * 16
    assert int((oa + ob).max()) + 2 <= table_bytes
    assert table_bytes == approx_matmul.mag_entries(bits) * 2


def test_sign_zero_annihilates_a_faulted_zero_row():
    """A stuck-at-1 cell can make uf[0][b] or uf[a][0] nonzero; sign 0 of
    a zero operand (and of the ragged edges, staged as 0) still zeroes
    the product."""
    bits = 8
    mag = _mag_table(bits, True)
    words = (mag.view(torch.int16).to(torch.int64) & 0xFFFF)[:128 * 128]
    words = words.reshape(128, 128)
    assert int(words[0].abs().sum()) > 0 and int(words[:, 0].abs().sum()) > 0
    v = torch.arange(-128, 128)
    zero = torch.zeros_like(v)
    assert not _mag_products(zero, v, mag, bits).any()
    assert not _mag_products(v, zero, mag, bits).any()


# --- the log forms on int8 operands -----------------------------------------

@pytest.mark.parametrize("compensated", [False, True])
def test_log_byte_forms_hold_on_every_int8_pair_at_8_bits(compensated):
    """-128 = -1 x 2^7 fits every signed byte of the staged forms (the
    quantized path, clipped to +-127, never reaches it)."""
    a, b = _all_pairs(-128, 127)
    want = _reference(a, b, 8, compensated)
    if compensated:
        assert torch.equal(_log_our_word(a, b, 8), want)
    else:
        zero = torch.zeros_like(a)
        assert torch.equal(_mitchell_pair(a, zero, b, zero, 8), want)


@pytest.mark.parametrize("bits", range(2, 8))
def test_log_byte_forms_on_int8_below_8_bits(bits):
    """Below 8 bits the leading one is capped at bits - 1: mitchell's
    bytes still hold every int8 (q <= 126), and log_our's carry-free OR
    holds while |v| < 2^bits, the domain the wrapper keeps on the card;
    past it some pair differs from the reference."""
    a, b = _all_pairs(-128, 127)
    zero = torch.zeros_like(a)
    assert torch.equal(_mitchell_pair(a, zero, b, zero, bits),
                       _reference(a, b, bits, False))
    lim = 1 << bits
    inside = (a.abs() < lim) & (b.abs() < lim)
    got = _log_our_word(a, b, bits)
    want = _reference(a, b, bits, True)
    assert torch.equal(got[inside], want[inside])
    assert not torch.equal(got, want)


@pytest.mark.parametrize("bits", BITS)
def test_int8_staging_is_the_quantized_paths_on_the_same_integers(bits):
    """The kernel stages an int form's int8 as it stands and a fused
    form's float through quantize (cl_operand): on floats that quantize
    to the same integers (v * 2^-3, exact), both feed the one set of
    staged-form functions the same values, so the staged products agree
    pair for pair."""
    qmax = (1 << (bits - 1)) - 1
    v = torch.arange(-qmax, qmax + 1)
    scale = torch.tensor(0.125)
    q = tref.quantize_tile(v.to(torch.float32) * scale, scale, qmax)
    assert torch.equal(q.to(torch.int64), v)
    a, b = _all_pairs(-qmax, qmax)
    fa = tref.quantize_tile(a.float() * scale, scale, qmax).to(torch.int64)
    fb = tref.quantize_tile(b.float() * scale, scale, qmax).to(torch.int64)
    zero = torch.zeros_like(a)
    assert torch.equal(_mitchell_pair(fa, zero, fb, zero, bits),
                       _mitchell_pair(a, zero, b, zero, bits))
    assert torch.equal(_log_our_word(fa, fb, bits),
                       _log_our_word(a, b, bits))
    mag = _mag_table(bits, True)
    assert torch.equal(_mag_products(fa, fb, mag, bits),
                       _mag_products(a, b, mag, bits))


# --- the split-K sum -----------------------------------------------------------

@pytest.mark.parametrize("core", ["lut", "mag", "mitchell", "log_our"])
def test_rank_order_int_sum_equals_the_plain_int_form(core):
    """At K = 250,000 with int8 operands of magnitude 110..127 (one k in
    64 with b negated; -128 in the first column of x) every sum passes
    2^31 and wraps; the kernel's split-K uint32 sum in the plan's slices,
    written as int32, equals the plain int forms bit for bit."""
    m, k, n = 2, 250_000, 3
    rng = np.random.default_rng(11)
    qa = torch.from_numpy(rng.integers(110, 128, (m, k)))
    qb = torch.from_numpy(rng.integers(110, 128, (k, n)))
    qb[::64] *= -1
    qa[:, 0] = -128
    xq, wq = qa.to(torch.int8), qb.to(torch.int8)
    rows = approx_matmul.MAG_ROWS if core == "mag" else \
        approx_matmul.CLUSTER_ROWS
    plan = approx_matmul.cluster_plan(m, k, n, _gpcs(H100_GPCS, 2), rows)
    assert plan.splits == approx_matmul.CLUSTER_MAX_SPLITS
    a, b = qa[:, :, None], qb[None]
    if core == "lut":
        lut = ops.lut_table(MultiplierSpec("appro42", 8, True, "orplane",
                                           10), "cpu")
        prods = lut.long()[((a + 128) << 8) + (b + 128)]
        want = approx_matmul.lut_matmul(xq, wq, lut)
    elif core == "mag":
        mag = _mag_table(8, True)
        prods = _mag_products(a, b, mag, 8)
        want = approx_matmul.lut_matmul_mag(xq, wq, mag)
    else:
        comp = core == "log_our"
        prods = tref.log_product(a, b, 8, comp)
        want = mitchell_gemm.mitchell_matmul(xq, wq, 8, comp)
    assert int(prods.sum(1).abs().min()) >= 1 << 31     # every sum wraps
    got = _rank_order_sum(prods, plan.k_split)
    assert want.dtype == torch.int32 and torch.equal(got, want)


# --- the launch plan at the served shapes -------------------------------------

LM_WEIGHTS = ((2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048))
# phase 11: a 4-slot decode (4), the k = 4 verify (20), a prefill group
# (64); phase 12: decode rounds of 1 or 2 slots and 4-8-token prompts
# over 2 slots (8, 16)
SERVED_M = (1, 2, 4, 8, 16, 20, 64)


@pytest.mark.parametrize("form", ["lut", "mag", "log"])
@pytest.mark.parametrize("m", SERVED_M)
def test_cluster_plan_at_the_served_shapes(m, form):
    """Under the H100 capacities of each int instantiation (the LUT one
    block an SM, the magnitude and mitchell kernels two): the fewest
    row tiles that hold M, a split the device holds, K covered with no
    slice empty; a decode round's 32 tiles (N = 2048) are split to fill
    the card."""
    per_sm = 1 if form == "lut" else 2
    tiles = approx_matmul.MAG_ROWS if form == "mag" else \
        approx_matmul.CLUSTER_ROWS
    cap = _gpcs(H100_GPCS, per_sm)
    for k, n in LM_WEIGHTS:
        p = approx_matmul.cluster_plan(m, k, n, cap, tiles)
        assert p.rows == next((r for r in tiles if m <= r), tiles[-1])
        assert p.tiles == -(-m // p.rows) * (n // 64)
        assert cap(p.rows, p.splits) > 0
        assert p.k_split % approx_matmul.CLUSTER_BK == 0
        assert (p.splits - 1) * p.k_split < k <= p.splits * p.k_split
        if m <= 4 and n == 2048:
            assert p.splits > 1


# --- the wrappers' card side -------------------------------------------------

def _ints(m, k, n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(lo, hi, (m, k)).astype(np.int8)),
            torch.from_numpy(rng.integers(lo, hi, (k, n)).astype(np.int8)))


@pytest.mark.parametrize("m", [4, 20])
@pytest.mark.parametrize("bits", [4, 8])
def test_lut_int_forms_launch_the_cluster_kernel(monkeypatch, bits, m):
    """The card side of lut_matmul and lut_matmul_mag: their cluster
    entries with int8 operands, the plan from the entry's own capacity
    query over its row tiles (the magnitude form's stop at 16), an int32
    output, no scale; the range and table checks before the launch; a
    refused launch raises (no fallback to the template or the plain
    version)."""
    half = 1 << (bits - 1)
    xq, wq = _ints(m, 1024, 2048, -half, half, bits + m)
    lut = torch.zeros(1 << (2 * bits), dtype=torch.int16)
    mag = torch.zeros(approx_matmul.mag_entries(bits), dtype=torch.uint16)
    for fn, table, name, symbol, rows in (
            (approx_matmul.lut_matmul, lut, "_INT", "lut_gemm_int8_cluster",
             approx_matmul.CLUSTER_ROWS),
            (approx_matmul.lut_matmul_mag, mag, "_INT_MAG",
             "lut_gemm_int8_mag_cluster", approx_matmul.MAG_ROWS)):
        rec, asked = _card_side(monkeypatch, approx_matmul, [name])
        out = fn(xq, wq, table, bits)
        assert out.dtype == torch.int32 and out.shape == (m, 2048)
        (args,) = rec[name].calls
        assert rec[name].symbol == symbol
        assert asked == {symbol + "_capacity"}
        plan = approx_matmul.cluster_plan(m, 1024, 2048,
                                          _gpcs(H100_GPCS, 1), rows)
        assert args == (xq.data_ptr(), wq.data_ptr(), table.data_ptr(),
                        out.data_ptr(), m, 1024, 2048, bits, plan.rows,
                        plan.splits, plan.k_split, 0)
        if bits < 8:
            with pytest.raises(ValueError, match="lie in"):
                fn(xq + half, wq, table, bits)
        with pytest.raises(ValueError, match="table"):
            fn(xq, wq, table[:-1].clone(), bits)
        _card_side(monkeypatch, approx_matmul, [name], refuse=True)
        with pytest.raises(RuntimeError, match=symbol):
            fn(xq, wq, table, bits)


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("bits", [2, 5, 8, 9, 16])
def test_log_int_form_takes_the_route_of_its_bits(monkeypatch, bits,
                                                  compensated):
    """The card side of mitchell_matmul follows fused_route: up to 8 bits
    the cluster entry (planned, compensated before the plan), above it
    the tiled template's; int32 out either way; a refused cluster launch
    raises."""
    xq, wq = _ints(4, 1024, 2048, -1, 2, bits)
    rec, asked = _card_side(monkeypatch, mitchell_gemm,
                            ["_INT", "_INT_WIDE"])
    out = mitchell_gemm.mitchell_matmul(xq, wq, bits, compensated)
    assert out.dtype == torch.int32 and out.shape == (4, 2048)
    cluster = mitchell_gemm.fused_route(bits) == "cluster"
    used, idle = ("_INT", "_INT_WIDE")[::1 if cluster else -1]
    (args,) = rec[used].calls
    assert not rec[idle].calls
    assert args[:8] == (xq.data_ptr(), wq.data_ptr(), out.data_ptr(), 4,
                        1024, 2048, bits, int(compensated))
    if cluster:
        plan = approx_matmul.cluster_plan(4, 1024, 2048,
                                          _gpcs(H100_GPCS, 1))
        assert args[8:] == (plan.rows, plan.splits, plan.k_split, 0)
        assert asked == {"log_gemm_int8_cluster_capacity"}
        _card_side(monkeypatch, mitchell_gemm, ["_INT"], refuse=True)
        with pytest.raises(RuntimeError, match="log_gemm_int8_cluster"):
            mitchell_gemm.mitchell_matmul(xq, wq, bits, compensated)
    else:
        assert len(args) == 9 and not asked


@pytest.mark.parametrize("bits", range(2, 8))
def test_log_our_int_form_keeps_its_domain_on_the_card(monkeypatch, bits):
    """Below 8 bits log_our's cluster form takes operands of magnitude
    below 2^bits (x and w alike) and refuses the first past it; mitchell,
    exact on every int8, takes any; at 8 bits every int8 is inside."""
    lim = 1 << bits
    xq, wq = _ints(4, 64, 8, -min(lim - 1, 127), min(lim, 128), bits)
    rec, _ = _card_side(monkeypatch, mitchell_gemm, ["_INT"])
    mitchell_gemm.mitchell_matmul(xq, wq, bits, True)
    for past in (-lim, lim):
        if not -128 <= past <= 127:
            continue
        for bad_x in (True, False):
            x2, w2 = xq.clone(), wq.clone()
            (x2 if bad_x else w2)[0, 0] = past
            with pytest.raises(ValueError, match="log_our"):
                mitchell_gemm.mitchell_matmul(x2, w2, bits, True)
            mitchell_gemm.mitchell_matmul(x2, w2, bits, False)
    full = torch.full((4, 64), -128, dtype=torch.int8)
    mitchell_gemm.mitchell_matmul(full, wq, 8, True)
    assert len(rec["_INT"].calls) == 2 + 2 * sum(
        -128 <= p <= 127 for p in (-lim, lim))
