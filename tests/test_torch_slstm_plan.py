"""The sLSTM recurrence's cluster kernel on the CPU.  csrc/slstm_cluster.cuh
keeps each head's recurrent weights resident in a thread-block cluster;
`slstm_scan.cluster_plan` picks the cluster size from the device's
capacity for each size (faked here), and the kernel's sum order is
modelled here in plain torch (`_kernel_model`), held within the kernel's
stated tolerance of `ref.slstm_scan_ref` at xlstm-125m's width.  The
kernel itself runs only on the card (tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import slstm_scan as ss
from repro_torch.kernels.ref import slstm_gates, slstm_scan_ref

XLSTM = (4, 192)                 # xlstm-125m: 4 sLSTM heads of 192
# the cluster sizes whose block fits at dh = 192 (each divides 192)
FIT_192 = (3, 4, 6, 8, 12, 16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch ops, restored after it.
    Its ops are small; next to the other test workers on the same cores,
    torch's default pool (a thread a core) spends its time waiting for
    cores those workers hold, not computing."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _k_split(dh, cs):
    """The kernel's k split of a column (sl_geometry): `ks` groups of
    threads, doubled from 4 while a block keeps two columns' worth of
    threads in 1,024, up to 32 and 8 ks <= dh rounded up to 4; k padded
    with zeros to `kpad`, a multiple of 4 ks."""
    cols, ks = 4 * dh // cs, 4
    while ks < 32 and cols * ks * 2 <= 1024 and 8 * ks <= -(-dh // 4) * 4:
        ks *= 2
    return ks, -(-dh // (4 * ks)) * 4 * ks


def _inputs(b, t, nh, dh, seed, nonzero):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, t, 4 * nh * dh)).astype(np.float32)
    r = (rng.standard_normal((nh, dh, 4 * dh)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal((nh, 4 * dh)) * 0.1).astype(np.float32)
    state = None
    if nonzero:                      # as a run leaves it
        sh = (b, nh, dh)
        state = tuple(torch.from_numpy(a.astype(np.float32)) for a in (
            rng.uniform(-1, 1, sh), rng.uniform(0.5, 2.0, sh),
            rng.uniform(-0.5, 0.5, sh), rng.uniform(-1, 1, sh)))
    return (torch.from_numpy(u), torch.from_numpy(r),
            torch.from_numpy(bias), state)


def _kernel_model(u, r, bias, n_heads, cs, state=None):
    """The cluster kernel's arithmetic in plain torch: column g dh + j of
    a head summed by `ks` k groups, group kg over k = (i ks + kg) 4 + e
    in that order, each step an FMA (the product and sum in f64, rounded
    to f32: one rounding but for a rare double rounding), the ks partials
    then summed by the butterfly xor ks/2 .. 1; pre = (u + dot) + bias and
    the gates of ref.slstm_gates.  Returns what `slstm_scan` returns."""
    b, t, d4 = u.shape
    dh = d4 // 4 // n_heads
    ks, kpad = _k_split(dh, cs)
    n4 = kpad // (4 * ks)
    rp = torch.zeros(n_heads, kpad, 4 * dh, dtype=torch.float64)
    rp[:, :dh] = r.double()
    # [head, i, kg, e, col]: the k of (i, kg, e)
    rp = rp.reshape(n_heads, n4, ks, 4, 4 * dh)
    ut = u.reshape(b, t, n_heads, 4 * dh)
    if state is None:
        state = tuple(torch.zeros((b, n_heads, dh)) for _ in range(4))
    c, n, h, m = state
    hs = []
    for i in range(t):
        hp = torch.zeros(b, n_heads, kpad, dtype=torch.float64)
        hp[..., :dh] = h.double()
        hp = hp.reshape(b, n_heads, n4, ks, 4)
        acc = torch.zeros(b, n_heads, ks, 4 * dh, dtype=torch.float32)
        for ii in range(n4):
            for e in range(4):
                prod = hp[:, :, ii, :, e, None] * rp[None, :, ii, :, e]
                acc = (prod + acc.double()).float()
        off = ks // 2
        while off:
            acc = acc + acc[:, :, torch.arange(ks) ^ off]
            off //= 2
        pre = (ut[:, i] + acc[:, :, 0]) + bias[None]
        c, n, h, m = slstm_gates(pre, c, n, m, dh)
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h, m)


@pytest.mark.parametrize("dh", [8, 13, 16, 64, 96, 128, 192, 256, 384,
                                512, 1024])
def test_plan_asks_the_divisors_and_takes_the_largest(dh):
    """With room for one wave at every size, the plan asks the capacity
    only of the sizes up to 16 that divide dh, and takes the largest."""
    asked = []

    def cap(cs):
        asked.append(cs)
        return 8

    divisors = [cs for cs in range(1, ss.MAX_CLUSTER + 1) if dh % cs == 0]
    assert ss.cluster_plan(4, 4, dh, cap) == ss.Plan("cluster",
                                                      divisors[-1], 1)
    assert asked == divisors


@pytest.mark.parametrize("dh", [16, 192, 512, 1024])
def test_plan_streams_where_no_cluster_fits(dh):
    """A capacity of 0 at every size (dh 512 and 1024 on the card: no
    block holds a slice of the head) sends the call to the streamed
    kernel; at dh = 192 the sizes the block cannot hold (1, 2) are
    skipped."""
    assert ss.cluster_plan(2, 1, dh, lambda cs: 0) == ss.Plan("streamed", 0)
    p = ss.cluster_plan(4, 4, 192, lambda cs: 8 if cs in FIT_192[:2] else 0)
    assert p == ss.Plan("cluster", 4, 1)


def test_plan_takes_the_fewest_waves_first():
    """A batch of 32 (8 row tiles x 4 heads = 32 clusters): where a GPC
    holds one cluster of 16 but several smaller ones, the fewest waves
    win over the larger size; at batch 8 (8 clusters), where 16 holds 7
    clusters and 8 holds 15 (as on an H100), one wave of 8 wins over two
    of 16; a size the device cannot hold is skipped."""
    def cap(cs):                     # 8 GPCs of 16 SMs, a block an SM
        return 8 * (16 // cs)

    assert ss.cluster_plan(32, 4, 192, cap) == ss.Plan("cluster", 4, 1)
    h100 = {3: 40, 4: 32, 6: 16, 8: 15, 12: 7, 16: 7}
    assert ss.cluster_plan(8, 4, 192, lambda cs: h100.get(cs, 0)) == \
        ss.Plan("cluster", 8, 1)
    assert ss.cluster_plan(4, 4, 192, lambda cs: h100.get(cs, 0)) == \
        ss.Plan("cluster", 16, 1)
    p = ss.cluster_plan(4, 4, 192, lambda cs: 0 if cs == 16 else 1)
    assert p == ss.Plan("cluster", 12, 4)


def test_cpu_wrapper_counts_no_route():
    u, r, bias, _ = _inputs(2, 3, 2, 8, 0, False)
    before = dict(ss.ROUTES)
    ss.slstm_scan(u, r, bias, 2)
    assert ss.ROUTES == before


@pytest.mark.parametrize("nonzero", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("cs", [4, 8, 16], ids=lambda v: f"cs{v}")
def test_kernel_sum_order_within_tolerance(cs, nonzero):
    """The cluster kernel's arithmetic (its k chunks, FMAs and butterfly:
    `_kernel_model`) against the plain version at xlstm-125m's width over
    a 512-step prefill, within ATOL / STATE_RTOL: the order moves a
    pre-activation by a few ulps and the gates do not let it build up.
    cs 4, 8 and 16 are the three k splits (ks 4, 8, 16) the plan can
    give at dh = 192."""
    nh, dh = XLSTM
    u, r, bias, state = _inputs(4, 512, nh, dh, cs, nonzero)
    got = _kernel_model(u, r, bias, nh, cs, state)
    want = slstm_scan_ref(u, r, bias, nh, state)
    assert got[0].shape == (4, 512, nh, dh)
    assert torch.isfinite(got[0]).all()
    assert ss.close(got, want), float((got[0] - want[0]).abs().max())
    # and not bit for bit: the model does sum in another order
    assert not torch.equal(got[0], want[0])


def test_model_pads_k_with_zeros():
    """A head dim that is not a multiple of 4 ks (13, cluster of 1: ks 4,
    kpad 16): the padding adds nothing."""
    u, r, bias, state = _inputs(3, 7, 2, 13, 1, True)
    got = _kernel_model(u, r, bias, 2, 1, state)
    want = slstm_scan_ref(u, r, bias, 2, state)
    assert ss.close(got, want)
