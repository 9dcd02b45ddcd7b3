"""The fused sLSTM recurrence: a CUDA kernel for Hopper and its plain
version.

``slstm_scan(u, r, bias, n_heads, state=None)`` runs the whole
recurrence of one sLSTM layer over T steps (the reference's
``slstm_scan``, which starts from zeros, with an optional initial state
and the final state returned, so that prefill fills the cache and a
decode step is T = 1 from it).  u (B, T, 4d) f32 are the input
pre-activations, head-major and gate-major within a head
([z | i | f | o], each dh wide); r (nh, dh, 4dh) f32; bias (nh, 4dh)
f32; state (c, n, h, m), each (B, nh, dh) f32.  Returns h (B, T, nh, dh)
f32 and the final (c, n, h, m).

On CUDA tensors it launches csrc/slstm_scan.cu or raises; on CPU tensors
it runs its plain version (ref.slstm_scan_ref).  The launch takes one of
two routes, chosen by shape before it (`cluster_plan`): the cluster
kernel (csrc/slstm_cluster.cuh), each head's r resident in the shared
memory of a thread-block cluster of `cs` blocks and h exchanged through
distributed shared memory every step, wherever a head's slice fits a
block; or the streamed kernel, r read from L2 every step, for heads too
wide for any cluster.  A refused launch raises; nothing retries on the
other route.  `KERNELS["slstm_scan"]` counts the launches of both,
`ROUTES` each route's.

The kernels sum the recurrent dot with FMAs in their own order (the
streamed one in k order, the cluster one in `ks` interleaved chunks of
4 k, then a butterfly over the chunks: modelled in plain torch in
tests/test_torch_slstm_plan.py) and use libm's expf/tanhf/log1pf, so
they agree with the plain version within `ATOL` / `STATE_RTOL`, not bit
for bit (chip_smoke.py phase 3 prints the errors it measures,
tests/test_torch_gpu.py holds them).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from .build import (INT, PTR, CudaKernel, on_cuda, query, require,
                    stream_of)
from .ref import slstm_scan_ref

_SCAN = CudaKernel("slstm_scan", "slstm_scan_f32",
                   [PTR] * 12 + [INT] * 5 + [PTR])

KERNELS = {"slstm_scan": _SCAN}
# the launches of each route (both also count in KERNELS["slstm_scan"])
ROUTES = {"cluster": 0, "streamed": 0}

MAX_HEAD_DIM = 1024                 # the streamed kernel: a thread a unit

# csrc/slstm_cluster.cuh's SL_ROWS and SL_MAX_CLUSTER
ROWS = 4                            # batch rows a cluster carries
MAX_CLUSTER = 16                    # the non-portable cluster limit

# The kernel against its plain version on the card, both f32: the dot's
# order (k order with FMAs against the einsum's) and libm's last ulp move
# a step's pre-activations by a few f32 ulps; the normaliser keeps
# |h| <= 1 and the stabilizer keeps the exponentials <= 1, so the
# difference stays a few ulps of 1 and does not build up over T: h and
# m within ATOL, the final c and n (sums that may grow with T) within
# ATOL + STATE_RTOL |plain|.
ATOL = 1e-5
STATE_RTOL = 1e-5


def close(got, want) -> bool:
    """Does a kernel result (h, (c, n, h, m)) match its plain version's
    within the stated tolerance?"""
    (gh, (gc, gn, gh_t, gm)), (wh, (wc, wn, wh_t, wm)) = got, want
    return (all(torch.allclose(g, w, rtol=0, atol=ATOL)
                for g, w in ((gh, wh), (gh_t, wh_t), (gm, wm)))
            and all(torch.allclose(g, w, rtol=STATE_RTOL, atol=ATOL)
                    for g, w in ((gc, wc), (gn, wn))))


class Plan(NamedTuple):
    """The route of one call: "cluster" with clusters of `cs` blocks
    (`waves` of them), or "streamed" (cs 0)."""
    route: str
    cs: int
    waves: int = 1


def cluster_plan(b: int, nh: int, dh: int,
                 capacity: Callable[[int], int]) -> Plan:
    """The route and cluster size of a call at batch `b`, `nh` heads of
    `dh`: ``capacity(cs)`` is the number of clusters of `cs` blocks the
    device holds at once, 0 where that block does not fit (asked only of
    the sizes up to MAX_CLUSTER that divide dh).  The fewest waves of the
    nh x ceil(b / ROWS) clusters win, then the larger size (a head's
    units over more SMs: a shorter dot); with no size held, the streamed
    kernel."""
    clusters = nh * -(-b // ROWS)
    best = None
    for cs in range(1, MAX_CLUSTER + 1):
        held = capacity(cs) if dh % cs == 0 else 0
        if held > 0:
            key = (-(-clusters // held), -cs)
            best = min(best or key, key)
    return Plan("cluster", -best[1], best[0]) if best else Plan("streamed", 0)


@functools.lru_cache(maxsize=None)
def _capacity(device: int, dh: int, cs: int) -> int:
    """csrc slstm_scan_capacity on CUDA device `device`; cached."""
    with torch.cuda.device(device):
        return query("slstm_scan", "slstm_scan_capacity", dh, cs)


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else 0


def fitting_sizes(dh: int, device: torch.device) -> list:
    """The cluster sizes the kernel can launch at head dim `dh` on
    `device` (a CUDA device): those whose capacity is not 0."""
    return [cs for cs in range(1, MAX_CLUSTER + 1)
            if dh % cs == 0 and _capacity(_index(device), dh, cs) > 0]


@functools.lru_cache(maxsize=None)
def device_plan(b: int, nh: int, dh: int, device: torch.device) -> Plan:
    """`cluster_plan` with the capacity of `device` (a CUDA device);
    cached."""
    return cluster_plan(b, nh, dh,
                        functools.partial(_capacity, _index(device), dh))


def slstm_scan(u: torch.Tensor, r: torch.Tensor, bias: torch.Tensor,
               n_heads: int, state=None):
    """h (B, T, nh, dh) and the final (c, n, h, m) of the sLSTM
    recurrence from `state` (zeros by default); see the module
    docstring."""
    b, t, d4 = u.shape
    dh = d4 // 4 // n_heads
    require(d4 == 4 * n_heads * dh, f"u's width {d4} is not 4 * {n_heads} "
            "heads x dh")
    require(tuple(r.shape) == (n_heads, dh, 4 * dh),
            f"r must be {(n_heads, dh, 4 * dh)}, got {tuple(r.shape)}")
    require(tuple(bias.shape) == (n_heads, 4 * dh),
            f"bias must be {(n_heads, 4 * dh)}, got {tuple(bias.shape)}")
    if state is not None:
        require(len(state) == 4 and all(
            tuple(s.shape) == (b, n_heads, dh) for s in state),
            f"state must be four ({b}, {n_heads}, {dh}) tensors")
    operands = (u, r, bias) + tuple(state or ())
    if not on_cuda(*operands):
        return slstm_scan_ref(u, r, bias, n_heads, state)
    require(all(x.dtype == torch.float32 for x in operands),
            "the sLSTM kernel takes f32 operands")
    require(all(x.is_contiguous() for x in operands),
            "operands must be contiguous")
    require(t >= 1, "the sLSTM kernel needs T >= 1")
    require(dh <= MAX_HEAD_DIM, f"head dim {dh} > {MAX_HEAD_DIM}")
    plan = device_plan(b, n_heads, dh, u.device)
    return _launch(u, r, bias, n_heads, state, plan.cs)


def _launch(u, r, bias, n_heads: int, state, cs: int):
    """Launch csrc/slstm_scan.cu on checked CUDA operands: the cluster
    kernel with clusters of `cs` blocks, or the streamed one (cs 0).  The
    wrapper passes its plan's cs; tests and launch/cluster_sweep.py force
    one."""
    b, t, d4 = u.shape
    dh = d4 // 4 // n_heads
    if state is None:
        state = torch.zeros((4, b, n_heads, dh), dtype=torch.float32,
                            device=u.device).unbind(0)
    hs = torch.empty((b, t, n_heads, dh), dtype=torch.float32,
                     device=u.device)
    final = tuple(torch.empty_like(state[0]) for _ in range(4))
    _SCAN(u.data_ptr(), r.data_ptr(), bias.data_ptr(),
          *(s.data_ptr() for s in state), hs.data_ptr(),
          *(s.data_ptr() for s in final), b, t, n_heads, dh, cs,
          stream_of(u))
    ROUTES["cluster" if cs else "streamed"] += 1
    return hs, final
