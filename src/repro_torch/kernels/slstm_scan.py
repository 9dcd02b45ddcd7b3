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
it runs its plain version (ref.slstm_scan_ref).  The kernel sums the
recurrent dot in k order with FMAs and uses libm's expf/tanhf/log1pf, so
it agrees with the plain version within `ATOL` / `STATE_RTOL`, not bit
for bit (chip_smoke.py phase 3 prints the errors it measures,
tests/test_torch_gpu.py holds them).
"""

from __future__ import annotations

import torch

from .build import INT, PTR, CudaKernel, on_cuda, require, stream_of
from .ref import slstm_scan_ref

_SCAN = CudaKernel("slstm_scan", "slstm_scan_f32",
                   [PTR] * 12 + [INT, INT, INT, INT, PTR])

KERNELS = {"slstm_scan": _SCAN}

MAX_HEAD_DIM = 1024                 # one thread per hidden unit

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
    if state is None:
        state = tuple(torch.zeros((b, n_heads, dh), dtype=torch.float32,
                                  device=u.device) for _ in range(4))
    hs = torch.empty((b, t, n_heads, dh), dtype=torch.float32,
                     device=u.device)
    final = tuple(torch.empty_like(state[0]) for _ in range(4))
    _SCAN(u.data_ptr(), r.data_ptr(), bias.data_ptr(),
          *(s.data_ptr() for s in state), hs.data_ptr(),
          *(s.data_ptr() for s in final), b, t, n_heads, dh, stream_of(u))
    return hs, final
