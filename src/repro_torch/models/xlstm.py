"""xLSTM blocks of the port: matrix-memory mLSTM (chunkwise-parallel)
and scalar-memory sLSTM (sequential), per arXiv:2405.04517, mirroring
the JAX package's ``models/xlstm.py``.

mLSTM cell (per head, exponential input gating, stabilizer m):
    C_t = f_t C_{t-1} + i_t k_t v_t^T        (dk x dv matrix memory)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t^T q_t) / max(|n_t . q_t|, 1)
Prefill uses the chunkwise form (an intra-chunk attention-like term
plus an inter-chunk recurrence, a Python loop over the chunks) in
stabilized log-gate space, stored state C_true = C * exp(m); a decode
step is one `_mlstm_step`.  It is plain PyTorch, as the reference
computes it outside any kernel.

sLSTM keeps per-head scalar memories with block-diagonal recurrent
weights.  The reference's model steps `_slstm_cell` under ``lax.scan``;
here every `slstm_block` call runs the fused recurrence
(kernels.slstm_scan): prefill and ``forward_logits`` from a zero state
(prefill writes the final state into the cache), a decode step as T = 1
from the cached state.  On the card that is the CUDA kernel; on CPU
tensors its plain version (kernels.ref.slstm_scan_ref), whose step is
the reference's `_slstm_cell`: the recurrent matvec, then the gating
op for op (kernels.ref.slstm_gates).

The projections (w_up, wq, wk, wv, w_down, w_in, w_out) go through
`cim_linear`; the mLSTM gate projections wi and wf are f32 matmuls.
Caches are dicts of f32 state tensors and a 0-dim int32 ``pos``;
the blocks return new cache dicts.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import log_sigmoid
from repro_torch.kernels.slstm_scan import slstm_scan

from .common import CiMContext, cim_linear, param, rms_norm

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen, d_model: int, n_heads: int, device,
               dtype=torch.bfloat16):
    di = 2 * d_model                        # up-projection factor 2
    f32 = torch.float32
    return {
        "w_up": param(gen, (d_model, 2 * di), device, dtype),
        "wq": param(gen, (di, di), device, dtype),
        "wk": param(gen, (di, di), device, dtype),
        "wv": param(gen, (di, di), device, dtype),
        "wi": param(gen, (di, n_heads), device, f32, scale=0.01),
        "bi": param(gen, (n_heads,), device, f32, init="zeros"),
        "wf": param(gen, (di, n_heads), device, f32, scale=0.01),
        "bf": param(gen, (n_heads,), device, f32, init="ones"),
        "gn": param(gen, (di,), device, init="ones"),
        "w_down": param(gen, (di, d_model), device, dtype),
    }


def _mlstm_chunk_scan(q, k, v, li, lf, state, chunk: int):
    """q,k,v: (B,T,nh,dk) f32; li/lf: (B,T,nh) log gates.
    state: (C (B,nh,dk,dv), n (B,nh,dk), m (B,nh)).  Returns (h, state)."""
    b, t, nh, dk = q.shape
    dv = v.shape[-1]
    l = min(chunk, t)
    while t % l:
        l -= 1
    nchunk = t // l
    qs = q.reshape(b, nchunk, l, nh, dk).permute(1, 0, 3, 2, 4)
    ks_ = k.reshape(b, nchunk, l, nh, dk).permute(1, 0, 3, 2, 4)
    vs = v.reshape(b, nchunk, l, nh, dv).permute(1, 0, 3, 2, 4)
    lis = li.reshape(b, nchunk, l, nh).permute(1, 0, 3, 2)
    lfs = lf.reshape(b, nchunk, l, nh).permute(1, 0, 3, 2)
    lmask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
    c, n, m = state                          # (b,nh,dk,dv), (b,nh,dk), (b,nh)
    hs = []
    for i in range(nchunk):
        qc, kc, vc, lic, lfc = qs[i], ks_[i], vs[i], lis[i], lfs[i]
        bcum = torch.cumsum(lfc, dim=-1)     # (b,nh,l) inclusive
        g = bcum + m[..., None]              # state weight (log)
        d = bcum[..., :, None] - bcum[..., None, :] + lic[..., None, :]
        d = torch.where(lmask, d, torch.full_like(d, -torch.inf))
        m_r = torch.maximum(g, d.amax(dim=-1))              # (b,nh,l)
        sc = torch.einsum("bhld,bhsd->bhls", qc, kc)
        wexp = torch.exp(d - m_r[..., None])
        w_intra = wexp * sc
        w_state = torch.exp(g - m_r)                         # (b,nh,l)
        h_num = (torch.einsum("bhls,bhsv->bhlv", w_intra, vc)
                 + w_state[..., None]
                 * torch.einsum("bhld,bhdv->bhlv", qc, c))
        den = (torch.einsum("bhls,bhls->bhl", wexp, sc)
               + w_state * torch.einsum("bhld,bhd->bhl", qc, n))
        hs.append(h_num / torch.maximum(den.abs(),
                                        torch.exp(-m_r))[..., None])
        # end-of-chunk state
        b_l = bcum[..., -1:]                                 # (b,nh,1)
        m_new = torch.maximum(b_l[..., 0] + m,
                              (b_l - bcum + lic).amax(dim=-1))
        w_c = torch.exp(b_l - bcum + lic - m_new[..., None])  # (b,nh,l)
        decay = torch.exp(b_l[..., 0] + m - m_new)
        c = (decay[..., None, None] * c
             + torch.einsum("bhs,bhsd,bhsv->bhdv", w_c, kc, vc))
        n = decay[..., None] * n + torch.einsum("bhs,bhsd->bhd", w_c, kc)
        m = m_new
    # (nchunk, b, nh, l, dv) -> (b, t, nh, dv)
    h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(b, t, nh, dv)
    return h, (c, n, m)


def _mlstm_step(q, k, v, li, lf, state):
    """Single-token decode.  q,k,v: (B,nh,dk)."""
    c, n, m = state
    m_new = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_new)
    iw = torch.exp(li - m_new)
    c = fw[..., None, None] * c + iw[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = fw[..., None] * n + iw[..., None] * k
    num = torch.einsum("bhd,bhdv->bhv", q, c)
    den = torch.einsum("bhd,bhd->bh", q, n)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h, (c, n, m_new)


def mlstm_block(params, x, *, n_heads: int, chunk: int, ctx: CiMContext,
                cache: Optional[dict] = None):
    b, s, d = x.shape
    di = params["wq"].shape[0]
    dk = di // n_heads
    up = cim_linear(x, params["w_up"], ctx, "w_up")
    xm, z = torch.chunk(up, 2, dim=-1)
    xm = xm.contiguous()                     # the GEMM kernels' operand
    q = cim_linear(xm, params["wq"], ctx, "wq").to(torch.float32)
    k = cim_linear(xm, params["wk"], ctx, "wk").to(torch.float32)
    v = cim_linear(xm, params["wv"], ctx, "wv").to(torch.float32)
    xm32 = xm.to(torch.float32)
    li = xm32 @ params["wi"] + params["bi"]
    lf = log_sigmoid(xm32 @ params["wf"] + params["bf"])
    q = q.reshape(b, s, n_heads, dk)
    k = k.reshape(b, s, n_heads, dk) * (dk ** -0.5)   # write-time key scale
    v = v.reshape(b, s, n_heads, dk)

    if cache is None or s > 1:
        if cache is None:
            state = init_mlstm_state(b, n_heads, dk, x.device)
        else:
            state = (cache["c"], cache["n"], cache["m"])
        h, state = _mlstm_chunk_scan(q, k, v, li, lf, state, chunk)
        new_cache = None
        if cache is not None:
            new_cache = {"c": state[0], "n": state[1], "m": state[2],
                         "pos": torch.full_like(cache["pos"], s)}
    else:
        state = (cache["c"], cache["n"], cache["m"])
        h, state = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], li[:, 0],
                               lf[:, 0], state)
        h = h[:, None]
        new_cache = {"c": state[0], "n": state[1], "m": state[2],
                     "pos": cache["pos"] + 1}
    h = h.reshape(b, s, di)
    h = rms_norm(h, params["gn"])            # group-norm stand-in
    h = h.to(x.dtype) * F.silu(z)
    return cim_linear(h, params["w_down"], ctx, "w_down"), new_cache


def init_mlstm_state(batch: int, n_heads: int, dk: int, device):
    f32 = torch.float32
    return (torch.zeros((batch, n_heads, dk, dk), dtype=f32, device=device),
            torch.zeros((batch, n_heads, dk), dtype=f32, device=device),
            torch.zeros((batch, n_heads), dtype=f32, device=device))


def init_mlstm_cache(batch: int, d_model: int, n_heads: int, device):
    c, n, m = init_mlstm_state(batch, n_heads, 2 * d_model // n_heads,
                               device)
    return {"c": c, "n": n, "m": m,
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen, d_model: int, n_heads: int, device,
               dtype=torch.bfloat16):
    dh = d_model // n_heads
    f32 = torch.float32
    return {
        "w_in": param(gen, (d_model, 4 * d_model), device, dtype),
        "r": param(gen, (n_heads, dh, 4 * dh), device, f32, scale=0.01),
        "b": param(gen, (4 * d_model,), device, f32, init="zeros"),
        "gn": param(gen, (d_model,), device, init="ones"),
        "w_out": param(gen, (d_model, d_model), device, dtype),
    }


def slstm_block(params, x, *, n_heads: int, ctx: CiMContext,
                cache: Optional[dict] = None):
    b, s, d = x.shape
    dh = d // n_heads
    u = cim_linear(x, params["w_in"], ctx, "w_in").to(torch.float32)
    state = (None if cache is None
             else (cache["c"], cache["n"], cache["h"], cache["m"]))
    hs, state = slstm_scan(u, params["r"],
                           params["b"].reshape(n_heads, 4 * dh), n_heads,
                           state)
    new_cache = None
    if cache is not None:
        new_cache = {"c": state[0], "n": state[1], "h": state[2],
                     "m": state[3], "pos": cache["pos"] + s}
    h = rms_norm(hs.reshape(b, s, d).to(x.dtype), params["gn"])
    return cim_linear(h, params["w_out"], ctx, "w_out"), new_cache


def init_slstm_cache(batch: int, d_model: int, n_heads: int, device):
    dh = d_model // n_heads

    def z():
        return torch.zeros((batch, n_heads, dh), dtype=torch.float32,
                           device=device)

    return {"c": z(), "n": z(), "h": z(), "m": z(),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}
