"""Attention: blockwise (flash-style) prefill path and single-token decode
against a KV cache.  GQA via KV-head grouping; optional QKV bias
(qwen2.5), per-head q/k RMSNorm (qwen3), fractional RoPE (stablelm 0.25,
chatglm 0.5).

The score and value products are plain torch operations (the JAX
package left them to XLA).  `_chunked_attn` follows the reference's
online-softmax chunking step for step, not
`scaled_dot_product_attention`, so the two stay comparable to a stated
tolerance.

KV caches are updated IN PLACE (the reference returns new arrays): the
engine's slot pool owns one buffer per layer for its whole life, and the
returned cache dict holds the same tensors with the new fill level.
Writes at a slot past the cache end are dropped, as the reference's
``.at[...].set(..., mode="drop")`` drops them.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import CiMContext, apply_rope, cim_linear, param, rms_norm, \
    rope_tables

NEG_INF = -1e30


def init_attention(gen, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, qkv_bias: bool, qk_norm: bool, device,
                   dtype=torch.bfloat16):
    p = {
        "wq": param(gen, (d_model, n_heads * head_dim), device, dtype),
        "wk": param(gen, (d_model, n_kv_heads * head_dim), device, dtype),
        "wv": param(gen, (d_model, n_kv_heads * head_dim), device, dtype),
        "wo": param(gen, (n_heads * head_dim, d_model), device, dtype),
    }
    if qkv_bias:
        p["bq"] = param(gen, (n_heads, head_dim), device, dtype, init="zeros")
        p["bk"] = param(gen, (n_kv_heads, head_dim), device, dtype,
                        init="zeros")
        p["bv"] = param(gen, (n_kv_heads, head_dim), device, dtype,
                        init="zeros")
    if qk_norm:
        p["q_norm"] = param(gen, (head_dim,), device, dtype, init="ones")
        p["k_norm"] = param(gen, (head_dim,), device, dtype, init="ones")
    return p


def _project_qkv(params, x, n_heads, n_kv_heads, head_dim, ctx: CiMContext,
                 rope, qk_norm: bool):
    b, s, _ = x.shape
    q = cim_linear(x, params["wq"], ctx, "wq").reshape(b, s, n_heads,
                                                       head_dim)
    k = cim_linear(x, params["wk"], ctx, "wk").reshape(b, s, n_kv_heads,
                                                       head_dim)
    v = cim_linear(x, params["wv"], ctx, "wv").reshape(b, s, n_kv_heads,
                                                       head_dim)
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    return apply_rope(q, rope), apply_rope(k, rope), v


def _out_proj(params, o, ctx: CiMContext):
    b, s, h, dd = o.shape
    return cim_linear(o.reshape(b, s, h * dd), params["wo"], ctx, "wo")


def _pad_seq(t: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad dim 1 (the sequence axis) by n (any dtype, bool too)."""
    return torch.cat([t, t.new_zeros((t.shape[0], n) + tuple(t.shape[2:]))],
                     dim=1)


def _chunked_attn(q, k, v, q_chunk: int, kv_chunk: int, causal: bool,
                  window: Optional[int], q_offset: int, kv_len_valid: int,
                  seq_info=None):
    """Online-softmax blockwise attention.

    q: (B, Sq, H, D); k, v: (B, Skv, KH, D).  q_offset: absolute position
    of q[0] (for causal/window masks against the kv axis).
    kv_len_valid: number of valid kv positions.

    seq_info: optional (q_positions (B, Sq), kv_positions (B, Skv),
    kv_valid (B, Skv) bool) for ragged batches — per-sequence positions
    drive the causal/window masks and kv_valid masks pad tokens out.

    The q axis pads to a chunk multiple (a prime Sq must not shrink the
    chunk to one row); per-query online softmax is independent of the q
    chunking, so the sliced result equals the unpadded one bit for bit.
    """
    b, sq, h, dd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kh
    dev = q.device
    qpos_arr = kpos_arr = kval_arr = None
    if seq_info is not None:
        qpos_arr, kpos_arr, kval_arr = seq_info
    qc = min(q_chunk, sq)
    sq_out = sq
    pad_q = (-sq) % qc
    if pad_q:
        q = _pad_seq(q, pad_q)
        if seq_info is not None:       # padded queries: position 0 (their
            qpos_arr = _pad_seq(qpos_arr, pad_q)   # rows are sliced off)
        sq += pad_q
    kc = min(kv_chunk, skv)
    pad_kv = (-skv) % kc
    if pad_kv:
        kv_len_valid = min(kv_len_valid, skv)
        k = _pad_seq(k, pad_kv)
        v = _pad_seq(v, pad_kv)
        if seq_info is not None:       # padded keys: position 0, invalid
            kpos_arr = _pad_seq(kpos_arr, pad_kv)
            kval_arr = _pad_seq(kval_arr, pad_kv)
        skv += pad_kv
    nq, nk = sq // qc, skv // kc
    scale = 1.0 / (dd ** 0.5)

    qr = q.reshape(b, nq, qc, kh, g, dd)
    kr = k.reshape(b, nk, kc, kh, dd)
    vr = v.reshape(b, nk, kc, kh, dv)
    kv_pos = torch.arange(skv, device=dev).reshape(nk, kc)

    # local attention: only the last W kv chunks can be visible to a q
    # chunk; the ragged path visits every chunk (the window mask still
    # applies positionally)
    local = window is not None and causal and seq_info is None
    w_chunks = min(nk, (window + qc - 1) // kc + 1) if local else nk

    chunks = []
    for qi in range(nq):
        qb = qr[:, qi].to(torch.float32)           # (b, qc, kh, g, dd)
        if seq_info is None:
            qpos = q_offset + qi * qc + torch.arange(qc, device=dev)
        else:
            qpos_b = qpos_arr[:, qi * qc:(qi + 1) * qc]
        m = torch.full((b, kh, g, qc), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kh, g, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kh, g, qc, dv), dtype=torch.float32,
                          device=dev)
        for kj_rel in range(w_chunks):
            if local:
                last = (qi * qc + qc - 1) // kc
                kj = max(last - (w_chunks - 1) + kj_rel, 0)
            else:
                kj = kj_rel
            kb = kr[:, kj].to(torch.float32)
            vb = vr[:, kj].to(torch.float32)
            s = torch.einsum("bqkgd,bckd->bkgqc", qb, kb) * scale
            if seq_info is None:
                kp = kv_pos[kj]
                if causal:
                    mask = kp[None, :] <= qpos[:, None]
                else:
                    mask = torch.ones((qc, kc), dtype=torch.bool, device=dev)
                if window is not None:
                    mask = mask & (kp[None, :] > qpos[:, None] - window)
                mask = mask & (kp[None, :] < kv_len_valid)
                s = torch.where(mask[None, None, None], s, NEG_INF)
            else:
                kp = kpos_arr[:, kj * kc:(kj + 1) * kc]
                kval = kval_arr[:, kj * kc:(kj + 1) * kc]
                mask = kval[:, None, :]            # (b, qc, kc) per-seq
                if causal:
                    mask = mask & (kp[:, None, :] <= qpos_b[:, :, None])
                if window is not None:
                    mask = mask & (kp[:, None, :]
                                   > qpos_b[:, :, None] - window)
                s = torch.where(mask[:, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd",
                                                       p, vb)
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        chunks.append(o.permute(0, 3, 1, 2, 4).reshape(b, qc, kh * g, dv))
    return torch.cat(chunks, dim=1)[:, :sq_out]


def attention_block(params, x, *, n_heads, n_kv_heads, head_dim,
                    rope_fraction, rope_theta, qk_norm, ctx: CiMContext,
                    causal: bool = True, window: Optional[int] = None,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    positions=None, cache: Optional[dict] = None,
                    valid=None):
    """Full attention sub-block (projections + SDPA [+ cache update]).

    cache=None: training/scoring, returns (y, None).  s > 1 with a cache:
    prefill into the pre-allocated cache.  s == 1 with a cache: decode;
    cache["pos"] is a 0-dim tensor (lockstep batch) or (B,) (slot pool:
    every row at its own fill level).

    valid: optional (B, S) bool mask for ragged (right-padded) batches:
    pad tokens are masked out of the KV axis, `positions` supplies the
    per-sequence coordinates, and a prefilled cache records a per-slot
    (B,) fill level."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    rope = rope_tables(positions, head_dim, rope_fraction, rope_theta)
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim, ctx,
                           rope, qk_norm)
    seq_info = None
    if valid is not None and s > 1:
        seq_info = (positions, positions, valid)

    if cache is None:
        y = _chunked_attn(q, k, v, q_chunk, kv_chunk, causal, window,
                          q_offset=0, kv_len_valid=k.shape[1],
                          seq_info=seq_info)
        return _out_proj(params, y.to(x.dtype), ctx), None

    # caches store K/V flattened to (B, T, KH*D), as in the reference
    kh_d = n_kv_heads * head_dim
    ck, cv = cache["k"], cache["v"]
    t = ck.shape[1]
    if s > 1:  # prefill into a pre-allocated cache
        skv = k.shape[1]
        kf = k.reshape(b, skv, kh_d)
        vf = v.reshape(b, skv, kh_d)
        if valid is not None:
            # zero the pad rows: entries at/past each row's fill level
            # stay zero (attention never reads them)
            kf = torch.where(valid[:, :, None], kf, torch.zeros_like(kf))
            vf = torch.where(valid[:, :, None], vf, torch.zeros_like(vf))
        if skv <= t:
            ck[:, :skv] = kf.to(ck.dtype)
            cv[:, :skv] = vf.to(cv.dtype)
        else:  # ring buffer keeps the last t entries at slot p % t
            p0 = skv - t
            ck.copy_(torch.roll(kf[:, p0:].to(ck.dtype), p0 % t, dims=1))
            cv.copy_(torch.roll(vf[:, p0:].to(cv.dtype), p0 % t, dims=1))
        y = _chunked_attn(q, k, v, q_chunk, kv_chunk, causal, window,
                          q_offset=0, kv_len_valid=k.shape[1],
                          seq_info=seq_info)
        if valid is not None:
            # per-slot fill level: pad tokens don't count
            pos_out = valid.sum(dim=1).to(torch.int32)
        else:
            pos_out = torch.tensor(k.shape[1], dtype=torch.int32,
                                   device=x.device)
        new_cache = {"k": ck, "v": cv, "pos": pos_out}
        return _out_proj(params, y.to(x.dtype), ctx), new_cache

    # single-token decode
    pos = cache["pos"]
    per_slot = pos.dim() > 0
    slot = pos % t if window is not None else pos
    kf = k.reshape(b, kh_d).to(ck.dtype)
    vf = v.reshape(b, kh_d).to(cv.dtype)
    tpos = torch.arange(t, device=x.device)
    if per_slot:
        # out-of-range slots (an idle slot past max_len) are dropped:
        # such rows rewrite their own last entry unchanged
        bidx = torch.arange(b, device=x.device)
        ok = (slot < t)[:, None]
        sl = torch.clamp(slot, max=t - 1).to(torch.int64)
        ck[bidx, sl] = torch.where(ok, kf, ck[bidx, sl])
        cv[bidx, sl] = torch.where(ok, vf, cv[bidx, sl])
        if window is not None:
            age = (slot[:, None] - tpos[None, :]) % t
            kv_ok = age < torch.clamp(pos + 1, max=t)[:, None]
        else:
            kv_ok = tpos[None, :] <= pos[:, None]          # (B, t)
    else:
        # a start index past the end clamps, as dynamic_update_slice does
        sl = torch.clamp(slot, max=t - 1).to(torch.int64)
        ck.index_copy_(1, sl.reshape(1), kf[:, None])
        cv.index_copy_(1, sl.reshape(1), vf[:, None])
        if window is not None:
            age = (slot - tpos) % t
            kv_ok = age < torch.clamp(pos + 1, max=t)
        else:
            kv_ok = tpos <= pos
    new_cache = {"k": ck, "v": cv, "pos": pos + 1}
    kh = n_kv_heads
    g = n_heads // kh
    ck4 = ck.reshape(b, t, kh, head_dim)
    cv4 = cv.reshape(b, t, kh, head_dim)
    qg = q.reshape(b, 1, kh, g, head_dim).to(ck.dtype)
    # cache-dtype products, f32 softmax (as the reference)
    s_ = torch.einsum("bqkgd,btkd->bkgqt", qg, ck4).to(torch.float32) \
        / (head_dim ** 0.5)
    vmask = (kv_ok[:, None, None, None, :] if kv_ok.dim() == 2
             else kv_ok[None, None, None, None, :])
    s_ = torch.where(vmask, s_, NEG_INF)
    p = torch.softmax(s_, dim=-1).to(cv.dtype)
    o = torch.einsum("bkgqt,btkd->bkgqd", p, cv4)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, 1, n_heads, head_dim)
    return _out_proj(params, o.to(x.dtype), ctx), new_cache


def init_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
               device, window: Optional[int] = None,
               dtype=torch.bfloat16, per_slot: bool = False):
    """K/V stored flattened (B, T, KH*D).  per_slot=True allocates a (B,)
    fill-level vector instead of the 0-dim ``pos`` (the slot pool)."""
    t = min(max_len, window) if window is not None else max_len
    return {
        "k": torch.zeros((batch, t, n_kv_heads * head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, t, n_kv_heads * head_dim), dtype=dtype,
                         device=device),
        "pos": torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                           device=device),
    }
