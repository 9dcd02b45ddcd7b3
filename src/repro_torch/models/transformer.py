"""The LM of the port: stacks of global causal self-attention + MLP
layers (the ``qwen3-1.7b`` family and the other dense archs), or of
xLSTM blocks (``xlstm-125m``: mLSTM and sLSTM layers, no MLP, the
residual ``x + block(norm1(x))``).

Entry points:
  * ``prefill``      — fills pre-allocated caches, returns last logits
  * ``decode_step``  — one token in, one token out, caches updated
  * ``decode_multi`` — K tokens a sequence scored in one pass (the
                       speculative verifier, serving/spec.py): dense
                       attention stacks only
  * ``forward_logits`` — full-sequence logits, no caches

The CiM context (the paper's approximate execution) threads through
every block.  The reference scans a stacked layer body; here the layers
are a Python list (in ``cfg.layer_pattern`` order) and the stack is a
loop.  MoE, MLA, RG-LRU, local and encoder layers and mixed attention
and recurrent stacks are later slices (ROADMAP queue A 6).

Under a mesh (``LM(cfg, mesh=...)``, launch.mesh) the model is
tensor-parallel over the "model" axis: each rank holds its shards of the
layer weights (`param_layout`, the JAX init's logical specs resolved
under DECODE_RULES; models/bridge.shard_params cuts them), its heads'
slice of attention and of the KV caches, and every matmul runs through
`cim_linear`'s mesh path.  The embedding and the LM head stay whole on
every rank (the reference shards them on the vocabulary; whole, they
change no number, only memory).  `decode_step(data_parallel=True)` runs
this rank's rows of a pool split over the data axes and returns the
logits of the whole pool; `decode_multi(data_parallel=True)` returns
this rank's rows' logits.  Recurrent stacks run on one device only (the
reference's recurrent cache specs are a later slice).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.approx_gemm import row_block_mm
from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import (DECODE_RULES, P, axes_of,
                                           axes_size, batch_axes,
                                           logical_to_spec)

from . import config as C
from .attention import attention_block, init_attention, init_cache
from .common import (CiMContext, CiMParams, apply_mlp, apply_norm, init_mlp,
                     init_norm, param)
from .config import ModelConfig
from .xlstm import (init_mlstm, init_mlstm_cache, init_slstm,
                    init_slstm_cache, mlstm_block, slstm_block)

RECURRENT = (C.MLSTM, C.SLSTM)


def check_arch(cfg: ModelConfig) -> None:
    """The port runs stacks of global attention layers, or of xLSTM
    layers (mLSTM and sLSTM); the rest are later slices."""
    kinds = set(cfg.prefix_layers) | set(cfg.period)
    if (cfg.mla is not None or cfg.moe is not None or cfg.vision is not None
            or cfg.encoder is not None or cfg.mtp_depth
            or not (kinds <= {C.ATTN} or kinds <= set(RECURRENT))):
        raise NotImplementedError(
            f"arch {cfg.name!r} (layer kinds {sorted(kinds)}) needs layers "
            "of a later slice of the port; stacks of global attention or "
            "of xLSTM layers only")


def _init_layer(gen, kind: str, cfg: ModelConfig, device) -> Dict[str, Any]:
    d = cfg.d_model
    p: Dict[str, Any] = {"norm1": init_norm(d, cfg.norm, device)}
    if kind == C.MLSTM:
        p["rnn"] = init_mlstm(gen, d, cfg.n_heads, device)
    elif kind == C.SLSTM:
        p["rnn"] = init_slstm(gen, d, cfg.rnn.slstm_heads, device)
    else:
        p["attn"] = init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim_, cfg.qkv_bias, cfg.qk_norm,
                                   device)
        p["norm2"] = init_norm(d, cfg.norm, device)
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.act, device)
    return p


def layer_specs(cfg: ModelConfig) -> Dict[Tuple[str, str], Tuple]:
    """The logical specs of one layer's sharded parameters and the shapes
    they are given over, as the JAX package's init gives them (its
    attention weights head-shaped: a "heads" dim is cut by whole heads);
    norms, q/k norms, the embedding and the LM head stay whole."""
    d, h, kv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim_, cfg.d_ff)
    specs = {("attn", "wq"): (("embed", "heads", None), (d, h, hd)),
             ("attn", "wk"): (("embed", "heads", None), (d, kv, hd)),
             ("attn", "wv"): (("embed", "heads", None), (d, kv, hd)),
             ("attn", "wo"): (("heads", None, "embed"), (h, hd, d))}
    if cfg.qkv_bias:
        specs[("attn", "bq")] = (("heads", None), (h, hd))
        specs[("attn", "bk")] = (("heads", None), (kv, hd))
        specs[("attn", "bv")] = (("heads", None), (kv, hd))
    specs[("mlp", "wi")] = (("embed", "ff"), (d, ff))
    if cfg.act == "swiglu":
        specs[("mlp", "wg")] = (("embed", "ff"), (d, ff))
    specs[("mlp", "wo")] = (("ff", "embed"), (ff, d))
    return specs


def param_layout(cfg: ModelConfig, mesh,
                 rules=DECODE_RULES) -> Dict[Tuple[str, str], P]:
    """Each sharded layer parameter's partition spec over the port's
    tensor (the head-shaped (D, H, hd) / (H, hd, D) specs merged onto the
    flattened (D, H*hd) / (H*hd, D) weights: contiguous blocks of whole
    heads)."""
    out = {}
    for key, (logical, shape) in layer_specs(cfg).items():
        r = logical_to_spec(logical, shape, mesh, rules)
        if key in (("attn", "wq"), ("attn", "wk"), ("attn", "wv")):
            r = P(r[0], r[1])
        elif key == ("attn", "wo"):
            r = P(r[0], r[2])
        out[key] = r
    return out


# the cim_linear names of one layer's weights
_LINEARS = {("attn", "wq"): "wq", ("attn", "wk"): "wk", ("attn", "wv"): "wv",
            ("attn", "wo"): "wo", ("mlp", "wi"): "mlp_wi",
            ("mlp", "wg"): "mlp_wg", ("mlp", "wo"): "mlp_wo"}


def _apply_layer(params, x, kind: str, cfg: ModelConfig, ctx: CiMContext,
                 positions, cache, valid=None, heads=None, append=False):
    """Returns (x, new_cache); `heads` = this rank's (query, kv) heads.
    `append` routes the multi-token decode: attention layers only."""
    if append and kind != C.ATTN:
        raise ValueError(
            "multi-token (append) decode needs dense full-attention "
            f"layers with explicit positions; kind {kind!r} does not "
            "qualify")
    n_heads, n_kv = heads or (cfg.n_heads, cfg.n_kv_heads)
    h = apply_norm(params["norm1"], x, cfg.norm)
    if kind == C.MLSTM:
        a, new_cache = mlstm_block(params["rnn"], h, n_heads=cfg.n_heads,
                                   chunk=cfg.rnn.mlstm_chunk, ctx=ctx,
                                   cache=cache)
        return x + a, new_cache
    if kind == C.SLSTM:
        a, new_cache = slstm_block(params["rnn"], h,
                                   n_heads=cfg.rnn.slstm_heads, ctx=ctx,
                                   cache=cache)
        return x + a, new_cache
    a, new_cache = attention_block(
        params["attn"], h, n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=cfg.head_dim_, rope_fraction=cfg.rope_fraction,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm, ctx=ctx,
        q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
        positions=positions, cache=cache, valid=valid, append=append)
    x = x + a
    h = apply_norm(params["norm2"], x, cfg.norm)
    return x + apply_mlp(params["mlp"], h, cfg.act, ctx), new_cache


class LM:
    """Dense LM on one device (CUDA unless ``device="cpu"``), or one
    rank's part of a tensor-parallel LM on a mesh."""

    def __init__(self, cfg: ModelConfig, device=None, mesh=None):
        check_arch(cfg)
        if mesh is not None and set(cfg.layer_pattern) & set(RECURRENT):
            raise NotImplementedError(
                f"arch {cfg.name!r}: recurrent layers under a mesh need the "
                "reference's recurrent cache specs, a later slice of the "
                "port")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cim = CiMParams.from_config(cfg.cim)
        self.mesh = mesh
        self.specs = None                 # cim_linear name -> (K, N) spec
        self.heads = (cfg.n_heads, cfg.n_kv_heads)
        self.row_axes: Tuple[str, ...] = ()
        if mesh is not None:
            if self.cim.attn:
                raise ValueError(
                    "CiM attention under a mesh is not supported (the "
                    "reference keeps it off there): build the mesh lanes "
                    "without attn=True")
            layout = param_layout(cfg, mesh)
            self.specs = {_LINEARS[k]: v for k, v in layout.items()
                          if k in _LINEARS}
            nq = axes_size(mesh, axes_of(self.specs["wq"][1]))
            nkv = axes_size(mesh, axes_of(self.specs["wk"][1]))
            if nq != nkv:
                raise ValueError(
                    f"{cfg.name}: {cfg.n_heads} query heads and "
                    f"{cfg.n_kv_heads} kv heads split unevenly over the "
                    f"model axis ({dict(mesh.shape)}); the GQA map needs "
                    "both split alike")
            self.heads = (cfg.n_heads // nq, cfg.n_kv_heads // nkv)
            self.row_axes = batch_axes(mesh)

    def _mesh(self):
        return self.mesh if self.mesh is not None else contextlib.nullcontext()

    # ---- init -----------------------------------------------------------
    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights from a seeded generator on the model's device
        (N(0, 0.02^2) bf16 matrices, embed/head N(0, 0.01^2), unit norms)."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        p: Dict[str, Any] = {
            "embed": param(gen, (cfg.vocab, cfg.d_model), dev, scale=0.01),
            "final_norm": init_norm(cfg.d_model, cfg.norm, dev),
        }
        if not cfg.tie_embeddings:
            p["head"] = param(gen, (cfg.d_model, cfg.vocab), dev, scale=0.01)
        p["layers"] = [_init_layer(gen, kind, cfg, dev)
                       for kind in cfg.layer_pattern]
        return p

    # ---- helpers --------------------------------------------------------
    def _embed(self, params, tokens):
        return params["embed"][tokens]

    def _logits(self, params, x, data_parallel: bool = False):
        if data_parallel:               # the whole pool's rows, in order
            x = self.mesh.all_gather(x, self.row_axes, 0)
        x = apply_norm(params["final_norm"], x, self.cfg.norm)
        w = (params["embed"].T if self.cfg.tie_embeddings
             else params["head"])
        if self.cim.per_token:
            # row-pure like the per-token GEMMs: a slot's logits do not
            # depend on how many rows (slots x positions) share the pass
            return row_block_mm(x, w)
        return x @ w

    def _run_stack(self, params, x, positions, caches, valid=None,
                   data_parallel: bool = False, append: bool = False):
        ctx = CiMContext(self.cim, specs=self.specs,
                         row_axes=self.row_axes if data_parallel else ())
        new = []
        with self._mesh():
            for i, (lp, kind) in enumerate(zip(params["layers"],
                                               self.cfg.layer_pattern)):
                c = None if caches is None else caches["layers"][i]
                x, c2 = _apply_layer(lp, x, kind, self.cfg, ctx, positions,
                                     c, valid, self.heads, append)
                new.append(c2)
        return x, (None if caches is None else {"layers": new})

    # ---- scoring --------------------------------------------------------
    def forward_logits(self, params, tokens):
        """Full-sequence logits (B, S, V), no caches."""
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        x, _ = self._run_stack(params, self._embed(params, tokens),
                               positions, None)
        return self._logits(params, x)

    # ---- serving --------------------------------------------------------
    def init_caches(self, batch: int, max_len: int, per_slot: bool = False):
        """Caches of `batch` rows: per attention layer its KV cache for
        this rank's kv heads, per xLSTM layer its state.  Per-slot caches
        (ragged prefill, the slot pool) need every layer's state to carry
        an explicit position, which recurrent state does not: they raise,
        as the reference's ``_init_kind_cache``."""
        cfg = self.cfg
        out = []
        for kind in cfg.layer_pattern:
            if per_slot and kind != C.ATTN:
                raise ValueError(
                    "per-slot caches (ragged prefill / continuous batching) "
                    "need every layer's state to carry an explicit, non-ring "
                    f"position; kind {kind!r} does not")
            if kind == C.MLSTM:
                out.append(init_mlstm_cache(batch, cfg.d_model, cfg.n_heads,
                                            self.device))
            elif kind == C.SLSTM:
                out.append(init_slstm_cache(batch, cfg.d_model,
                                            cfg.rnn.slstm_heads, self.device))
            else:
                out.append(init_cache(batch, max_len, self.heads[1],
                                      cfg.head_dim_, self.device,
                                      per_slot=per_slot))
        return {"layers": out}

    def prefill(self, params, batch):
        """Fill pre-allocated caches; return (last-token logits, caches).

        batch: {"tokens": (B, S) int, optional "lengths": (B,) true prompt
        lengths of a right-padded batch, optional "max_len"}.  With
        lengths, per-sequence positions and a validity mask keep pad
        tokens out of attention, the logits are taken at each sequence's
        last real token, and the caches carry a per-slot (B,) fill level.
        """
        tokens = batch["tokens"]
        b, s = tokens.shape
        lengths = batch.get("lengths")
        caches = self.init_caches(b, batch.get("max_len", s),
                                  per_slot=lengths is not None)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        valid = None
        if lengths is not None:
            lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                      device=tokens.device)
            valid = positions < lengths[:, None]
        x, caches = self._run_stack(params, self._embed(params, tokens),
                                    positions, caches, valid=valid)
        if lengths is None:
            logits = self._logits(params, x[:, -1:])
        else:
            last = (lengths - 1).to(torch.int64)
            rows = torch.arange(b, device=tokens.device)
            logits = self._logits(params, x[rows, last][:, None])
        return logits, caches

    def decode_step(self, params, caches, tokens, pos,
                    data_parallel: bool = False):
        """tokens: (B, 1); pos: scalar (lockstep: one position shared by
        the batch) or (B,) (slot pool: each row at its own position).
        The caches are updated in place and returned.

        `data_parallel` (a mesh LM): the B rows are this rank's block of
        a pool split over the data axes (its caches' rows); the logits
        returned are the whole pool's, the same on every rank."""
        if data_parallel and self.mesh is None:
            raise ValueError("data_parallel decoding needs a mesh LM")
        b = tokens.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
        positions = pos[:, None] if pos.dim() else pos.reshape(1, 1).expand(
            b, 1)
        x, caches = self._run_stack(params, self._embed(params, tokens),
                                    positions, caches,
                                    data_parallel=data_parallel)
        return self._logits(params, x, data_parallel), caches

    def decode_multi(self, params, caches, tokens, pos,
                     data_parallel: bool = False):
        """Score K continuation tokens a sequence in one pass (the
        speculative-decoding verifier).

        tokens: (B, K); pos: scalar or (B,), the caches' fill level (the
        position of tokens[:, 0]).  Returns (logits (B, K, V), caches
        advanced by K, updated in place).  logits[:, i] is the next-token
        distribution after tokens[:, :i+1], what K sequential
        `decode_step` calls give; with per-token activation scales
        (``CiMConfig.per_token``) every GEMM row is computed as it would
        be alone.

        `data_parallel` (a mesh LM): the B rows are this rank's block of
        a pool split over the data axes, and so are the logits returned
        (a spec verify and a sentinel's shadow use their own slots')."""
        if data_parallel and self.mesh is None:
            raise ValueError("data_parallel decoding needs a mesh LM")
        b, kk = tokens.shape
        pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
        off = torch.arange(kk, dtype=torch.int32, device=tokens.device)
        positions = (pos[:, None] + off[None, :] if pos.dim()
                     else (pos + off).expand(b, kk))
        x, caches = self._run_stack(params, self._embed(params, tokens),
                                    positions, caches,
                                    data_parallel=data_parallel, append=True)
        return self._logits(params, x), caches


def _layer_params(kind: str, cfg: ModelConfig) -> int:
    d, ff = cfg.d_model, cfg.d_ff
    if kind == C.MLSTM:
        di = 2 * d
        return d * 2 * di + 3 * di * di + di * d
    if kind == C.SLSTM:
        nh = cfg.rnn.slstm_heads
        dh = d // nh
        return d * 4 * d + nh * dh * 4 * dh + d * d
    hd, h, kh = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    mlp = 3 * d * ff if cfg.act == "swiglu" else 2 * d * ff
    return d * hd * (h + 2 * kh) + h * hd * d + mlp


def count_params(cfg: ModelConfig) -> int:
    """Analytic parameter count (embedding + head + layers; norms, gate
    projections and biases excluded, as in the reference)."""
    return (cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
            + sum(_layer_params(k, cfg) for k in cfg.layer_pattern))
