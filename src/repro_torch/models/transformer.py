"""The dense LM of the port: stacks of global causal self-attention +
MLP layers (the ``qwen3-1.7b`` family and the other dense archs).

Entry points:
  * ``prefill``      — fills pre-allocated caches, returns last logits
  * ``decode_step``  — one token in, one token out, caches updated
  * ``forward_logits`` — full-sequence logits, no caches

The CiM context (the paper's approximate execution) threads through
every block.  The reference scans a stacked layer body; here the layers
are a Python list and the stack is a loop.  MoE, MLA, recurrent and
encoder layers and ``decode_multi`` are later slices.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import resolve_device

from . import config as C
from .attention import attention_block, init_attention, init_cache
from .common import (CiMContext, CiMParams, apply_mlp, apply_norm, init_mlp,
                     init_norm, param)
from .config import ModelConfig


def check_dense(cfg: ModelConfig) -> None:
    """This slice runs dense full-attention stacks only."""
    kinds = set(cfg.prefix_layers) | set(cfg.period)
    if (cfg.mla is not None or cfg.moe is not None or cfg.vision is not None
            or cfg.encoder is not None or not kinds <= {C.ATTN}
            or cfg.mtp_depth):
        raise NotImplementedError(
            f"arch {cfg.name!r} (layer kinds {sorted(kinds)}) needs layers "
            "of a later slice of the port; dense attention stacks only")


def _init_layer(gen, cfg: ModelConfig, device) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "norm1": init_norm(d, cfg.norm, device),
        "attn": init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim_, cfg.qkv_bias, cfg.qk_norm,
                               device),
        "norm2": init_norm(d, cfg.norm, device),
        "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, device),
    }


def _apply_layer(params, x, cfg: ModelConfig, ctx: CiMContext, positions,
                 cache, valid=None):
    """Returns (x, new_cache)."""
    h = apply_norm(params["norm1"], x, cfg.norm)
    a, new_cache = attention_block(
        params["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, rope_fraction=cfg.rope_fraction,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm, ctx=ctx,
        q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
        positions=positions, cache=cache, valid=valid)
    x = x + a
    h = apply_norm(params["norm2"], x, cfg.norm)
    return x + apply_mlp(params["mlp"], h, cfg.act, ctx), new_cache


class LM:
    """Dense LM on one device (CUDA unless ``device="cpu"``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        check_dense(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cim = CiMParams.from_config(cfg.cim)

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
        p["layers"] = [_init_layer(gen, cfg, dev)
                       for _ in range(cfg.n_layers)]
        return p

    # ---- helpers --------------------------------------------------------
    def _embed(self, params, tokens):
        return params["embed"][tokens]

    def _logits(self, params, x):
        x = apply_norm(params["final_norm"], x, self.cfg.norm)
        w = (params["embed"].T if self.cfg.tie_embeddings
             else params["head"])
        return x @ w

    def _run_stack(self, params, x, positions, caches, valid=None):
        ctx = CiMContext(self.cim)
        new = []
        for i, lp in enumerate(params["layers"]):
            c = None if caches is None else caches["layers"][i]
            x, c2 = _apply_layer(lp, x, self.cfg, ctx, positions, c, valid)
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
        cfg = self.cfg
        return {"layers": [init_cache(batch, max_len, cfg.n_kv_heads,
                                      cfg.head_dim_, self.device,
                                      per_slot=per_slot)
                           for _ in range(cfg.n_layers)]}

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

    def decode_step(self, params, caches, tokens, pos):
        """tokens: (B, 1); pos: scalar (lockstep: one position shared by
        the batch) or (B,) (slot pool: each row at its own position).
        The caches are updated in place and returned."""
        b = tokens.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
        positions = pos[:, None] if pos.dim() else pos.reshape(1, 1).expand(
            b, 1)
        x, caches = self._run_stack(params, self._embed(params, tokens),
                                    positions, caches)
        return self._logits(params, x), caches


def count_params(cfg: ModelConfig) -> int:
    """Analytic parameter count of a dense stack (embedding + head +
    layers, norms excluded as in the reference)."""
    d, ff = cfg.d_model, cfg.d_ff
    hd, h, kh = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    mlp = 3 * d * ff if cfg.act == "swiglu" else 2 * d * ff
    attn = d * hd * (h + 2 * kh) + h * hd * d
    return (cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
            + cfg.n_layers * (attn + mlp))
