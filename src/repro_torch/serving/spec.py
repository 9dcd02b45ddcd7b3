"""Cross-tier speculative decoding: the accuracy ladder as a speed ladder
(the JAX package's DESIGN.md §12).

The drafter is the same model over the same weights on a cheaper tier
(a lane pick, not a second network).  One call of a spec lane runs up to
`rounds_per_call` sub-rounds on the exact lane's slot pool, each:

  1. **draft** — k greedy `decode_step`s of the whole pool on the
     drafter tier, the argmax kept on the device.  The drafter writes its
     K/V into the shared pool at [fill, fill+k); every layer's ``pos`` is
     then reset to fill (`_reset_pos`): draft state is provisional.
  2. **verify** — one `LM.decode_multi` on the verifier tier scores
     [t_last, d_1..d_k], k+1 positions a slot.  The verifier runs
     per-token activation scales (``CiMConfig.per_token``), under which
     each row of the (B * (k+1))-row GEMMs is the row a single step
     computes; the pass overwrites the drafts' K/V at [fill, fill+k].
  3. **accept + roll back** — greedy targets g_i = argmax(verify
     logits); the agreeing prefix d_1..d_m and the bonus or correction
     token g_m are emitted, cut at the slot's remaining budget and at its
     first EOS, all on the device.  `_rollback` zeroes the (k+1)-entry
     window at [new_fill, new_fill+k+1) and sets ``pos`` to new_fill.

The sub-rounds chain on the device (the last token, the fill and the
budget carried as tensors); between them the call reads one flag, whether
any slot has budget left.  The drafted tokens never go to the host inside
a call; its greedy targets and counts go once at its end, the logits only
with `keep_logits`.

**Output:** every emitted token is a verifier argmax over exact-cache
context, so the emitted sequence is what greedy decoding on the verifier
tier gives, whatever the drafter says: the drafter sets the throughput
(the acceptance rate), never the output.  That holds as far as the
verify computes each row as a single step does.  The per-token GEMMs and
the LM head do so by construction: they run as products of
``approx_gemm.ROW_BLOCK`` rows each, whatever the pool's width.  The
attention einsums (float, batched over slots and kv heads) are
PyTorch's: on an H100 they matched the single step bitwise up to 8 slots
x 9 positions (chip_smoke.py phase 11 (b)); a width past that is
unchecked.

**On a mesh** (a data-parallel pool, serving/engine.py) each rank
drafts, verifies, accepts and rolls back its own slots: the drafter's
`decode_step` runs the pool's rows over the data axes (its per-tensor
scales are the whole pool's, as one device's) and keeps its own rows'
argmax, the verify `decode_multi` runs its own rows (the per-token rows
need no other), and the cache surgery is each rank's on its own caches.
What steers the shared engine goes over the data axes: whether any slot
has budget left (every rank runs the same sub-rounds, or the collectives
inside them would wait for a rank that stopped), whether every verify
logit was finite, and the greedy targets, counts, last tokens and fills
of every slot, which every rank's scheduler emits.

**Cache invariant:** pool entries at positions >= fill are zero (init,
prefill's zeroed pad rows, insert, decode writing at fill, and
`_rollback`).  It makes a rolled-back pool byte-equal to one that never
drafted; `nonzero_past_fill` counts what breaks it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .engine import LaneHealthError, LMLaneBackend


class SpecDecodeBackend(LMLaneBackend):
    """A slot-pool lane that decodes speculatively: the drafter tier
    guesses, the verifier tier (the per-token exact rung) scores all the
    guesses in one batched pass.  Prefill and insert run on the verifier
    (inherited), so admitted context is exact from the first token.

    `draft_ks` are the draft depths `warmup` runs, each once;
    `set_draft_k` switches between them and refuses any other (a depth
    not warmed would build GEMM plans in steady state).
    `rounds_per_call` sub-rounds run in one call (admission happens
    between calls, so a queued request waits up to R - 1 more rounds);
    `keep_logits=False` leaves the verify logits on the device
    (`last_spec_logits` stays None).  With `mesh` both LMs must be built
    on it (see the module docstring)."""

    def __init__(self, lm, drafter_lm, params, *, draft_k: int = 4,
                 draft_ks: Optional[Sequence[int]] = None,
                 rounds_per_call: int = 4, keep_logits: bool = True, **kw):
        if getattr(drafter_lm, "mesh", None) is not kw.get("mesh"):
            raise ValueError("the drafter's mesh must be the lane's")
        if not getattr(lm.cfg.cim, "per_token", False):
            raise ValueError(
                "the spec-decode verifier needs per_token=True activation "
                "scales (tiers.spec_pair builds its CiMConfig): a batched "
                "verify computes each row as a single step only when "
                "every row's scale is its own")
        if rounds_per_call < 1:
            raise ValueError("rounds_per_call must be >= 1")
        ks = set(int(k) for k in (draft_ks or (draft_k,))) | {int(draft_k)}
        if min(ks) < 1:
            raise ValueError("draft depth must be >= 1")
        super().__init__(lm, params, **kw)
        self.drafter_lm = drafter_lm
        self.rounds_per_call = int(rounds_per_call)
        self.keep_logits = bool(keep_logits)
        self.draft_ks = tuple(sorted(ks))
        self.draft_k = int(draft_k)
        self.last_spec_logits: Optional[np.ndarray] = None
        # acceptance counters (live slots only; warmup calls are idle)
        self.n_rounds = 0
        self.n_drafted = 0
        self.n_accepted = 0
        self.n_emitted = 0

    def set_draft_k(self, k: int) -> None:
        """Switch the draft depth to one of the warmed `draft_ks`."""
        if k not in self.draft_ks:
            raise ValueError(f"draft depth {k} was not pre-built by warmup; "
                             f"configured: {self.draft_ks}")
        self.draft_k = int(k)

    # -- one sub-round, on the device ---------------------------------------
    def _round(self, k, caches, tok, fill, remaining, eos):
        """Draft k, verify k + 1, accept, roll back.  Returns (caches,
        tok (B, 1), fill (B,), remaining (B,), g (B, k+1), a (B,),
        logits (B, k+1, V))."""
        c, t, p = caches, tok, fill
        dp = {"data_parallel": True} if self.mesh is not None else {}
        mine = slice(self.slot0, self.slot0 + self.n_local)
        drafts = []
        for _ in range(k):
            lg, c = self.drafter_lm.decode_step(self.params, c, t, p, **dp)
            if dp:
                lg = lg[mine]                  # the pool's: keep own rows
            t = torch.argmax(lg[:, -1, :].to(torch.float32), dim=-1)[:, None]
            drafts.append(t)
            p = p + 1
        drafts = torch.cat(drafts, dim=1)                      # (B, k)
        caches = _reset_pos(c, fill)
        logits, caches = self.lm.decode_multi(
            self.params, caches, torch.cat([tok, drafts], dim=1), fill,
            **dp)
        g = torch.argmax(logits.to(torch.float32), dim=-1)     # (B, k+1)
        # the agreeing prefix and the bonus / correction token, cut at the
        # budget and at the first EOS among them
        m = torch.cumprod((drafts == g[:, :k]).to(torch.int64),
                          dim=1).sum(dim=1)
        a = torch.minimum(m + 1, remaining)
        is_eos = (g == eos[:, None]) & (eos[:, None] >= 0)
        eos_pos = torch.argmax(is_eos.to(torch.int64), dim=1)  # first True
        a = torch.where(is_eos.any(dim=1) & (eos_pos < a), eos_pos + 1, a)
        caches = _rollback(caches, fill + a, k + 1)
        # the slot state of the next sub-round: last emitted token, fill,
        # budget (0 after an emitted EOS: the slot is done)
        last = torch.gather(g, 1, torch.clamp_min(a - 1, 0)[:, None])
        tok = torch.where((a > 0)[:, None], last, tok)
        emitted = torch.arange(k + 1, device=g.device)[None, :] < a[:, None]
        remaining = torch.where((is_eos & emitted).any(dim=1),
                                torch.zeros_like(remaining), remaining - a)
        return caches, tok, fill + a, remaining, g, a, logits

    def spec_round(self, remaining: np.ndarray,
                   eos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Up to `rounds_per_call` draft-k + verify sub-rounds for the whole
        pool in one call.

        `remaining[s]` is slot s's unfilled token budget (0: an idle row,
        which rides along and emits nothing); `eos[s]` its EOS id or -1.
        Returns (tokens (B, R, k+1), counts (B, R)): the engine emits
        tokens[s, r, :counts[s, r]] for each slot, in round order.  The
        call stops early once no slot has budget left (one sub-round
        always runs, so an idle call still drafts and rolls back)."""
        k, rounds, dev = self.draft_k, self.rounds_per_call, self.device
        mine = slice(self.slot0, self.slot0 + self.n_local)
        tok = torch.as_tensor(self.slot_tokens[mine, None], device=dev)
        fill = torch.as_tensor(self.slot_pos[mine].astype(np.int32),
                               device=dev)
        rem = torch.as_tensor(np.asarray(remaining, np.int64)[mine],
                              device=dev)
        eos_t = torch.as_tensor(np.asarray(eos, np.int64)[mine], device=dev)
        gs, as_, lgs = [], [], []
        with torch.inference_mode():
            finite = torch.ones((), dtype=torch.bool, device=dev)
            caches = self.caches
            for r in range(rounds):
                if r and not self._any(rem > 0):
                    break                       # every budget is spent
                caches, tok, fill, rem, g, a, lg = self._round(
                    k, caches, tok, fill, rem, eos_t)
                finite &= torch.isfinite(lg).all()
                gs.append(g)
                as_.append(a)
                if self.keep_logits:
                    lgs.append(lg.to(torch.float32))
            self.caches = caches
        n_exec = len(gs)
        # every slot's targets, counts, last token and fill (one exchange
        # each over the data axes on a mesh)
        g_all = self._pool(torch.stack(gs, dim=1))
        a_all = self._pool(torch.stack(as_, dim=1))
        g = np.zeros((self.n_slots, rounds, k + 1), np.int64)
        a = np.zeros((self.n_slots, rounds), np.int64)
        g[:, :n_exec] = g_all.cpu().numpy()
        a[:, :n_exec] = a_all.cpu().numpy()
        if self._any(~finite):
            raise LaneHealthError("the spec lane's verifier produced "
                                  "non-finite logits")
        self.last_spec_logits = None
        if self.keep_logits:
            lg = self._pool(torch.stack(lgs, dim=1)).cpu().numpy()
            self.last_spec_logits = np.zeros(
                (self.n_slots, rounds) + lg.shape[2:], np.float32)
            self.last_spec_logits[:, :n_exec] = lg
        self.slot_tokens = self._pool(tok[:, 0]).cpu().numpy().astype(
            np.int64)
        self.slot_pos = self._pool(fill).cpu().numpy().astype(np.int64)
        live = a > 0
        self.n_rounds += n_exec
        self.n_drafted += int(k * live.sum())
        self.n_accepted += int((a[live] - 1).sum())
        self.n_emitted += int(a.sum())
        return g, a

    # -- the pool's view on a mesh (identities on one device) ----------------
    def _pool(self, t: torch.Tensor) -> torch.Tensor:
        """Every slot's rows of a tensor of this rank's slots."""
        if self.mesh is None:
            return t
        return self.mesh.all_gather(t, self.lm.row_axes, 0)

    def _any(self, flags: torch.Tensor) -> bool:
        """Whether the flag is set anywhere in the pool (any of this
        rank's slots, or of another data rank's)."""
        if self.mesh is None:
            return bool(flags.any())
        hit = flags.any().to(torch.int32).reshape(1)
        return bool(self.mesh.all_reduce(hit, "max", self.lm.row_axes))

    @property
    def acceptance_rate(self) -> float:
        """The share of drafted tokens the verifier accepted."""
        return self.n_accepted / max(self.n_drafted, 1)

    @property
    def tokens_per_round(self) -> float:
        return self.n_emitted / max(self.n_rounds, 1)

    def warmup(self) -> int:
        """The inherited warmup (prefill shapes, the pool decode, reset),
        then one idle call at each configured draft depth, so a depth
        switch after warmup builds no plan.  The idle calls leave no live
        state: with every budget 0 each rollback wipes its own window."""
        n = super().warmup()
        zero = np.zeros(self.n_slots, np.int64)
        none = np.full(self.n_slots, -1, np.int64)
        k0 = self.draft_k
        for k in self.draft_ks:
            self.draft_k = k
            self.spec_round(zero, none)
            self.slot_tokens[:] = 0
            self.slot_pos[:] = 0
            n += 1
        self.draft_k = k0
        self.n_rounds = self.n_drafted = self.n_accepted = self.n_emitted = 0
        return n


# ---------------------------------------------------------------------------
# cache surgery on the port's layout: {"layers": [per-layer dict]}, a
# positional KV cache being a {"k", "v", "pos"} dict with (B, t, d) K/V
# and a (B,) pos
# ---------------------------------------------------------------------------


def _reset_pos(caches, fill: torch.Tensor):
    """Every layer's ``pos`` set to `fill` (its K/V untouched)."""
    out = []
    for layer in caches["layers"]:
        p = layer["pos"]
        out.append({**layer,
                    "pos": fill.to(p.dtype).expand(p.shape).clone()})
    return {**caches, "layers": out}


def _rollback(caches, new_fill: torch.Tensor, width: int):
    """Roll the pool back to `new_fill`: zero the `width`-entry window
    [new_fill, new_fill+width) of every K/V (in place; entries past the
    cache's end dropped) and set every ``pos`` to new_fill.

    A spec round dirties [old_fill, old_fill+width); new_fill >= old_fill
    and the entries >= old_fill were zero before it (the cache
    invariant), so zeroing the window at new_fill restores "entries >=
    fill are zero" exactly."""
    out = []
    for layer in caches["layers"]:
        k, v, p = layer["k"], layer["v"], layer["pos"]
        tpos = torch.arange(k.shape[1], device=k.device)[None, :]
        lo = new_fill.to(torch.int64)[:, None]
        win = ((tpos >= lo) & (tpos < lo + width))[:, :, None]   # (B, t, 1)
        k.masked_fill_(win, 0)
        v.masked_fill_(win, 0)
        out.append({**layer,
                    "pos": new_fill.to(p.dtype).expand(p.shape).clone()})
    return {**caches, "layers": out}


def nonzero_past_fill(caches, fill) -> int:
    """K/V entries at or past each slot's fill level that are not zero,
    over every layer: 0 while the cache invariant holds."""
    n = 0
    for layer in caches["layers"]:
        k, v = layer["k"], layer["v"]
        f = torch.as_tensor(np.asarray(fill), device=k.device)
        tpos = torch.arange(k.shape[1], device=k.device)[None, :]
        past = (tpos >= f.to(torch.int64)[:, None])[:, :, None]
        n = n + ((k != 0) & past).sum() + ((v != 0) & past).sum()
    return int(n)                  # one read of the device
