"""The lane sentinel's shadow score at qwen3-1.7b's published widths, in
the JAX package and in the PyTorch port, on the CPU and on the same
seeded weights.

    PYTHONPATH=src python tests/drift_at_width.py [--layers 2] [--rounds 2]

Not a test (pytest collects no file of this name): it prints the clean
approximate lanes' drift from the exact reference at full width and a cut
depth, the reading chip_smoke.py's phase 12 takes on the card at all 28
layers, so that the two frameworks' readings can be set side by side.

For each approximate lane of the hardware ladder (balanced, economy) each
framework builds the lane (an LMLaneBackend over the lane's CiMConfig, 2
slots) and its sentinel (LaneSentinel over reference_lm: the exact rung
with per-token scales), admits the same two prompts (4-8 tokens from a
seed), and scores ``--rounds`` decode rounds as the engine does: the
sentinel's shadow logits for the lane's state, then the lane's own decode
round, then ``logit_drift`` over both slots.  It prints each round's
argmax agreement and logit NMED beside the sentinel's default thresholds,
and how far the two frameworks' logits are apart: the reference's and each
lane's after the prefill (the same inputs), and each round's, with whether
both lanes were fed the same tokens (each feeds its own greedy choice, so
a near-tie in the flat logits of seeded weights sends them apart).
The weights are the JAX LM's ``init(PRNGKey(0))``, carried into the port
with models/bridge.py."""

import argparse
import dataclasses
import time

import jax
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models.common import unbox
from repro.models.transformer import LM as JLM
from repro.serving import build_tiers as jbuild_tiers
from repro.serving import sentinel as jsen
from repro.serving.engine import LMLaneBackend as JLane
from repro_torch.configs import get_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import LM
from repro_torch.serving import build_tiers
from repro_torch.serving import sentinel as tsen
from repro_torch.serving.engine import LMLaneBackend

ARCH = "qwen3-1.7b"
LANES = ("balanced", "economy")
SLOTS, MAX_LEN, BUCKET = 2, 32, 8


def _cut(cfg, layers):
    return dataclasses.replace(cfg, n_layers=layers, n_periods=layers)


def _score(lane, sentinel, rounds):
    """(agreement, NMED, lane logits, the tokens fed) of each of `rounds`
    decode rounds, the shadow taken before the lane's own decode."""
    out = []
    for _ in range(rounds):
        fed = lane.slot_tokens.copy()
        ref = sentinel.shadow(lane)
        lane.decode_round()
        lg = np.asarray(lane.last_decode_logits, np.float32)
        agree, nmed = tsen.logit_drift(lg, ref, list(range(SLOTS)))
        out.append((agree, nmed, lg, fed))
    return out


def _gap(a, b) -> str:
    """How far two frameworks' logits are apart."""
    d = a - b
    return (f"max |d| {float(np.abs(d).max()):.4g} (max |logit| "
            f"{float(np.abs(a).max()):.4g}), RMS d / RMS logit "
            f"{float(np.sqrt((d * d).mean() / (a * a).mean())):.4g}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    torch.set_num_threads(4)
    jcfg = _cut(jget_config(ARCH), args.layers)
    cfg = _cut(get_config(ARCH), args.layers)
    t = time.perf_counter()
    jp = JLM(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, unbox(jp))
    params = params_from_numpy(tree, "cpu")
    del tree
    print(f"{ARCH}: d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {cfg.n_layers} of 28 layers; weights in "
          f"{time.perf_counter() - t:.1f}s", flush=True)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, (n,)) for n in
               rng.integers(4, BUCKET + 1, SLOTS)]
    jtiers = {t.name: t for t in jbuild_tiers(mode="hardware")}
    tiers = {t.name: t for t in build_tiers(mode="hardware")}
    scfg = tsen.SentinelConfig()
    jref = jsen.reference_lm(jcfg, jtiers["exact"].cim)
    ref = tsen.reference_lm(cfg, tiers["exact"].cim, "cpu")
    kw = dict(n_slots=SLOTS, max_len=MAX_LEN, prompt_buckets=(BUCKET,),
              group_buckets=(1, 2))
    exact = []
    for lm, lane_cls, p in ((jref, JLane, jp), (ref, LMLaneBackend, params)):
        lane = lane_cls(lm, p, **kw)
        with torch.inference_mode():
            lane.admit(prompts, list(range(SLOTS)))
        exact.append(np.asarray(lane.last_prefill_logits, np.float32))
        del lane
    print(f"  the sentinel's reference (exact, per-token scales): the "
          f"frameworks' prefill logits {_gap(*exact)}", flush=True)
    for name in LANES:
        env = tiers[name].nmed
        readings, prefill = {}, {}
        for fw, lm, lane_cls, sen_cls, p, reflm in (
                ("JAX", JLM(dataclasses.replace(
                    jcfg, cim=jtiers[name].cim)), JLane,
                 jsen.LaneSentinel, jp, jref),
                ("port", LM(dataclasses.replace(cfg, cim=tiers[name].cim),
                            "cpu"), LMLaneBackend, tsen.LaneSentinel,
                 params, ref)):
            t = time.perf_counter()
            lane = lane_cls(lm, p, **kw)
            lane.admit(prompts, list(range(SLOTS)))
            prefill[fw] = np.asarray(lane.last_prefill_logits, np.float32)
            with torch.inference_mode():
                readings[fw] = _score(lane, sen_cls(reflm, p, env),
                                      args.rounds)
            print(f"  {name} ({fw}, {time.perf_counter() - t:.1f}s): "
                  + "; ".join(f"round {i + 1} agreement {a:.3f}, NMED "
                              f"{m:.4f}"
                              for i, (a, m, _, _) in enumerate(readings[fw]))
                  + f" (trip at NMED > {scfg.nmed_threshold(env):.3g} or "
                  f"agreement < {scfg.min_agree:.3g})", flush=True)
            del lane
        rounds = "; ".join(
            f"round {i + 1} ("
            + ("the same tokens fed" if np.array_equal(a[3], b[3])
               else "other tokens fed") + f") {_gap(a[2], b[2])}"
            for i, (a, b) in enumerate(zip(readings["JAX"],
                                           readings["port"])))
        print(f"  {name}: the frameworks' lane logits after the prefill "
              f"{_gap(prefill['JAX'], prefill['port'])}; {rounds}",
              flush=True)


if __name__ == "__main__":
    main()
