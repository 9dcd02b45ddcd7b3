"""Lockstep generation launcher: prefill one batch of seeded prompts, then
greedy decode steps at one shared position (``LM.prefill`` and
``LM.decode_step`` with a scalar ``pos``) on each lane of the hardware
ladder (``build_tiers(mode="hardware")``), for xlstm-125m-smoke with
seeded weights, on a CUDA device (or ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.lockstep \\
        --device cpu --batch 2 --prompt 16 --max-new 4

This is the path of the recurrent stacks (xlstm-125m): their state has
no per-slot position, so the slot-pool engine (launch/serve.py) refuses
them, and they run lockstep, as the reference's consistency test drives
them.  Prints each lane's first row of tokens, its prefill time and its
decode-step time.  `generate` is the loop; chip_smoke.py drives it at
full size.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import LM
from repro_torch.serving import build_tiers


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32,
                    help="prompt length (tokens)")
    ap.add_argument("--max-new", type=int, default=8,
                    help="greedy decode steps")
    return ap


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(lm: LM, params, prompts: torch.Tensor, max_new: int):
    """Greedy lockstep decoding of `max_new` tokens (the prefill's, then
    one a decode step): (tokens (B, max_new), every step's logits finite,
    prefill s, decode s a step, the caches after the last step)."""
    dev = prompts.device
    with torch.inference_mode():
        _sync(dev)
        t = time.perf_counter()
        logits, caches = lm.prefill(params, {"tokens": prompts})
        _sync(dev)
        pre_s = time.perf_counter() - t
        finite = [torch.isfinite(logits).all()]
        toks = [logits[:, -1].argmax(-1, keepdim=True)]
        t = time.perf_counter()
        for i in range(max_new - 1):
            logits, caches = lm.decode_step(params, caches, toks[-1],
                                            prompts.shape[1] + i)
            finite.append(torch.isfinite(logits).all())
            toks.append(logits[:, -1].argmax(-1, keepdim=True))
        _sync(dev)
        dec_s = (time.perf_counter() - t) / (max_new - 1)
    return (torch.cat(toks, dim=1), bool(torch.stack(finite).all()), pre_s,
            dec_s, caches)


def main(argv=None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.max_new < 2:
        ap.error("--max-new must be at least 2 (the prefill's token and a "
                 "decode step)")
    device = resolve_device(args.device)
    cfg = get_config("xlstm-125m", smoke=True)
    params = LM(cfg, device=device).init(0)
    g = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt),
                            generator=g, device=device)
    print(f"{cfg.name} on {device}: batch {args.batch}, {args.prompt}-token "
          f"prompts, {args.max_new} new tokens, hardware ladder")
    for tier in build_tiers(mode="hardware"):
        lm = LM(dataclasses.replace(cfg, cim=tier.cim), device=device)
        toks, finite, pre_s, dec_s, _ = generate(lm, params, prompts,
                                                 args.max_new)
        print(f"  {tier.name:<9} prefill {1e3 * pre_s:.1f} ms, decode step "
              f"{1e3 * dec_s:.1f} ms ({args.batch / dec_s:.1f} tokens/s); "
              f"logits finite {finite}; row 0: {toks[0].tolist()}")


if __name__ == "__main__":
    main()
