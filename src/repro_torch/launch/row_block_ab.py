"""What the per-token lanes' row blocks cost, and which forms are row-pure.

A per-token float product (the exact rung with ``CiMConfig.per_token``,
the spec lane's verifier, and its LM head) runs as products of
``approx_gemm.ROW_BLOCK`` rows each (`approx_gemm.row_block_mm`), so that
a row's result does not depend on how many rows share the call.  This
script serves full-size ``qwen3-1.7b`` (seeded bf16 weights) on a
4-slot per-token exact lane and times, on the host clock (synchronized,
median of the reps), a prefill of 4 prompts of ``--prompt`` tokens in
one group, a decode round and a verify pass (`LM.decode_multi` over 5
positions a slot), once per form of that product:

* ``rows16``, ``rows64``, ``rows128``: `row_block_mm` with that block;
* ``bmm16``: one strided-batched product over (blocks, 16, K) against
  the weight expanded over the blocks (one launch);
* ``plain``: ``a @ b`` (not row-pure: the floor);

and the per-tensor exact lane beside them.  Then, for each form, it
holds the first 4 rows of an M-row product against a 4-row one at the
four LM (K, N) shapes and the LM head's, for M = 20, 72 and 4 x
``--prompt``: bitwise, or how many rows differ.

    PYTHONPATH=src python -m repro_torch.launch.row_block_ab --prompt 512

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.core import approx_gemm
from repro_torch.models import transformer
from repro_torch.models.transformer import LM
from repro_torch.serving import build_tiers
from repro_torch.serving.engine import LMLaneBackend

SHAPES = ((2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048))
FORMS = ("rows16", "rows64", "rows128", "bmm16", "plain")


def _bmm16(a, b):
    a2 = a.reshape(-1, a.shape[-1])
    m = a2.shape[0]
    pad = -m % 16
    if pad:
        a2 = F.pad(a2, (0, 0, 0, pad))
    nb = a2.shape[0] // 16
    out = torch.bmm(a2.reshape(nb, 16, -1), b.expand(nb, *b.shape))
    return out.reshape(-1, b.shape[-1])[:m].reshape(*a.shape[:-1],
                                                     b.shape[-1])


def _plain(a, b):
    return a @ b


def _use(form: str):
    """Make `form` the per-token float product everywhere it is bound."""
    fn = approx_gemm.row_block_mm
    if form.startswith("rows"):
        approx_gemm.ROW_BLOCK = int(form[4:])
    else:
        fn = _bmm16 if form == "bmm16" else _plain
    return fn


def _bind(fn):
    approx_gemm.row_block_mm = fn
    transformer.row_block_mm = fn


def _host_ms(fn, reps: int) -> float:
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t))
    return statistics.median(ts)


def _lane_times(cfg, params, cim, prompt: int, reps: int):
    lm = LM(dataclasses.replace(cfg, cim=cim), "cuda")
    lane = LMLaneBackend(lm, params, n_slots=4, max_len=prompt + 16,
                         prompt_buckets=(prompt,), group_buckets=(4,))
    g = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, cfg.vocab, (prompt,), generator=g).numpy()
               for _ in range(4)]

    def prefill():
        lane.reset()
        lane.admit(prompts, [0, 1, 2, 3])
    prefill()                                  # warm the plans
    pre = _host_ms(prefill, reps)
    dec = _host_ms(lane.decode_round, 3 * reps)
    toks = torch.randint(0, cfg.vocab, (4, 5), generator=g).to("cuda")

    def verify():
        fill = torch.as_tensor(lane.slot_pos, dtype=torch.int32,
                               device="cuda")
        clone = {"layers": [{n: t.clone() for n, t in c.items()}
                            for c in lane.caches["layers"]]}
        lm.decode_multi(params, clone, toks, fill)
    verify()
    ver = _host_ms(verify, 3 * reps)
    return pre, dec, ver


def _purity(fn, rows, vocab_w):
    out = []
    for k, n in SHAPES + ((vocab_w.shape[0], vocab_w.shape[1]),):
        g = torch.Generator(device="cuda").manual_seed(k + n)
        x = torch.randn(rows, k, generator=g, device="cuda").to(
            torch.bfloat16)
        w = (vocab_w if (k, n) == tuple(vocab_w.shape) else
             (torch.randn(k, n, generator=g, device="cuda") * 0.02).to(
                 torch.bfloat16))
        want = fn(x[:4], w)
        bad = []
        for m in (20, 72, rows):
            got = fn(x[:m], w)[:4]
            if not torch.equal(got, want):
                bad.append(f"M {m}: {int((got != want).any(1).sum())} of 4")
        out.append(f"({k}, {n}) " + ("bitwise" if not bad else
                                     "; ".join(bad)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prompt", type=int, default=512,
                    help="prompt tokens a slot for the prefill")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("row_block_ab.py needs a CUDA device")
    cfg = get_config("qwen3-1.7b")
    params = LM(cfg, "cuda").init(0)
    exact = next(t for t in build_tiers(mode="hardware")
                 if t.name == "exact").cim
    per_token = dataclasses.replace(exact, per_token=True)
    # the head as tied: (d_model, vocab), the embedding's transpose
    head = params["embed"].T
    print(f"qwen3-1.7b, 4 slots, prefill 4 x {args.prompt}, decode round "
          f"4 x 1, verify 4 x 5; host ms, median of {args.reps} "
          f"(prefill) / {3 * args.reps} (others)", flush=True)
    real = approx_gemm.row_block_mm
    block = approx_gemm.ROW_BLOCK
    for form in FORMS + ("per-tensor",):
        approx_gemm.ROW_BLOCK = block
        _bind(real)
        cim = exact
        if form != "per-tensor":
            _bind(_use(form))
            cim = per_token
        pre, dec, ver = _lane_times(cfg, params, cim, args.prompt,
                                    args.reps)
        line = (f"{form:<10} prefill {pre:8.1f} ms, decode round {dec:7.1f}"
                f" ms, verify {ver:7.1f} ms")
        if form != "per-tensor":
            line += "; rows: " + ", ".join(
                _purity(approx_gemm.row_block_mm, 4 * args.prompt, head))
        print(line, flush=True)
    approx_gemm.ROW_BLOCK = block
    _bind(real)


if __name__ == "__main__":
    main()
