"""Table IV: CNN classification accuracy under approximate multipliers,
on a CUDA device (or ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.table4_cnn [--device cpu] \\
        [--steps 220] [--n 256] [--mode both]

The paper evaluates pretrained ResNet-18 on ILSVRC2012; as the JAX
package's benchmark does, this trains the small residual CNN
(models/cnn.py) in float on structured synthetic images (220 SGD steps,
batch 64, lr 0.05, 16x16 images, seed 0), then evaluates it on shifted
images (noise 0.55, seed 123) under each multiplier family, two ways:

  * ``reference`` — the benchmark's own semantics (`evaluate`): every
    conv/fc matmul through the family's bit-exact LUT gather (the exact
    family as the QAT exact mode);
  * ``hardware`` — `cnn_forward` under a hardware-mode CiM context
    (`evaluate_hardware`): the implicit-GEMM conv kernels and the fused
    GEMM kernels the dispatch engine routes each family to.

It prints the Table IV rows of each (top-1, top-5, NMED, MRED, power
saving) and the claims line: Appro4-2 and Log-our hold accuracy, plain
Mitchell does not beat Log-our.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import energy_model as em
from repro_torch.core.approx_gemm import approx_matmul
from repro_torch.core.error_model import SurrogateModel, characterize
from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.data.pipeline import image_batch
from repro_torch.device import resolve_device
from repro_torch.models import cnn as cnn_mod
from repro_torch.models.cnn import cnn_forward, cnn_loss, init_cnn
from repro_torch.models.common import CiMContext, CiMParams

FAMS = ["exact", "appro42", "log_our", "mitchell"]
LR = 0.05


def sgd_step(params: Dict[str, torch.Tensor], batch,
             lr: float = LR) -> Tuple[Dict[str, torch.Tensor], float, float]:
    """One float SGD step on `cnn_loss` (no CiM): (new params, loss, acc)."""
    leaves = [t.detach().requires_grad_(True) for t in params.values()]
    named = dict(zip(params, leaves))
    loss, acc = cnn_loss(named, batch)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new = {k: v - lr * g for (k, v), g in zip(named.items(), grads)}
    return new, float(loss.detach()), float(acc)


def train_cnn(steps: int = 220, seed: int = 0, device=None):
    """The benchmark's float training run: (params, last loss, last
    accuracy)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = init_cnn(torch.Generator().manual_seed(seed), device=dev)
    loss = acc = float("nan")
    for _ in range(steps):
        xs, ys = image_batch(rng, 64, hw=16)
        batch = {"x": torch.from_numpy(xs).to(dev),
                 "y": torch.from_numpy(ys).to(dev)}
        params, loss, acc = sgd_step(params, batch)
    return params, loss, acc


def eval_images(n: int = 256, seed: int = 123, device=None):
    """The evaluation set under distribution shift (heavier noise than
    training): (x on `device`, labels as numpy)."""
    rng = np.random.default_rng(seed)
    xs, ys = image_batch(rng, n, hw=16, noise=0.55)
    return torch.from_numpy(xs).to(resolve_device(device)), ys


def top1_top5(logits: torch.Tensor, ys: np.ndarray) -> Tuple[float, float]:
    lg = logits.detach().float().cpu().numpy()
    top1 = float((lg.argmax(-1) == ys).mean())
    top5 = float(np.mean([y in np.argsort(-lg[i])[:5]
                          for i, y in enumerate(ys)]))
    return top1, top5


def _forward_family(params, x, fam: str):
    """Forward pass with every conv/fc matmul through the family's
    bit-exact LUT semantics (the benchmark's reference semantics)."""
    if fam == "exact":
        return cnn_forward(params, x, CiMContext(CiMParams(mode="exact",
                                                           bits=8)))
    spec = MultiplierSpec(fam, 8, signed=True)
    surro = SurrogateModel.exact(spec)

    def lut_linear(x2, w, ctx, name="", bias=None):
        out = approx_matmul(x2.to(torch.float32), w.to(torch.float32), spec,
                            surro, mode="bit_exact")
        return out if bias is None else out + bias

    orig = cnn_mod.cim_linear
    cnn_mod.cim_linear = lut_linear
    try:
        return cnn_forward(params, x, None)
    finally:
        cnn_mod.cim_linear = orig


def hardware_context(fam: str) -> CiMContext:
    return CiMContext(CiMParams(mode="hardware", family=fam, bits=8))


def evaluate(params, fam: str, n: int = 256, seed: int = 123):
    """(top-1, top-5) under the benchmark's reference semantics."""
    x, ys = eval_images(n, seed, params["b"].device)
    with torch.no_grad():
        return top1_top5(_forward_family(params, x, fam), ys)


def evaluate_hardware(params, fam: str, n: int = 256, seed: int = 123):
    """(top-1, top-5) of `cnn_forward` in hardware mode: the implicit-GEMM
    conv kernels and the fused GEMM kernels."""
    x, ys = eval_images(n, seed, params["b"].device)
    with torch.no_grad():
        return top1_top5(cnn_forward(params, x, hardware_context(fam)), ys)


def table_rows(results: Dict[str, Tuple[float, float]]) -> List[str]:
    """The Table IV rows: top-1, top-5, the multiplier's NMED and MRED, and
    the power saving at the paper's CNN operating point (32-bit fixed
    point: Appro4-2 17%, Log-our 64% in the paper; here the port's
    Table II model at 32 bits)."""
    rows = [f"{'family':>10} {'top1':>6} {'top5':>6} {'NMED':>10} "
            f"{'MRED':>10} {'power saving':>13}"]
    for fam, (top1, top5) in results.items():
        if fam == "exact":
            nmed = mred = save = 0.0
        else:
            m = characterize(MultiplierSpec(fam, 8))
            nmed, mred = m.nmed, m.mred
            save = 1 - em.system_power_w(fam, 32) / em.system_power_w(
                "exact", 32)
        rows.append(f"{fam:>10} {top1:>6.3f} {top5:>6.3f} {nmed:>10.2e} "
                    f"{mred:>10.2e} {save:>12.1%}")
    return rows


def claims(results: Dict[str, Tuple[float, float]]) -> bool:
    """Appro4-2 and Log-our hold accuracy (within 4 points of exact), and
    Mitchell does not beat Log-our by more than 2."""
    return (results["appro42"][0] >= results["exact"][0] - 0.04
            and results["log_our"][0] >= results["exact"][0] - 0.04
            and results["mitchell"][0] <= results["log_our"][0] + 0.02)


def run(steps: int = 220, n: int = 256, mode: str = "both", device=None):
    t0 = time.perf_counter()
    params, tloss, tacc = train_cnn(steps, device=device)
    print(f"Table IV reproduction — CNN trained to acc={tacc:.2f} "
          f"(loss {tloss:.3f}) on {params['b'].device}")
    evals = {"reference": evaluate, "hardware": evaluate_hardware}
    out = {}
    for name, fn in evals.items():
        if mode not in (name, "both"):
            continue
        results = {fam: fn(params, fam, n=n) for fam in FAMS}
        print(f"[{name} semantics, n={n}]")
        for row in table_rows(results):
            print(row)
        print(f"claims (appro42/log_our hold accuracy, LM degrades): "
              f"{claims(results)}")
        out[name] = results
    print(f"{time.perf_counter() - t0:.1f}s")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--steps", type=int, default=220)
    ap.add_argument("--n", type=int, default=256,
                    help="evaluation images")
    ap.add_argument("--mode", default="both",
                    choices=("reference", "hardware", "both"))
    args = ap.parse_args()
    run(args.steps, args.n, args.mode, args.device)


if __name__ == "__main__":
    main()
