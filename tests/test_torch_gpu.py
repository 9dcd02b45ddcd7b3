"""PyTorch port on the card: the CUDA kernels against their plain
versions, the wrappers' contract, and the serving path through the
kernels.  Each test decides inside its body whether a card is present
and skips without one; run them with `python -m pytest -m gpu tests/`."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.approx_gemm import GemmParams, model_matmul
from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.kernels import approx_matmul, mitchell_gemm, ops, ref

pytestmark = pytest.mark.gpu

SHAPES = [(4, 2048, 1024), (64, 2048, 2048), (33, 70, 17)]
BALANCED = MultiplierSpec("appro42", 8, True, "orplane", 10)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ops(m, k, n, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    xq = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-128, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    return x, w, xq, wq


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernels_bitwise_equal_plain_versions(shape):
    dev = _card()
    x, w, xq, wq = _ops(*shape, dev)
    lut = ops.lut_table(BALANCED, dev)
    sx, sw = ops._scales(x, w, 8)
    pairs = [
        (approx_matmul.lut_matmul(xq, wq, lut),
         ref.lut_matmul_ref(xq, wq, lut)),
        (approx_matmul.lut_matmul_fused(x, w, lut, sx, sw),
         approx_matmul.lut_matmul_fused_plain(x, w, lut, sx, sw))]
    for comp in (False, True):
        pairs += [
            (mitchell_gemm.mitchell_matmul(xq, wq, compensated=comp),
             ref.mitchell_matmul_ref(xq, wq, compensated=comp)),
            (mitchell_gemm.mitchell_matmul_fused(x, w, sx, sw,
                                                 compensated=comp),
             mitchell_gemm.mitchell_matmul_fused_plain(x, w, sx, sw,
                                                       compensated=comp))]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert torch.equal(got, want)


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _card()
    x, w, xq, wq = _ops(8, 64, 16, dev)
    lut = ops.lut_table(BALANCED, dev)
    with pytest.raises(ValueError, match="int8"):
        approx_matmul.lut_matmul(xq.int(), wq, lut)
    with pytest.raises(ValueError, match="contiguous"):
        mitchell_gemm.mitchell_matmul(xq, wq.t().contiguous().t())
    with pytest.raises(ValueError, match="table"):
        approx_matmul.lut_matmul(xq, wq, lut.int())
    with pytest.raises(ValueError, match="devices"):
        mitchell_gemm.mitchell_matmul(xq, wq.cpu())
    # below 8 bits: operands inside the table match the plain version,
    # and one outside it is refused before the kernel could read past it
    lut4 = ops.lut_table(MultiplierSpec("appro42", 4, True, "orplane"), dev)
    x4, w4 = xq // 16, wq // 16                   # [-8, 8)
    assert torch.equal(approx_matmul.lut_matmul(x4, w4, lut4, bits=4),
                       ref.lut_matmul_ref(x4, w4, lut4, bits=4))
    with pytest.raises(ValueError, match="lie in"):
        approx_matmul.lut_matmul(xq, w4, lut4, bits=4)


@pytest.mark.parametrize("family", ["appro42", "mitchell"])
def test_model_matmul_on_the_card_runs_the_kernel_and_equals_cpu(family):
    dev = _card()
    kw = dict(family=family, bits=8, mode="hardware")
    if family == "appro42":
        kw.update(compressor="orplane", n_approx_cols=10)
    gp = GemmParams(**kw)
    x, w, _, _ = _ops(16, 256, 96, dev, seed=3)
    kern = (approx_matmul if family == "appro42" else mitchell_gemm)
    name = ("lut_matmul_fused" if family == "appro42"
            else "mitchell_matmul_fused")
    before = kern.KERNELS[name].launches
    got = model_matmul(x.reshape(2, 8, 256), w, gp)
    assert kern.KERNELS[name].launches == before + 1
    want = model_matmul(x.cpu().reshape(2, 8, 256), w.cpu(), gp)
    assert torch.equal(got.cpu(), want)


def test_engine_serves_on_the_card_through_the_kernels():
    from repro_torch.configs import get_config
    from repro_torch.serving import (SimClock, build_engine, build_tiers,
                                     poisson_workload)

    _card()
    cfg = get_config("qwen3-1.7b", smoke=True)
    eng = build_engine(cfg, tiers=build_tiers(mode="hardware"),
                       slots_per_tier=2, max_len=32, prompt_buckets=(8,),
                       group_buckets=(1, 2))
    eng.warmup()
    counts = {n: k.launches for n, k in
              {**approx_matmul.KERNELS, **mitchell_gemm.KERNELS}.items()}
    wl = poisson_workload(6, 100.0, cfg.vocab, prompt_len=(4, 8),
                          max_new=(2, 5),
                          tier_mix=(("exact", None, .3),
                                    ("balanced", None, .4),
                                    ("economy", None, .3)), seed=1)
    res = eng.run(wl, clock=SimClock())
    for r in wl:
        assert len(res[r.rid].tokens) == r.max_new
    assert eng.steady_plan_misses() == 0
    assert approx_matmul.KERNELS["lut_matmul_fused"].launches > \
        counts["lut_matmul_fused"]
    assert mitchell_gemm.KERNELS["mitchell_matmul_fused"].launches > \
        counts["mitchell_matmul_fused"]
    assert dataclasses.is_dataclass(res[0])
    assert np.isfinite(eng.lanes["balanced"].backend.last_decode_logits).all()
