"""PyTorch port, GEMM dispatch: routing by the operands' device, the
later-slice routes, the plan-miss counter, and the model/macro
frontends against the JAX package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.approx_gemm import GemmParams as JGemmParams
from repro.core.approx_gemm import model_matmul as j_model_matmul
from repro.core.approx_gemm import select_kernel as j_select
from repro_torch.core import approx_gemm as ag
from repro_torch.core.approx_gemm import (FAMILIES, MODES, GemmParams,
                                          cim_matmul, model_matmul,
                                          plan_misses, select_kernel)
from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.serving.tiers import build_tiers

ROUTES = {  # tier -> (cpu entry, cuda entry)
    "exact": ("torch_dot", "torch_dot"),
    "balanced": ("torch_lut_gather", "cuda_lut_gather"),
    "economy": ("torch_log", "cuda_log"),
}


@pytest.fixture(scope="module")
def ladder():
    return {t.name: t for t in build_tiers(mode="hardware")}


@pytest.mark.parametrize("tier", sorted(ROUTES))
@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_hardware_ladder_routing(ladder, tier, backend):
    cim = ladder[tier].cim
    e = select_kernel(cim.family, cim.mode, cim.bits, backend, spec=cim.spec)
    assert e.name == ROUTES[tier][backend == "cuda"]
    # a hardware GEMM on a CUDA tensor lands on a hand-written kernel
    assert e.cuda == (backend == "cuda" and cim.mode == "hardware")
    assert e.supports(cim.family, cim.mode, cim.bits, backend)


def test_routing_mirrors_reference_entries(ladder):
    """Same family routes as the reference's registry: the full-LUT
    gather for appro42/orplane/10, the log kernel for mitchell."""
    names = {"pallas_lut_gather": "lut_gather", "pallas_log": "log",
             "mxu_dot": "dot"}
    for t in ladder.values():
        cim = t.cim
        j = j_select(cim.family, cim.mode, cim.bits, backend="cpu",
                     spec=_jspec(cim.spec))
        tname = select_kernel(cim.family, cim.mode, cim.bits, "cuda",
                              spec=cim.spec).name
        assert tname.endswith(names[j.name])


def _jspec(spec):
    from repro.core.multipliers import MultiplierSpec as JSpec

    return JSpec(*dataclasses.astuple(spec))


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_nibble_and_surrogate_kernel_routes_raise(backend):
    exact = MultiplierSpec("exact", 8, True)
    with pytest.raises(NotImplementedError, match="later slice"):
        select_kernel("exact", "hardware", 8, backend, spec=exact)
    a4 = MultiplierSpec("appro42", 8, True, n_approx_cols=4)
    with pytest.raises(NotImplementedError, match="nibble"):
        select_kernel("appro42", "hardware", 8, backend, spec=a4)
    if backend == "cuda":
        with pytest.raises(NotImplementedError, match="surrogate"):
            select_kernel("log_our", "surrogate", 8, "cuda")
    else:
        assert select_kernel("log_our", "surrogate", 8,
                             "cpu").name == "torch_surrogate"


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mode", MODES)
def test_every_pair_routes_or_names_its_slice(family, mode):
    for backend in ("cpu", "cuda"):
        try:
            e = select_kernel(family, mode, 8, backend)
        except NotImplementedError as err:
            assert "later slice" in str(err)
            continue
        assert e.supports(family, mode, 8, backend)
        if mode == "hardware":
            assert e.cuda == (backend == "cuda")


def test_unroutable_requests_raise():
    with pytest.raises(ValueError, match="no kernel"):
        select_kernel("appro42", "hardware", 20, "cuda")
    with pytest.raises(ValueError, match="not in"):
        select_kernel("exact", "warp_drive", 8, "cpu")
    with pytest.raises(ValueError, match="backend"):
        select_kernel("exact", "exact", 8, "tpu")


def test_plan_misses_flat_on_repeated_shapes():
    gp = GemmParams(family="mitchell", bits=8, mode="hardware")
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((24, 10)).astype(np.float32))
    xs = [torch.from_numpy(rng.standard_normal((m, 24)).astype(np.float32))
          for m in (3, 5, 7, 3)]
    model_matmul(xs[0], w, gp)
    n0 = plan_misses()
    for x in xs:                      # all in the m <= 8 bucket
        model_matmul(x, w, gp)
    assert plan_misses() == n0
    model_matmul(torch.zeros((9, 24)), w, gp)     # a new bucket
    assert plan_misses() == n0 + 1


@pytest.mark.parametrize("family,mode", [("appro42", "hardware"),
                                         ("mitchell", "hardware"),
                                         ("log_our", "hardware"),
                                         ("exact", "exact"),
                                         ("appro42", "surrogate_fast")])
def test_model_matmul_matches_reference(family, mode):
    """model_matmul on bf16 activations against the JAX frontend, bit for
    bit (at this shape the reference's jitted x / (m / qmax) rewrite
    moves no quantized code)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 16)) * 0.05).astype(np.float32)
    kw = dict(family=family, bits=8, mode=mode, mu=-0.01)
    if family == "appro42":
        kw.update(compressor="orplane", n_approx_cols=10)
    jout = np.asarray(j_model_matmul(jnp.asarray(x, jnp.bfloat16),
                                     jnp.asarray(w, jnp.bfloat16),
                                     JGemmParams(**kw)), np.float32)
    tout = model_matmul(torch.from_numpy(x).to(torch.bfloat16),
                        torch.from_numpy(w).to(torch.bfloat16),
                        GemmParams(**kw))
    assert tout.dtype == torch.bfloat16 and tout.shape == (2, 5, 16)
    np.testing.assert_array_equal(tout.float().numpy(), jout)


def test_cim_matmul_and_ste_gradient():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((6, 20)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((20, 4)).astype(np.float32))
    x.requires_grad_(True)
    w.requires_grad_(True)
    for mode, fam in (("hardware", "appro42"), ("hardware", "mitchell"),
                      ("exact", "exact"), ("bit_exact", "log_our")):
        gp = GemmParams(family=fam, bits=8, mode=mode)
        out = cim_matmul(x, w, gp)
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
        g = torch.ones_like(out)
        gx, gw = torch.autograd.grad(out, (x, w), g)
        assert torch.allclose(gx, g @ w.detach().T)
        assert torch.allclose(gw, x.detach().T @ g)
    # bit_exact (plain gather oracle) == hardware (plain kernel version)
    gp_h = GemmParams(family="appro42", bits=8, mode="hardware")
    gp_b = dataclasses.replace(gp_h, mode="bit_exact")
    with torch.no_grad():
        assert torch.equal(cim_matmul(x, w, gp_h), cim_matmul(x, w, gp_b))


def test_later_slice_gemm_params_raise():
    with pytest.raises(NotImplementedError):
        GemmParams(family="exact", mode="hardware", per_token=True)


def test_entry_points_need_a_card_or_an_explicit_cpu():
    """No entry point falls back to the CPU when no card is present."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serving import build_engine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("qwen3-1.7b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_engine(cfg, tiers=build_tiers(families=("exact",)))
    assert LM(cfg, device="cpu").device.type == "cpu"


def test_registry_clear_keeps_routing():
    ag.clear_dispatch_caches()
    assert select_kernel("mitchell", "hardware", 8, "cuda").name == "cuda_log"


def test_macro_kernel_plan_routes_by_backend():
    from repro_torch.core.compiler import CiMConfig, compile_macro

    macro = compile_macro(CiMConfig(family="mitchell", mode="hardware"))
    assert macro.kernel_plan(4, 2048, 2048).entry.name == "cuda_log"
    assert macro.kernel_plan(4, 2048, 2048, backend="cpu").entry.name \
        == "torch_log"
    assert macro.gemm_params().mode == "hardware"
