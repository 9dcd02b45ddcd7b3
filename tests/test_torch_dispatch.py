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
    """The nibble sub-LUT kernel and the fused surrogate kernel are
    ported, so neither route raises any more: a decomposable spec routes
    to the nibble kernel on either device (the CUDA kernel or its plain
    version), and surrogate mode to the fused surrogate kernel on the
    card and to the plain `torch_surrogate` route on the CPU, as the
    reference's CPU runs `xla_surrogate`."""
    pre = "cuda" if backend == "cuda" else "torch"
    exact = MultiplierSpec("exact", 8, True)
    assert select_kernel("exact", "hardware", 8, backend,
                         spec=exact).name == f"{pre}_lut_nibble"
    a4 = MultiplierSpec("appro42", 8, True, n_approx_cols=4)
    assert select_kernel("appro42", "hardware", 8, backend,
                         spec=a4).name == f"{pre}_lut_nibble"
    got = select_kernel("log_our", "surrogate", 8, backend)
    if backend == "cuda":
        assert got.name == "cuda_fused_surrogate" and got.cuda
    else:
        assert got.name == "torch_surrogate" and not got.cuda


# (family, n_approx_cols) -> the reference's route for a hardware GEMM
NIBBLE_ROUTES = [("exact", None, "pallas_lut_nibble"),
                 ("appro42", None, "pallas_lut_gather"),
                 ("appro42", 4, "pallas_lut_nibble"),
                 ("appro42", 2, "pallas_lut_nibble"),
                 ("mitchell", None, "pallas_log")]


@pytest.mark.parametrize("family,nac,ref_name", NIBBLE_ROUTES)
@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_nibble_routing_requires_decomposable_spec(family, nac, ref_name,
                                                   backend):
    """The nibble kernel outranks the full-LUT gather exactly when the
    spec's table factorizes into half-word sub-tables, as in the
    reference's registry (tests/test_dispatch.py); without a spec the
    predicate-gated entries are not eligible."""
    spec = MultiplierSpec(family, 8, True, n_approx_cols=nac)
    j = j_select(family, "hardware", 8, backend="cpu", spec=_jspec(spec))
    assert j.name == ref_name
    got = select_kernel(family, "hardware", 8, backend, spec=spec)
    pre = "cuda" if backend == "cuda" else "torch"
    assert got.name == f"{pre}_{ref_name[len('pallas_'):]}"
    assert got.cuda == (backend == "cuda")
    if family != "mitchell":
        assert select_kernel(family, "hardware", 8,
                             backend).name == f"{pre}_lut_gather"


@pytest.mark.parametrize("family,nac", [("exact", None), ("appro42", 4)])
def test_nibble_runners_bit_match_the_full_table(family, nac):
    """Both runners of the nibble entry (int and fused) equal the
    full-LUT gather's on a spec it routes."""
    rng = np.random.default_rng(3)
    xq = torch.from_numpy(rng.integers(-128, 128, (17, 40), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-128, 128, (40, 9), dtype=np.int8))
    gp = GemmParams(family=family, bits=8, mode="hardware",
                    n_approx_cols=nac)
    plan = ag.plan_gemm(family, "hardware", 8, 17, 40, 9, "cpu",
                        spec=gp.spec)
    assert plan.entry.name == "torch_lut_nibble"
    full = ag.GemmPlan(entry=ag._REGISTRY["torch_lut_gather"], backend="cpu")
    assert torch.equal(ag.run_int_kernel(plan, xq, wq, gp),
                       ag.run_int_kernel(full, xq, wq, gp))
    x = torch.from_numpy(rng.standard_normal((17, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((40, 9)).astype(np.float32))
    assert torch.equal(ag.FUSED_RUNNERS["torch_lut_nibble"](x, w, gp),
                       ag.FUSED_RUNNERS["torch_lut_gather"](x, w, gp))


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
    """Fault injection and per-token scales are ported: a fault is taken
    in the integer and exact modes and refused in the surrogate modes,
    which store no words to fault (tests/test_torch_faults.py)."""
    from repro_torch.core.faults import FaultConfig

    f = FaultConfig(p_sa0=0.01)
    assert GemmParams(family="exact", mode="hardware", fault=f).fault == f
    with pytest.raises(ValueError, match="integer storage"):
        GemmParams(family="exact", mode="surrogate", fault=f)
    assert GemmParams(family="exact", mode="hardware", per_token=True)


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


@pytest.mark.parametrize("mode", ["surrogate", "surrogate_fast"])
def test_surrogate_frontends_route_by_device(mode):
    """A surrogate GEMM's plan on the card runs the fused surrogate
    runner through both frontends (its kernel; here on CPU tensors, its
    plain version), on the CPU the plain torch_surrogate route;
    surrogate_fast takes the plain route everywhere.  The fused runner
    and the plain route agree on the deterministic term to f32 rounding
    (the kernel's D is exact, the plain route's dot a float sum)."""
    gp = GemmParams(family="log_our", bits=8, mode=mode, mu=0.013,
                    c0=0.0, c1=3.6e-4)
    plans = {b: ag.plan_gemm("log_our", mode, 8, 6, 32, 10, b)
             for b in ("cpu", "cuda")}
    assert plans["cpu"].entry.name == "torch_surrogate"
    assert plans["cuda"].entry.name == ("cuda_fused_surrogate"
                                        if mode == "surrogate"
                                        else "torch_surrogate")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((6, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 10)).astype(np.float32))
    card = ag._cim_core(gp, plans["cuda"])(x, w)
    cpu = ag._cim_core(gp, plans["cpu"])(x, w)
    assert torch.allclose(card, cpu, rtol=1e-5, atol=1e-5)
    model = ag._model_forward(gp, plans["cuda"], True)(x, w)
    assert torch.allclose(model, cpu, rtol=1e-5, atol=1e-5)
