"""PyTorch port, the surrogate modes on shards (the mesh path's
`approx_gemm.surrogate_shard_matmul`, reached through `cim_linear`) on a
(2, 2) gloo mesh of four CPU processes, over qwen3-1.7b-smoke with the
JAX package's weights carried across, held to one device and to the JAX
package.

One device's surrogate route differs by device in both packages: the
fused kernel on the card (the port's `cim_gemm_fused`, the reference's
Pallas kernel on a TPU), the fake-quant XLA form on the CPU.  The route
on shards is the kernel's on every device (its wrappers run their plain
versions on CPU tensors), because only the kernel's exact integer sums
add up over K shards to one device's result.  So the port's one-device
result here is its card route run on CPU tensors (`_card_route`: the
fused entry admitted for the CPU), and the JAX package's is its kernel's
(the Pallas kernel in interpret mode) or, served, its CPU engine.

  * `cim_gemm_partial_plain`: D bitwise the JAX `cim_gemm_core`
    (interpret mode) on the same quantized shard, SQ from the halves'
    sums within rtol = atol = 3e-5 of its f32 SQ (tests/test_kernels.py's
    tolerance; the port's SQ is exact, rounded once);
  * the mesh `cim_linear` in `surrogate` mode, with and without a noise
    key, rank-reassembled, bitwise one device's for every smoke GEMM
    shape, both layouts, f32 and bf16; each rank's kernel saw only its
    K_l x N_l shard; the deterministic term within 2^-21 relative of the
    JAX kernel route's (XLA reorders the reference's epilogue, ROADMAP
    C); `surrogate_fast` within FAST_TOL of one device (its row-parallel
    product and noise sums are f32 sums over the shards);
  * the served surrogate ladder: the approximate lanes' logits bitwise
    the port's unsharded engine's (card route), every lane's logits
    within JAX_TOL = 4e-2 of the JAX unsharded engine's and its tokens
    equal above the top-2 gap (tests/test_torch_lm.py's tolerance and
    rule: the JAX engine's CPU route is the fake-quant bf16 product, and
    this random model's logits are nearly flat), the exact lane within
    EXACT_TOL of the
    unsharded engine (tests/test_torch_mesh_serving.py's); no plan after
    warmup; rank 0's dispatch MACs by family equal the unsharded
    engine's and the meters'; its Prometheus text parses;
  * `plan_gemm(mesh=...)` and `cim_matmul(mesh=...)` still refuse the
    float and surrogate modes.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import approx_gemm as jag
from repro.kernels import ops as jops
from repro.models.common import unbox
from repro.models.transformer import LM as JLM
from repro.serving import Request as JRequest
from repro.serving import SimClock as JSimClock
from repro.serving import build_engine as jbuild_engine
from repro.serving import build_tiers as jbuild_tiers
from repro_torch.configs import get_config
from repro_torch.core import approx_gemm as ag
from repro_torch.core.approx_gemm import NoiseKey
from repro_torch.kernels import cim_gemm, ref
from repro_torch.launch.mesh import spawn
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.common import cim_linear
from repro_torch.obs import EngineTelemetry
from repro_torch.parallel.sharding import P
from repro_torch.serving import Request, SimClock, build_engine, build_tiers

import _torch_mesh_ranks as ranks

ARCH = "qwen3-1.7b"
JAX_TOL = 4e-2
EXACT_TOL = 2e-2
# surrogate_fast on shards against one device: the same fake-quantized
# operands, a row-parallel product summed in f32 over the K shards and
# rounded once (one device's CPU bf16 product also accumulates in f32),
# the rank-1 variance's row and column sums of squares summed over the K
# shards in f32: a few f32 ulps of the variance, so within 2^-20 of the
# largest |out| (measured: 0 in f32 and bf16 at these shapes)
FAST_TOL = 2.0 ** -20
MODES = [("surrogate", None), ("surrogate", 11), ("surrogate_fast", None),
         ("surrogate_fast", 11)]
ENGINE = dict(slots_per_tier=4, max_len=32, prompt_buckets=(8,),
              group_buckets=(1, 2, 4), record_logits=True)
TIERS = ["exact", "balanced", "economy", "balanced", "exact", "economy"]


@contextlib.contextmanager
def _card_route():
    """One device's card route for surrogate mode, the fused kernel (its
    plain version), admitted for CPU tensors."""
    entry = ag._REGISTRY["cuda_fused_surrogate"]
    ag._REGISTRY[entry.name] = dataclasses.replace(
        entry, backends=("cuda", "cpu"))
    ag.clear_dispatch_caches()
    try:
        yield
    finally:
        ag._REGISTRY[entry.name] = entry
        ag.clear_dispatch_caches()


def _requests(req_cls, vocab):
    r = np.random.default_rng(3)
    return [req_cls(rid=i, prompt=r.integers(0, vocab, 8), max_new=3 + i % 2,
                    tier=t, arrival=float(i) * 0.01)
            for i, t in enumerate(TIERS)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config(ARCH, smoke=True)
    jp = JLM(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jp, jax.tree_util.tree_map(np.asarray, unbox(jp))


@pytest.fixture(scope="module")
def ranked(weights, tmp_path_factory):
    cfg = get_config(ARCH, smoke=True)
    return spawn(ranks.surrogate, 4, device="cpu", threads=1, timeout=300,
                 args=(ranks.smoke_gemms(cfg), MODES, ARCH,
                       build_tiers(mode="surrogate"),
                       weights[2], _requests(Request, cfg.vocab)),
                 workdir=str(tmp_path_factory.mktemp("surr")))


@pytest.fixture(scope="module")
def unsharded(weights):
    """The port's unsharded engine on the card route, with telemetry."""
    cfg = get_config(ARCH, smoke=True)
    tel = EngineTelemetry()
    try:
        with _card_route():
            eng = build_engine(cfg, params_from_numpy(weights[2], "cpu"),
                               tiers=build_tiers(mode="surrogate"),
                               device="cpu", telemetry=tel, **ENGINE)
            eng.warmup()
            mac0 = dict(tel.dispatch_macs.values)
            res = eng.run(_requests(Request, cfg.vocab), clock=SimClock())
            misses = eng.steady_plan_misses()
    finally:
        tel.detach()
    macs = {k: v - mac0.get(k, 0.0) for k, v in tel.dispatch_macs.values.items()}
    return ({i: (r.tier, r.tokens, [np.asarray(a) for a in r.logits])
             for i, r in res.items()}, misses, macs)


@pytest.fixture(scope="module")
def jax_served(weights):
    jcfg, jp, _ = weights
    eng = jbuild_engine(jcfg, jp, tiers=jbuild_tiers(mode="surrogate"),
                        **ENGINE)
    eng.warmup()
    res = eng.run(_requests(JRequest, jcfg.vocab), clock=JSimClock())
    return {i: (r.tokens, [np.asarray(a, np.float32) for a in r.logits])
            for i, r in res.items()}


def _reassembled(ranked, key, layout):
    return ranks.reassembled(ranked, "gemms", key, layout)


def _one_device(name, x, w, dt, mode, seed):
    from repro_torch.core.compiler import CiMConfig
    from repro_torch.models.common import CiMContext, CiMParams

    p = CiMParams.from_config(CiMConfig(family="appro42", mode=mode,
                                        compressor="orplane",
                                        n_approx_cols=10))
    ctx = CiMContext(p, key=None if seed is None else NoiseKey(seed))
    with _card_route():
        y = cim_linear(torch.from_numpy(x).to(dt), torch.from_numpy(w).to(dt),
                       ctx, name)
    return y.float().numpy()


# ---------------------------------------------------------------------------
# the partial's plain version against the JAX kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 32, 16), (33, 70, 17)], ids=str)
def test_partial_plain_matches_the_jax_core_on_a_quantized_shard(shape):
    m, k, n = shape
    rng = np.random.default_rng(m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    # the global scales of a tensor 1.5x this shard's range
    sx = torch.tensor(np.float32(np.abs(x).max() * 1.5 / 127))
    sw = torch.from_numpy((np.abs(w).max(axis=0) * 1.5 / 127).astype(
        np.float32))
    acc = cim_gemm.cim_gemm_partial(torch.from_numpy(x), torch.from_numpy(w),
                                    sx, sw, need_sq=True)
    assert acc.dtype == torch.int32 and acc.shape == (5, m, n)
    xq = ref.quantize_tile(torch.from_numpy(x), sx, 127).to(torch.int8)
    wq = ref.quantize_tile(torch.from_numpy(w), sw.reshape(1, -1),
                           127).to(torch.int8)
    jd, jsq = jops.cim_gemm_core(jnp.asarray(xq.numpy()),
                                 jnp.asarray(wq.numpy()), need_sq=True,
                                 interpret=True)
    assert np.array_equal(acc[0].numpy(), np.asarray(jd))
    sq = ref.sq_from_halves(acc[1:])
    np.testing.assert_allclose(sq.numpy(), np.asarray(jsq), rtol=3e-5,
                               atol=3e-5)
    assert torch.equal(sq, ref.square_dot(xq, wq))
    d_only = cim_gemm.cim_gemm_partial(torch.from_numpy(x),
                                       torch.from_numpy(w), sx, sw, False)
    assert torch.equal(d_only, acc[:1])


# ---------------------------------------------------------------------------
# the mesh cim_linear against one device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["col", "row"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("seed", [None, 11], ids=["deterministic", "noisy"])
def test_mesh_surrogate_linear_is_one_device_bitwise(ranked, layout, dt,
                                                     seed):
    cfg = get_config(ARCH, smoke=True)
    for name, x, w in ranks.smoke_gemms(cfg):
        got = _reassembled(ranked, (name, layout, str(dt), "surrogate",
                                    seed), layout)
        want = _one_device(name, x, w, dt, "surrogate", seed)
        assert np.array_equal(got, want), (name, layout, dt, seed)
        if seed is not None:
            assert not np.array_equal(got, _reassembled(
                ranked, (name, layout, str(dt), "surrogate", None), layout))


def test_each_rank_kernel_sees_only_its_shard(ranked):
    """The column-parallel layers launch the fused kernel on (K, N/2),
    the row-parallel ones the partial on (K/2, N): never a whole weight."""
    cfg = get_config(ARCH, smoke=True)
    shapes = {name: w.shape for name, _, w in ranks.smoke_gemms(cfg)}
    for o in ranked:
        seen = o["seen"]
        assert {n for n, _, _ in seen} == {"cim_gemm_fused",
                                           "cim_gemm_partial"}
        for kern, xs, ws in seen:
            k, n = ws
            assert (k, n) in {(kk, nn // 2) for kk, nn in shapes.values()} \
                if kern == "cim_gemm_fused" else \
                (k, n) in {(kk // 2, nn) for kk, nn in shapes.values()}
            assert xs == (4, k)


def test_mesh_surrogate_deterministic_term_matches_the_jax_kernel(ranked):
    """The reference's model frontend on its kernel route (the Pallas
    fused kernel in interpret mode), f32 operands: within 2^-21."""
    cfg = get_config(ARCH, smoke=True)
    mu, c0, c1 = (lambda p: (p.mu, p.c0, p.c1))(
        ranks._linear_ctx("surrogate", None, "wq", None).p)
    jgp = jag.GemmParams(family="appro42", bits=8, mode="surrogate", mu=mu,
                         c0=c0, c1=c1, compressor="orplane", n_approx_cols=10)
    plan = jag.GemmPlan(entry=jag._REGISTRY["pallas_fused_surrogate"],
                        block=(128, 128, 128), interpret=True, backend="cpu")
    kind, fwd, _ = jag._model_forward(jgp, plan, "rademacher", False, True,
                                      True)
    assert kind == "ste"
    for name, x, w in ranks.smoke_gemms(cfg):
        want = np.asarray(fwd(jnp.asarray(x), jnp.asarray(w)))
        for layout in ("col", "row"):
            got = _reassembled(ranked, (name, layout, str(torch.float32),
                                        "surrogate", None), layout)
            assert (np.abs(got - want) <= 2.0 ** -21 * np.abs(want)).all(), \
                (name, layout)


@pytest.mark.parametrize("layout", ["col", "row"])
@pytest.mark.parametrize("seed", [None, 11], ids=["deterministic", "noisy"])
def test_mesh_surrogate_fast_within_tolerance(ranked, layout, seed):
    cfg = get_config(ARCH, smoke=True)
    for dt in (torch.float32, torch.bfloat16):
        for name, x, w in ranks.smoke_gemms(cfg):
            got = _reassembled(ranked, (name, layout, str(dt),
                                        "surrogate_fast", seed), layout)
            want = _one_device(name, x, w, dt, "surrogate_fast", seed)
            tol = FAST_TOL * np.abs(want).max()
            if dt == torch.bfloat16:          # one bf16 rounding apart
                tol = max(tol, 2.0 ** -8 * np.abs(want).max())
            assert np.abs(got - want).max() <= tol, (name, layout, dt)


# ---------------------------------------------------------------------------
# the served surrogate ladder
# ---------------------------------------------------------------------------


def test_mesh_surrogate_ladder_serves_without_new_plans(ranked, unsharded):
    base, misses, _ = unsharded
    assert misses == 0
    for o in ranked:
        assert o["misses"] == 0
        assert sorted(o["served"]) == sorted(base)


def test_mesh_surrogate_lanes_bitwise_the_unsharded_engine(ranked,
                                                           unsharded):
    base = unsharded[0]
    worst = 0.0
    for o in ranked:
        for i, (tier, tokens, logits) in base.items():
            got_tier, got_tokens, got_logits = o["served"][i]
            assert got_tier == tier
            assert got_tokens == tokens, (tier, i)
            for a, b in zip(got_logits, logits):
                if tier == "exact":           # a float lane: allclose
                    worst = max(worst, float(np.abs(a - b).max()))
                else:
                    assert np.array_equal(a, b), (tier, i)
    assert worst <= EXACT_TOL


def test_mesh_surrogate_ladder_matches_the_jax_unsharded_engine(ranked,
                                                                jax_served):
    """tests/test_torch_lm.py's rule: up to a request's first differing
    token, every step's logits within JAX_TOL of the JAX engine's (its
    CPU route, the fake-quant bf16 product) and the same token wherever
    the JAX top-2 margin exceeds JAX_TOL; under that gap the port's
    logit at the JAX token within JAX_TOL of its largest.  The random
    smoke model's logits are nearly flat (|logits| ~0.1), so most steps
    fall under the gap, but not all."""
    checked, under_gap = ranks.check_against_jax(
        {i: ranked[0]["served"][i][1:] for i in jax_served}, jax_served,
        JAX_TOL)
    assert checked > 0, under_gap


def test_mesh_dispatch_macs_equal_the_unsharded_engine(ranked, unsharded):
    """Rank 0 (every rank) announces the global products: its serving
    run's `repro_dispatch_macs_total` by family equals the unsharded
    engine's exactly, and the meters' MACs."""
    macs = unsharded[2]
    assert sum(macs.values()) > 0
    for o in ranked:
        assert o["macs"] == macs
        assert o["meters"] == sum(macs.values())
    lines = [ln for ln in ranked[0]["prometheus"].splitlines()
             if ln.startswith("repro_dispatch_macs_total{")]
    assert lines and all(float(ln.rsplit(" ", 1)[1]) > 0 for ln in lines)


@pytest.mark.parametrize("mode", ["exact", "surrogate", "surrogate_fast"])
def test_mesh_plans_still_refuse_the_float_modes(mode):
    mesh = type("FakeMesh", (), {"shape": {"data": 2, "model": 2}})()
    with pytest.raises(ValueError, match="integer modes"):
        ag.plan_gemm("exact", mode, 8, 16, 64, 32, "cpu", mesh=mesh,
                     w_spec=P("model", None))
    with pytest.raises(ValueError, match="integer modes"):
        ag.cim_matmul(torch.zeros(16, 64), torch.zeros(64, 32),
                      ag.GemmParams(family="exact", mode=mode), mesh=mesh,
                      w_spec=P("model", None))
