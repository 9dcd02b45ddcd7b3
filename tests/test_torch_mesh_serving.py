"""PyTorch port, the serving engine's data-parallel slot pool on a (2, 2)
gloo mesh of four processes (the JAX package's DESIGN.md §11), on the
CPU, over qwen3-1.7b-smoke with the JAX package's weights carried across.

  * the reference's _SERVE_DP integer ladder (exact-family and log_our
    hardware lanes): every rank's logits bitwise equal to the port's
    unsharded engine's and its tokens identical; those tokens equal the
    JAX unsharded engine's, its logits within 4e-2 (test_torch_lm.py's
    tolerance for the integer tiers); no plan built after warmup on any
    rank;
  * the hardware ladder (exact = mode "exact", a float mode; balanced;
    economy): the integer lanes bitwise, the exact lane within EXACT_TOL
    of the unsharded engine (its tensor-parallel sums reassociate the
    f32 dot), with tokens equal.
"""

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.compiler import CiMConfig as JCiMConfig
from repro.models.common import unbox
from repro.models.transformer import LM as JLM
from repro.serving import Request as JRequest
from repro.serving import SimClock as JSimClock
from repro.serving import build_engine as jbuild_engine
from repro.serving.tiers import AccuracyTier as JTier
from repro_torch.configs import get_config
from repro_torch.core.compiler import CiMConfig
from repro_torch.launch.mesh import spawn
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import Request, SimClock, build_engine, build_tiers
from repro_torch.serving.tiers import AccuracyTier

import _torch_mesh_ranks as ranks

ARCH = "qwen3-1.7b"
JAX_TOL = 4e-2
# the exact lane's row-parallel layers: f32 partial products summed over
# the model axis and rounded to bf16 once, against one dot rounded once.
# On this CPU torch's bf16 matmul accumulates in f32 too and the two agree
# to the bit at this size (measured 0); an f32 order that moves one bf16
# rounding moves a fake-quantized code by a level, which two layers carry
# to the logits: a few 1e-3 when the partials were rounded to bf16 first
EXACT_TOL = 2e-2
ENGINE = dict(slots_per_tier=4, max_len=32, prompt_buckets=(8,),
              group_buckets=(1, 2, 4), record_logits=True)
TIERS_OF = {"serve_dp": ["exact", "economy", "exact", "economy", "exact"],
            "hardware": ["exact", "balanced", "economy", "balanced",
                         "exact"]}


def _serve_dp(tier_cls, cim_cls):
    """The reference's _SERVE_DP ladder: two integer-mode lanes."""
    return [tier_cls("exact", cim_cls(family="exact", bits=8,
                                      mode="hardware"), 0.0, 2.45e-12),
            tier_cls("economy", cim_cls(family="log_our", bits=8,
                                        mode="hardware"), 5e-3, 2.82e-12)]


def _requests(req_cls, vocab, tiers):
    r = np.random.default_rng(0)
    return [req_cls(rid=i, prompt=r.integers(0, vocab, 8), max_new=3,
                    tier=t, arrival=float(i) * 0.01)
            for i, t in enumerate(tiers)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config(ARCH, smoke=True)
    jp = JLM(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jp, jax.tree_util.tree_map(np.asarray, unbox(jp))


@pytest.fixture(scope="module")
def jax_serve_dp(weights):
    """The JAX package's unsharded engine on _SERVE_DP's workload."""
    jcfg, jp, _ = weights
    eng = jbuild_engine(jcfg, jp, tiers=_serve_dp(JTier, JCiMConfig),
                        **ENGINE)
    eng.warmup()
    res = eng.run(_requests(JRequest, jcfg.vocab, TIERS_OF["serve_dp"]),
                  clock=JSimClock())
    return {i: (r.tokens, [np.asarray(a, np.float32) for a in r.logits])
            for i, r in res.items()}


def _served(ladder_name, tree, workdir):
    """(the port's unsharded results, every rank's results)."""
    cfg = get_config(ARCH, smoke=True)
    ladder = (_serve_dp(AccuracyTier, CiMConfig)
              if ladder_name == "serve_dp" else build_tiers(mode="hardware"))
    reqs = _requests(Request, cfg.vocab, TIERS_OF[ladder_name])
    eng = build_engine(cfg, params_from_numpy(tree, "cpu"), tiers=ladder,
                       device="cpu", **ENGINE)
    eng.warmup()
    res = eng.run(reqs, clock=SimClock())
    base = {i: (r.tier, r.tokens, [np.asarray(a) for a in r.logits])
            for i, r in res.items()}
    assert eng.steady_plan_misses() == 0
    ranked = spawn(ranks.serve, 4, device="cpu", threads=1, timeout=300,
                   args=(ARCH, ladder, tree, reqs), workdir=str(workdir))
    return base, ranked


@pytest.fixture(scope="module")
def served_serve_dp(weights, tmp_path_factory):
    return _served("serve_dp", weights[2], tmp_path_factory.mktemp("dp"))


@pytest.fixture(scope="module")
def served_hardware(weights, tmp_path_factory):
    return _served("hardware", weights[2], tmp_path_factory.mktemp("hw"))


LADDERS = ["serve_dp", "hardware"]


@pytest.mark.parametrize("ladder", LADDERS)
def test_mesh_pool_serves_every_request_without_new_plans(request, ladder):
    base, ranked = request.getfixturevalue(f"served_{ladder}")
    assert len(base) == 5
    for out, misses, comm in ranked:
        assert sorted(out) == sorted(base)
        assert misses == 0
        assert comm > 0                       # the mesh path ran


@pytest.mark.parametrize("ladder", LADDERS)
def test_mesh_pool_integer_lanes_bitwise_equal_unsharded(request, ladder):
    base, ranked = request.getfixturevalue(f"served_{ladder}")
    for out, _, _ in ranked:
        for i, (tier, tokens, logits) in base.items():
            assert out[i][0] == tier
            assert out[i][1] == tokens, (ladder, i)
            if ladder == "hardware" and tier == "exact":
                continue                      # a float lane: next test
            for a, b in zip(out[i][2], logits):
                assert np.array_equal(a, b), (ladder, tier, i)


def test_mesh_pool_float_lane_within_tolerance(served_hardware):
    """The hardware ladder's exact lane (mode "exact") runs its
    tensor-parallel matmuls as f32 partial products summed over the
    model axis: allclose to the unsharded engine, tokens equal."""
    base, ranked = served_hardware
    worst = 0.0
    for out, _, _ in ranked:
        for i, (tier, tokens, logits) in base.items():
            if tier != "exact":
                continue
            assert out[i][1] == tokens
            for a, b in zip(out[i][2], logits):
                worst = max(worst, float(np.abs(a - b).max()))
    assert worst <= EXACT_TOL


def test_mesh_pool_tokens_equal_the_jax_unsharded_engine(served_serve_dp,
                                                         jax_serve_dp):
    _, ranked = served_serve_dp
    for out, _, _ in ranked:
        for i, (tokens, logits) in jax_serve_dp.items():
            assert out[i][1] == tokens, i
            for a, b in zip(out[i][2], logits):
                assert float(np.abs(a - b).max()) <= JAX_TOL
