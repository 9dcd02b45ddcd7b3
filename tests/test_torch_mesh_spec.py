"""PyTorch port, the per-token exact rung on shards: speculative decoding
and lane sentinels on a (2, 2) gloo mesh of four CPU processes, over
qwen3-1.7b-smoke with the JAX package's weights carried across, and the
mesh launcher's modes.

  * the lane's admit scatter and the spec lane's `_rollback` on a
    data-parallel, tensor-parallel pool byte-identical to one device's
    (the contract in the docstring of the JAX package's
    test_rollback_and_insert_on_host_mesh, which is red under JAX 0.9);
  * `_float_tp`'s per-token rows, in both layouts: each row of a batched
    call bitwise the row alone;
  * the per-token exact `cim_linear` on shards, rank-reassembled, for
    every smoke GEMM shape in both layouts, against the JAX package's
    per-token `model_matmul` and the port's one-device one: f32 within
    PT_TOL_F32 = 2^-20 of the largest |out| (the two float dots sum in
    other orders, tests/test_torch_spec_decode.py's tolerance; the
    row-parallel layout adds an f32 sum over the K shards; measured
    2^-21.4), bf16 within one bf16 rounding of the largest |out|,
    PT_TOL_BF16 = 2^-8 (measured 0), and in both dtypes the per-tensor
    product beyond the tolerance (measured at least 2^-7.2);
  * the mesh per-token exact engine's tokens and logits against the JAX
    package's unsharded per-token exact engine: within JAX_TOL = 4e-2
    under the top-2-gap rule (tests/test_torch_lm.py's; measured: the
    same tokens, logits within 2^-8, 6 steps above the gap);
  * the spec + sentinel engine on the hardware ladder (k = 2, period 2):
    its exact-lane tokens equal the mesh per-token exact engine's
    (DESIGN.md §12's contract), every rank the same tokens, trips and
    sentinel samples, no request failed, no plan after warmup;
  * the sentinel on fake lanes (a drifting lane, scripted reference
    rows): every rank's samples, trips and probes identical, and equal
    the unsharded engine's (the NMED and agreement within 1e-12: a sum
    over the data ranks, then a division, against one mean);
  * rank 0's telemetry on the per-token exact engine: dispatch MACs by
    family and the serving counters equal to the unsharded engine's;
  * launch/serve.py on the mesh in surrogate mode with --metrics -
    serves and prints the Prometheus text; --fault-rate and
    --spec-decode with --mesh are still refused.
"""

import argparse
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import approx_gemm as jag
from repro.models.common import unbox
from repro.models.transformer import LM as JLM
from repro.serving import Request as JRequest
from repro.serving import SimClock as JSimClock
from repro.serving import build_engine as jbuild_engine
from repro.serving import build_tiers as jbuild_tiers
from repro.serving.tiers import spec_pair as jspec_pair
from repro_torch.core import approx_gemm as ag
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import spawn
from repro_torch.models.bridge import params_from_numpy
from repro_torch.obs import EngineTelemetry
from repro_torch.serving import Request, SimClock, build_engine, build_tiers
from repro_torch.serving.tiers import spec_pair

import _torch_mesh_ranks as ranks

ARCH = "qwen3-1.7b"
JAX_TOL = 4e-2
PT_TOL_F32 = 2.0 ** -20
PT_TOL_BF16 = 2.0 ** -8
TIERS = ["exact", "balanced", "economy", "exact", "balanced", "exact"]
ENGINE = dict(slots_per_tier=4, max_len=32, prompt_buckets=(8,),
              group_buckets=(1, 2, 4))


def _requests(vocab, req_cls=Request):
    r = np.random.default_rng(4)
    return [req_cls(rid=i, prompt=r.integers(0, vocab, 8), max_new=4 + i % 3,
                    tier=t, arrival=float(i) * 0.01)
            for i, t in enumerate(TIERS)]


def _serve_args(argv):
    return tserve._parser().parse_args(argv)


SERVE_ARGV = ["--device", "cpu", "--mesh", "2", "--ranks", "4", "--mode",
              "surrogate", "--metrics", "-", "--n-requests", "4",
              "--max-new", "2", "4"]


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config(ARCH, smoke=True)
    jp = JLM(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jp, jax.tree_util.tree_map(np.asarray, unbox(jp))


@pytest.fixture(scope="module")
def ranked(weights, tmp_path_factory):
    cfg = get_config(ARCH, smoke=True)
    return spawn(ranks.spec, 4, device="cpu", threads=1, timeout=300,
                 args=(ARCH, weights[2], _requests(cfg.vocab),
                       _serve_args(SERVE_ARGV), ranks.smoke_gemms(cfg)),
                 workdir=str(tmp_path_factory.mktemp("spec")))


def test_admit_scatter_and_rollback_byte_identical_to_one_device(ranked):
    for o in ranked:
        assert o["insert_equal"], o["coords"]
        assert o["rollback_equal"], o["coords"]


def test_float_tp_per_token_rows_do_not_depend_on_other_rows(ranked):
    for o in ranked:
        assert o["row_pure"] == {"col": True, "row": True}, o["coords"]


@pytest.mark.parametrize("layout", ["col", "row"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
def test_mesh_per_token_exact_linear_matches_the_jax_model_matmul(ranked,
                                                                  layout,
                                                                  dt):
    cfg = get_config(ARCH, smoke=True)
    tol = PT_TOL_F32 if dt == torch.float32 else PT_TOL_BF16
    jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
    kw = dict(family="exact", bits=8, mode="exact")
    for name, x, w in ranks.smoke_gemms(cfg):
        got = ranks.reassembled(ranked, "pt_gemms",
                                (name, layout, str(dt), "exact", None),
                                layout)
        want = np.asarray(jag.model_matmul(
            jnp.asarray(x, jdt), jnp.asarray(w, jdt),
            jag.GemmParams(per_token=True, **kw)), np.float32)
        one = ag.model_matmul(torch.from_numpy(x).to(dt),
                              torch.from_numpy(w).to(dt),
                              ag.GemmParams(per_token=True, **kw))
        bound = tol * np.abs(want).max()
        assert np.abs(got - want).max() <= bound, (name, layout)
        assert np.abs(got - one.float().numpy()).max() <= bound, name
        # the per-tensor product is outside the tolerance
        per_tensor = np.asarray(jag.model_matmul(
            jnp.asarray(x, jdt), jnp.asarray(w, jdt),
            jag.GemmParams(per_token=False, **kw)), np.float32)
        assert np.abs(got - per_tensor).max() > bound, name


def test_mesh_per_token_exact_engine_matches_the_jax_engine(ranked,
                                                            weights):
    """The JAX package's unsharded engine on the verifier rung (the
    exact rung with per-token scales), the same requests on it."""
    jcfg, jp, _ = weights
    _, v_tier = jspec_pair(jbuild_tiers(mode="hardware"))
    eng = jbuild_engine(jcfg, jp, tiers=(v_tier,), record_logits=True,
                        **ENGINE)
    eng.warmup()
    res = eng.run([dataclasses.replace(r, tier="exact")
                   for r in _requests(jcfg.vocab, JRequest)],
                  clock=JSimClock())
    want = {i: (r.tokens, [np.asarray(a, np.float32) for a in r.logits])
            for i, r in res.items()}
    for o in ranked:
        checked, under_gap = ranks.check_against_jax(
            {i: (o["per_token"][i], o["per_token_logits"][i])
             for i in want}, want, JAX_TOL)
        assert checked > 0, under_gap


def test_mesh_spec_engine_tokens_equal_the_per_token_exact_engine(ranked):
    for o in ranked:
        assert o["spec_misses"] == 0
        assert all(status == "ok" for _, status, _ in o["spec"].values())
        on_exact = [i for i, (tier, _, _) in o["spec"].items()
                    if tier == "exact"]
        assert on_exact
        for i in on_exact:
            assert o["spec"][i][2] == o["per_token"][i], i
        assert o["accepted"][0] > 0          # the spec lane ran rounds
        assert o["checks"] and all(n > 0 for n in o["checks"].values())
    # the shared engine: every rank the same tokens, trips and samples
    for o in ranked[1:]:
        for key in ("spec", "trips", "checks", "accepted"):
            assert o[key] == ranked[0][key], key


def test_mesh_sentinel_decisions_equal_on_every_rank_and_unsharded(ranked):
    log, trips, results = ranks.fake_sentinel_run(None)
    # clean samples, a trip on drift, a probe that re-admits the lane
    assert trips and ("probe", True) in log
    assert any(e[0] == "sample" and not e[3] for e in log)
    for o in ranked:
        mlog, mtrips, mresults = o["fake"]
        assert mtrips == trips
        assert mresults == results
        assert len(mlog) == len(log)
        for a, b in zip(mlog, log):
            assert a[0] == b[0]
            if a[0] == "probe":
                assert a == b
            else:
                assert a[3] == b[3]                  # tripped or not
                np.testing.assert_allclose(a[1:3], b[1:3], rtol=1e-12)
    for o in ranked[1:]:
        assert o["fake"] == ranked[0]["fake"]


def test_mesh_telemetry_counters_equal_the_unsharded_engine(ranked,
                                                            weights):
    """The per-token exact engine (its schedule does not depend on the
    token values): every rank announces the global MACs, so its run's
    dispatch MACs by family equal the unsharded engine's, as do its
    token, request, decode-round and prefill counters."""
    cfg = get_config(ARCH, smoke=True)
    _, v_tier = spec_pair(build_tiers(mode="hardware"))
    tel = EngineTelemetry()
    try:
        eng = build_engine(cfg, params_from_numpy(weights[2], "cpu"),
                           tiers=(v_tier,), device="cpu", telemetry=tel,
                           **ENGINE)
        eng.warmup()
        mac0 = dict(tel.dispatch_macs.values)
        eng.run([dataclasses.replace(r, tier="exact")
                 for r in _requests(cfg.vocab)], clock=SimClock())
    finally:
        tel.detach()
    macs = {k: v - mac0.get(k, 0.0) for k, v in tel.dispatch_macs.values.items()}
    serving = {(m.name, k): v for m in (tel.tokens_c, tel.requests_c,
                                        tel.decode_rounds_c, tel.prefills_c)
               for k, v in m.values.items()}
    assert sum(macs.values()) > 0
    for o in ranked:
        assert o["macs"] == macs
        assert o["serving"] == serving


def test_mesh_launcher_serves_surrogate_and_refuses_the_rest(ranked,
                                                             monkeypatch):
    text = ranked[0]["launcher"]
    assert ranked[0]["launcher_ok"] and all(o["launcher_ok"] for o in ranked)
    assert "on mesh {'data': 2, 'model': 2}" in text
    assert "0 failed" in text and "plan misses after warmup 0" in text
    assert 'repro_dispatch_macs_total{bits="8",family="appro42"' in text
    assert all(o["launcher"] == "" for o in ranked[1:])    # rank 0 writes
    base = ["serve", "--device", "cpu", "--mesh", "2", "--ranks", "4",
            "--mode", "hardware"]
    for extra in (["--fault-rate", "0.01"], ["--spec-decode", "2"]):
        monkeypatch.setattr(sys, "argv", base + extra)
        with pytest.raises(SystemExit):
            tserve.main()
    assert isinstance(_serve_args(SERVE_ARGV), argparse.Namespace)
