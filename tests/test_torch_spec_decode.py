"""PyTorch port, speculative decoding and per-token activation scales,
held against the JAX package on the CPU (qwen3-1.7b-smoke, the JAX
package's weights carried across with models/bridge.py, inputs from
numpy with a seed).

  * per-token `model_matmul` / `cim_matmul`: the integer modes (the int
    route, the (M, 1) per-row scale applied after the kernel) bitwise the
    reference's, and every row of a batched call bitwise the row alone;
    the exact mode within 2^-20 of |out| (torch's and XLA's f32 sums
    differ in order); the surrogate forms as the reference routes them
    (the model frontend's fake-quant form per row, the macro frontend per
    tensor) and the macro ignoring `per_token`;
  * `decode_multi` bitwise the port's own sequential `decode_step`s on a
    ragged pool (every op of the smoke model is row-pure on torch's CPU
    kernels), and within the exact lane's 1e-2 of the reference's;
  * the cache surgery against the reference's functions on the same data;
  * the spec engine: tokens equal to the per-token exact engine's at every
    draft depth, and to the reference's spec engine at one depth; an
    adversarial drafter; EOS inside the window; a rolled-back pool
    byte-equal to one that never drafted;
  * the contracts of `spec_pair`, the backend's constructor, the engine
    and the launcher, and the refusal of per-token scales under a mesh.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import approx_gemm as jag
from repro.models.common import unbox
from repro.models.transformer import LM as JLM
from repro.serving import SimClock as JSimClock
from repro.serving import build_engine as jbuild_engine
from repro.serving import build_tiers as jbuild_tiers
from repro.serving.spec import _reset_pos as j_reset_pos
from repro.serving.spec import _rollback as j_rollback
from repro_torch.configs import get_config
from repro_torch.core import approx_gemm as ag
from repro_torch.core.compiler import CiMConfig, compile_macro
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import LM
from repro_torch.serving import (Request, ServingEngine, SimClock,
                                 build_engine, build_tiers,
                                 poisson_workload, spec_pair)
from repro_torch.serving.engine import LMLaneBackend
from repro_torch.serving.spec import (SpecDecodeBackend, _reset_pos,
                                      _rollback, nonzero_past_fill)
from repro_torch.serving.tiers import TierRouter

ARCH = "qwen3-1.7b"
KS = (1, 2, 4, 8)
# the hardware lanes of the per-token GEMMs: balanced, economy and the
# nibble lane (appro42/orplane with 4 approximate columns)
LANES = {"balanced": dict(family="appro42", compressor="orplane",
                          n_approx_cols=10),
         "economy": dict(family="mitchell"),
         "balanced/4": dict(family="appro42", compressor="orplane",
                            n_approx_cols=4)}
ENGINE_KW = dict(slots_per_tier=2, max_len=32, prompt_buckets=(6,),
                 group_buckets=(1, 2), device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch ops, restored after it:
    they are small, and beside the other test workers torch's default
    pool (a thread a core) waits for cores those workers hold."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def models():
    cfg = jget_config(ARCH, smoke=True)
    jp = JLM(cfg).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, unbox(jp))
    return cfg, get_config(ARCH, smoke=True), jp, params_from_numpy(tree,
                                                                    "cpu")


def _pinned(rng, shape, axis):
    """Normal values whose max |v| along `axis` is exactly 127 * 2^e, so
    every per-row (axis -1) or per-column (axis 0) scale is a power of two
    and the reference's jitted x / (m / qmax) rewrite moves no code."""
    v = rng.standard_normal(shape).astype(np.float32)
    e = rng.integers(-6, -2, size=np.max(v, axis=axis, keepdims=True).shape)
    scale = (127.0 * 2.0 ** e).astype(np.float32)
    return v / np.abs(v).max(axis=axis, keepdims=True) * scale


def _gemm_operands(m=20, k=48, n=16, seed=3):
    rng = np.random.default_rng(seed)
    return _pinned(rng, (m, k), -1), _pinned(rng, (k, n), 0)


# ---------------------------------------------------------------------------
# per-token GEMMs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frontend", ["model", "cim"])
@pytest.mark.parametrize("lane", ["balanced", "economy", "balanced/4",
                                  "bit_exact"])
def test_per_token_integer_gemm_is_the_reference_and_row_pure(frontend,
                                                              lane):
    """A per-token integer GEMM takes the int route (the fused runners
    carry one scalar sx): quantize per row, the int kernel, then
    (acc * sx) * sw with the (M, 1) sx, bitwise the reference's; every
    row of the 20-row call is bitwise that row in a 4-row call."""
    kw = (dict(family="appro42", compressor="orplane", n_approx_cols=10,
               mode="bit_exact") if lane == "bit_exact"
          else dict(LANES[lane], mode="hardware"))
    x, w = _gemm_operands()
    dt = torch.bfloat16 if frontend == "model" else torch.float32
    jdt = jnp.bfloat16 if frontend == "model" else jnp.float32
    tf = ag.model_matmul if frontend == "model" else ag.cim_matmul
    jf = jag.model_matmul if frontend == "model" else jag.cim_matmul
    gp = ag.GemmParams(bits=8, per_token=True, **kw)
    xt, wt = torch.from_numpy(x).to(dt), torch.from_numpy(w).to(dt)
    got = tf(xt, wt, gp)
    want = np.asarray(jf(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                         jag.GemmParams(bits=8, per_token=True, **kw)),
                      np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    rows = torch.cat([tf(xt[i:i + 4], wt, gp) for i in range(0, 20, 4)])
    assert torch.equal(rows, got)
    # the int route by hand: per-row codes, the int kernel, the epilogue
    plan = ag.plan_gemm(gp.family, gp.mode, 8, 20, 48, 16, "cpu",
                        spec=gp.routing_spec)
    xq, sx, wq, sw = ag._quantize_operands(xt.float(), wt.float(), 8, True)
    assert sx.shape == (20, 1)
    acc = ag.run_int_kernel(plan, xq, wq, gp)
    assert torch.equal(((acc.float() * sx) * sw).to(dt), got)
    # and not the per-tensor result
    assert not torch.equal(tf(xt, wt, dataclasses.replace(
        gp, per_token=False)), got)


@pytest.mark.parametrize("frontend", ["model", "cim"])
def test_per_token_exact_gemm_matches_reference(frontend):
    """The exact mode quantizes x per row (fake-quant in the model
    frontend, codes in the macro's): f32 operands, within 2^-20 of |out|
    of the reference (the two float dots sum in other orders), and
    row-pure."""
    x, w = _gemm_operands(seed=5)
    tf = ag.model_matmul if frontend == "model" else ag.cim_matmul
    jf = jag.model_matmul if frontend == "model" else jag.cim_matmul
    gp = ag.GemmParams(family="exact", bits=8, mode="exact", per_token=True)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = tf(xt, wt, gp)
    want = np.asarray(jf(jnp.asarray(x), jnp.asarray(w), jag.GemmParams(
        family="exact", bits=8, mode="exact", per_token=True)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2.0 ** -20 * np.abs(want).max())
    rows = torch.cat([tf(xt[i:i + 4], wt, gp) for i in range(0, 20, 4)])
    assert torch.equal(rows, got)


def test_per_token_surrogate_routes_as_the_reference():
    """The reference's surrogate branches: the model frontend's fake-quant
    form (its CPU route, xla_surrogate) quantizes x per row, the macro
    frontend's dequantized dot per tensor, whatever `per_token` says; the
    port's CPU routes compute the same, bitwise (on the card the fused
    surrogate kernel takes one scalar sx, as the reference's Pallas
    kernel does: tests/test_torch_gpu.py)."""
    x, w = _gemm_operands(seed=7)
    kw = dict(family="appro42", bits=8, mode="surrogate", mu=-0.01,
              compressor="orplane", n_approx_cols=10)
    gp = ag.GemmParams(per_token=True, **kw)
    jgp = jag.GemmParams(per_token=True, **kw)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = ag.model_matmul(xb, wb, gp)
    want = np.asarray(jag.model_matmul(jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(w, jnp.bfloat16), jgp),
                      np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not torch.equal(got, ag.model_matmul(
        xb, wb, dataclasses.replace(gp, per_token=False)))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = ag.cim_matmul(xt, wt, gp)
    assert torch.equal(got, ag.cim_matmul(
        xt, wt, dataclasses.replace(gp, per_token=False)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jag.cim_matmul(
        jnp.asarray(x), jnp.asarray(w), jgp)))


@pytest.mark.parametrize("m", [3, 64, 70, 130])
def test_per_token_float_products_run_in_row_blocks(m):
    """A per-token float product runs as ROW_BLOCK-row products (the last
    padded with zeros), so on the card a row's result does not depend on
    M; on the CPU it equals the one product."""
    rng = np.random.default_rng(m)
    a = torch.from_numpy(rng.standard_normal((m, 24)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((24, 8)).astype(np.float32))
    shapes = []
    real = torch.Tensor.__matmul__

    def spy(x, y):
        shapes.append(tuple(x.shape))
        return real(x, y)
    torch.Tensor.__matmul__ = spy
    try:
        got = ag.row_block_mm(a.reshape(1, m, 24), b)
    finally:
        torch.Tensor.__matmul__ = real
    assert got.shape == (1, m, 8)
    assert shapes == [(ag.ROW_BLOCK, 24)] * -(-m // ag.ROW_BLOCK)
    torch.testing.assert_close(got[0], a @ b, rtol=0, atol=1e-5)


def test_macro_and_attention_leave_per_token_out():
    """`CiMMacro.gemm_params` does not pass `per_token` on (the
    reference's neither), and CiM attention refuses a per-token
    GemmParams, as `cim_attention` does."""
    macro = compile_macro(CiMConfig(family="appro42", mode="hardware",
                                    per_token=True))
    assert not macro.gemm_params().per_token
    x, w = _gemm_operands(seed=9)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(macro.matmul(xt, wt), ag.cim_matmul(
        xt, wt, dataclasses.replace(macro.gemm_params(), per_token=False)))
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="per_token"):
        ag.cim_attention(q, q, q, ag.GemmParams(
            family="appro42", mode="hardware", per_token=True))


def test_per_token_matmul_under_a_mesh_raises():
    """On shards the integer and surrogate routes take global per-tensor
    scales, so an applied approximate per-token matmul raises rather than
    compute another result (only the exact rung, the spec verifier's and
    the sentinel's reference, runs per-token scales there:
    tests/test_torch_mesh_spec.py); the mesh frontends refuse it too."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.common import CiMContext, CiMParams, cim_linear
    from repro_torch.parallel.sharding import P

    p = CiMParams.from_config(CiMConfig(family="exact", mode="exact",
                                        per_token=True))
    assert p.per_token and p.routing("wq")[0].per_token
    x, w = torch.zeros(2, 8), torch.zeros(8, 4)
    tok = tmesh._AMBIENT.set(object())
    try:
        for mode in ("hardware", "bit_exact", "surrogate", "surrogate_fast"):
            hw = CiMParams.from_config(CiMConfig(family="appro42", mode=mode,
                                                 per_token=True))
            ctx = CiMContext(hw, specs={"wq": P(None, "model")})
            with pytest.raises(NotImplementedError, match="A 5"):
                cim_linear(x, w, ctx, "wq")
    finally:
        tmesh._AMBIENT.reset(tok)
    assert cim_linear(x, w, CiMContext(p), "wq").shape == (2, 4)


# ---------------------------------------------------------------------------
# decode_multi
# ---------------------------------------------------------------------------


def _clone(caches):
    return {"layers": [{n: t.clone() for n, t in layer.items()}
                       for layer in caches["layers"]]}


def _ragged_lane(cfg, params, cim, rng):
    lm = LM(dataclasses.replace(cfg, cim=cim), "cpu")
    lane = LMLaneBackend(lm, params, n_slots=3, max_len=16,
                         prompt_buckets=(6,), group_buckets=(3,))
    lane.admit([rng.integers(0, cfg.vocab, (n,)) for n in (6, 4, 2)],
               [0, 1, 2])
    return lm, lane


@pytest.mark.parametrize("tier", ["exact", "balanced", "economy"])
def test_decode_multi_bitwise_equals_sequential(models, tier):
    """With per-token scales, decode_multi over k + 1 positions is bitwise
    k + 1 sequential decode_steps, logits and caches, on a ragged pool."""
    _, cfg, _, tp = models
    t = {t.name: t for t in build_tiers(mode="hardware")}[tier]
    cim = dataclasses.replace(t.cim, per_token=True)
    rng = np.random.default_rng(9)
    lm, lane = _ragged_lane(cfg, tp, cim, rng)
    k = 3
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (3, k + 1)))
    fill = torch.as_tensor(lane.slot_pos.astype(np.int32))
    with torch.inference_mode():
        lg_m, c_m = lm.decode_multi(tp, _clone(lane.caches), toks, fill)
        c, rows, pos = _clone(lane.caches), [], fill
        for i in range(k + 1):
            lg, c = lm.decode_step(tp, c, toks[:, i:i + 1], pos)
            rows.append(lg[:, -1])
            pos = pos + 1
    assert lg_m.shape == (3, k + 1, cfg.vocab)
    assert torch.equal(lg_m, torch.stack(rows, dim=1))
    for a, b in zip(c_m["layers"], c["layers"]):
        for name in ("k", "v", "pos"):
            assert torch.equal(a[name], b[name]), name


def test_decode_multi_matches_reference(models):
    """The port's decode_multi against the reference's on the same ragged
    pool state, to test_torch_lm.py's exact-lane tolerance (1e-2)."""
    jcfg, cfg, jp, tp = models
    jt = {t.name: t for t in jbuild_tiers(mode="hardware")}["exact"]
    tt = {t.name: t for t in build_tiers(mode="hardware")}["exact"]
    jlm = JLM(dataclasses.replace(jcfg, cim=dataclasses.replace(
        jt.cim, per_token=True)))
    tlm = LM(dataclasses.replace(cfg, cim=dataclasses.replace(
        tt.cim, per_token=True)), "cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (3, 6))
    lens = np.asarray([6, 4, 2], np.int32)
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks),
                              "lengths": jnp.asarray(lens), "max_len": 16})
    with torch.inference_mode():
        _, tc = tlm.prefill(tp, {"tokens": torch.as_tensor(toks),
                                 "lengths": torch.as_tensor(lens),
                                 "max_len": 16})
    nxt = rng.integers(0, cfg.vocab, (3, 4))
    jlg, _ = jlm.decode_multi(jp, jc, jnp.asarray(nxt, jnp.int32),
                              jnp.asarray(lens))
    with torch.inference_mode():
        tlg, tc = tlm.decode_multi(tp, tc, torch.as_tensor(nxt),
                                   torch.as_tensor(lens))
    np.testing.assert_allclose(tlg.float().numpy(),
                               np.asarray(jlg, np.float32), rtol=0,
                               atol=1e-2)
    assert tc["layers"][0]["pos"].tolist() == [10, 8, 6]


def test_append_drops_writes_past_the_cache_end(models):
    """A slot near max_len: its writes past the end are dropped, never
    clamped onto a live entry, and the lockstep (scalar pos) form clamps
    its start as dynamic_update_slice does."""
    _, cfg, _, tp = models
    t = {t.name: t for t in build_tiers(mode="hardware")}["exact"]
    lm = LM(dataclasses.replace(cfg, cim=dataclasses.replace(
        t.cim, per_token=True)), "cpu")
    caches = lm.init_caches(2, 8, per_slot=True)
    rng = np.random.default_rng(2)
    for layer in caches["layers"]:
        for name in ("k", "v"):
            layer[name].copy_(torch.from_numpy(rng.standard_normal(
                layer[name].shape).astype(np.float32)))
    fill = torch.tensor([2, 6], dtype=torch.int32)
    for layer in caches["layers"]:
        layer["pos"].copy_(fill)
    before = _clone(caches)
    with torch.inference_mode():
        _, after = lm.decode_multi(tp, caches, torch.ones(
            (2, 4), dtype=torch.int64), fill)
    for a, b in zip(before["layers"], after["layers"]):
        for name in ("k", "v"):
            assert torch.equal(a[name][0, :2], b[name][0, :2])
            assert torch.equal(a[name][0, 6:], b[name][0, 6:])
            assert not torch.equal(a[name][0, 2:6], b[name][0, 2:6])
            # slot 1 writes 6 and 7; 8 and 9 are dropped
            assert torch.equal(a[name][1, :6], b[name][1, :6])
            assert not torch.equal(a[name][1, 6:], b[name][1, 6:])
        assert b["pos"].tolist() == [6, 10]
    lock = lm.init_caches(1, 8)
    for layer in lock["layers"]:
        layer["pos"].fill_(7)
    with torch.inference_mode():
        _, lock = lm.decode_multi(tp, lock, torch.ones(
            (1, 3), dtype=torch.int64), 7)
    assert int(lock["layers"][0]["pos"]) == 10
    assert bool((lock["layers"][0]["k"][0, 5:] != 0).all())
    assert bool((lock["layers"][0]["k"][0, :5] == 0).all())


def test_append_and_decode_multi_refuse_what_they_do_not_cover(models):
    from repro_torch.models.attention import attention_block
    from repro_torch.models.common import CiMContext, CiMParams
    from repro_torch.models.transformer import _apply_layer

    _, cfg, _, tp = models
    lp = tp["layers"][0]
    x = torch.zeros(1, 2, cfg.d_model, dtype=torch.bfloat16)
    cache = LM(cfg, "cpu").init_caches(1, 8)["layers"][0]
    ctx = CiMContext(CiMParams())
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim_, rope_fraction=1.0, rope_theta=1e4,
              qk_norm=cfg.qk_norm, ctx=ctx, cache=cache, append=True)
    with pytest.raises(NotImplementedError, match="dense causal"):
        attention_block(lp["attn"], x, window=4, **kw)
    with pytest.raises(NotImplementedError, match="dense causal"):
        attention_block(lp["attn"], x, causal=False, **kw)
    with pytest.raises(ValueError, match="append"):
        _apply_layer(lp, x, "mlstm", cfg, ctx, None, cache, append=True)


# ---------------------------------------------------------------------------
# cache surgery against the reference's functions
# ---------------------------------------------------------------------------


def _toy_caches(rng, b=3, t=8, d=4, layers=2):
    mk = lambda: rng.normal(size=(b, t, d)).astype(np.float32)
    return {"layers": [{"k": mk(), "v": mk(), "pos": np.full(b, 5, np.int32)}
                       for _ in range(layers)]}


def _torch_tree(tree):
    return {"layers": [{n: torch.from_numpy(a.copy()) for n, a in l.items()}
                       for l in tree["layers"]]}


def test_rollback_and_reset_pos_match_the_reference():
    """_rollback zeroes exactly [new_fill, new_fill + width) a row (the
    part past the end dropped) and rewinds every pos; _reset_pos touches
    pos only: both equal to the reference's on the same data (whose
    surgery walks any {"k", "v", "pos"} dicts, the port's layout too)."""
    rng = np.random.default_rng(0)
    caches = _toy_caches(rng)
    new_fill = np.asarray([2, 6, 0], np.int32)          # row 1 overhangs
    want = j_rollback(jax.tree_util.tree_map(jnp.asarray, caches),
                      jnp.asarray(new_fill), 3)
    got = _rollback(_torch_tree(caches), torch.from_numpy(new_fill), 3)
    fill = np.asarray([1, 2, 3], np.int32)
    want_r = j_reset_pos(jax.tree_util.tree_map(jnp.asarray, caches),
                         jnp.asarray(fill))
    got_r = _reset_pos(_torch_tree(caches), torch.from_numpy(fill))
    for w, g in ((want, got), (want_r, got_r)):
        for lw, lg in zip(w["layers"], g["layers"]):
            for name in ("k", "v", "pos"):
                np.testing.assert_array_equal(lg[name].numpy(),
                                              np.asarray(lw[name]))
    # past the fill and outside the window: rows 5-7 of slot 0, none of
    # slot 1, rows 3-7 of slot 2; d = 4, K and V, two layers
    assert nonzero_past_fill(got, new_fill) == (3 + 0 + 5) * 4 * 2 * 2


# ---------------------------------------------------------------------------
# the spec engine
# ---------------------------------------------------------------------------


def _workload(cfg, n=6, seed=11):
    """Ragged mixed-tier traffic: approximate lanes beside the spec lane."""
    return poisson_workload(n, rate=500.0, vocab=cfg.vocab,
                            prompt_len=(3, 6), max_new=(2, 10),
                            tier_mix=(("exact", None, 0.6),
                                      ("balanced", None, 0.2),
                                      ("economy", None, 0.2)), seed=seed)


@pytest.fixture(scope="module")
def spec_vs_base(models):
    """A spec engine (every depth warmed) and the per-token exact engine
    it must reproduce, over the same weights, on the hardware ladder."""
    _, cfg, _, tp = models
    tiers = build_tiers(mode="hardware")
    _, v_tier = spec_pair(tiers)
    base = build_engine(cfg, tp, tiers=tuple(
        v_tier if t.name == "exact" else t for t in tiers), **ENGINE_KW)
    spec = build_engine(cfg, tp, tiers=tiers, spec_decode=2, spec_ks=KS,
                        **ENGINE_KW)
    n_warm = spec.warmup()
    base.warmup()
    return cfg, tp, base, spec, n_warm


def test_spec_tokens_equal_the_exact_lane_at_every_depth(spec_vs_base):
    """Every draft depth, one workload: token for token the per-token
    exact engine's, no plan built after warmup across the depth switches,
    and the cache invariant after every call."""
    cfg, _, base, spec, n_warm = spec_vs_base
    sb = spec.lanes["exact"].backend
    assert n_warm == len(spec.lanes) * (1 * 2 + 1) + len(KS)
    wl = _workload(cfg)
    want = base.run(wl, clock=SimClock())
    real = sb.spec_round
    calls = []

    def checked(remaining, eos):
        out = real(remaining, eos)
        calls.append(nonzero_past_fill(sb.caches, sb.slot_pos))
        return out
    sb.spec_round = checked
    try:
        for k in KS:
            sb.set_draft_k(k)
            got = spec.run(wl, clock=SimClock())
            for r in wl:
                assert got[r.rid].tokens == want[r.rid].tokens, (k, r.rid)
    finally:
        del sb.spec_round
    assert calls and not any(calls)
    assert spec.steady_plan_misses() == 0 and base.steady_plan_misses() == 0
    m = spec.metrics()["lanes"]
    assert m["exact"]["acceptance_rate"] == sb.acceptance_rate > 0.3
    assert m["balanced"]["acceptance_rate"] is None
    assert sb.tokens_per_round > 1.0


def test_spec_engine_matches_the_reference_spec_engine(models,
                                                       spec_vs_base):
    """The reference's spec engine (one depth, its own exact requests):
    the port's spec engine gives the same tokens."""
    jcfg, cfg, jp, _ = models
    _, _, _, spec, _ = spec_vs_base
    wl = [r for r in _workload(cfg, n=8, seed=5) if r.tier == "exact"][:3]
    jeng = jbuild_engine(jcfg, jp, tiers=jbuild_tiers(mode="hardware"),
                         spec_decode=2, slots_per_tier=2, max_len=32,
                         prompt_buckets=(6,), group_buckets=(1, 2))
    jeng.warmup()
    want = jeng.run(wl, clock=JSimClock())
    spec.lanes["exact"].backend.set_draft_k(2)
    got = spec.run(wl, clock=SimClock())
    for r in wl:
        assert got[r.rid].tokens == want[r.rid].tokens, r.rid


def test_spec_eos_truncates_mid_window(spec_vs_base):
    """An EOS inside the accepted window stops the request at the token
    the exact engine stops at."""
    cfg, _, base, spec, _ = spec_vs_base
    prompt = np.random.default_rng(21).integers(0, cfg.vocab, (4,))
    probe = base.run([Request(rid=900, prompt=prompt, max_new=8,
                              tier="exact")], clock=SimClock())
    eos = probe[900].tokens[3]
    spec.lanes["exact"].backend.set_draft_k(4)

    def req(rid):
        return [Request(rid=rid, prompt=prompt.copy(), max_new=8,
                        tier="exact", eos_id=eos)]
    r_b = base.run(req(901), clock=SimClock())
    r_s = spec.run(req(902), clock=SimClock())
    assert r_s[902].tokens == r_b[901].tokens
    assert r_s[902].tokens[-1] == eos and len(r_s[902].tokens) <= 4


def test_adversarial_drafter_cannot_change_the_output(spec_vs_base):
    """A drafter whose argmax is rotated away is almost never accepted,
    and the tokens stay the exact engine's."""
    cfg, tp, base, _, _ = spec_vs_base
    d_tier, v_tier = spec_pair(build_tiers(mode="hardware"))

    class _Scrambled:
        def __init__(self, lm):
            self._lm = lm

        def decode_step(self, params, caches, tok, pos):
            lg, caches = self._lm.decode_step(params, caches, tok, pos)
            return torch.roll(lg, 1, dims=-1), caches

    vlm = LM(dataclasses.replace(cfg, cim=v_tier.cim), "cpu")
    dlm = _Scrambled(LM(dataclasses.replace(cfg, cim=d_tier.cim), "cpu"))
    lane = SpecDecodeBackend(vlm, dlm, tp, draft_k=4, n_slots=2, max_len=32,
                             prompt_buckets=(6,), group_buckets=(1, 2))
    eng = ServingEngine({"exact": lane}, TierRouter([v_tier]))
    eng.warmup()
    wl = [r for r in _workload(cfg) if r.tier == "exact"]
    got = eng.run(wl, clock=SimClock())
    want = base.run(wl, clock=SimClock())
    for r in wl:
        assert got[r.rid].tokens == want[r.rid].tokens, r.rid
    assert lane.acceptance_rate < 0.1
    assert eng.steady_plan_misses() == 0


def test_rolled_back_pool_is_byte_equal_to_one_that_never_drafted(models):
    """After the same request, the spec lane's pool (its K/V, its fill
    levels) is byte for byte the per-token exact lane's."""
    _, cfg, _, tp = models
    tiers = build_tiers(mode="hardware", families=("exact", "mitchell"))
    _, v_tier = spec_pair(tiers)
    kw = dict(ENGINE_KW, slots_per_tier=1, group_buckets=(1,))
    base = build_engine(cfg, tp, tiers=(v_tier,), **kw)
    base.warmup()
    spec = build_engine(cfg, tp, tiers=tiers, spec_decode=3, **kw)
    spec.warmup()
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, (5,))

    def req():
        return [Request(rid=0, prompt=prompt.copy(), max_new=9,
                        tier="exact")]
    r_b = base.run(req(), clock=SimClock())
    r_s = spec.run(req(), clock=SimClock())
    assert r_s[0].tokens == r_b[0].tokens
    bb, sb = base.lanes["exact"].backend, spec.lanes["exact"].backend
    np.testing.assert_array_equal(bb.slot_pos, sb.slot_pos)
    for a, b in zip(bb.caches["layers"], sb.caches["layers"]):
        for name in ("k", "v", "pos"):
            assert torch.equal(a[name], b[name]), name


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------


def test_spec_pair_contracts():
    tiers = build_tiers(mode="hardware")
    d, v = spec_pair(tiers)
    assert v.name == "exact" and v.cim.per_token and v.nmed == 0.0
    approx = [t for t in tiers if t.name != "exact"]
    assert d.name == min(approx, key=lambda t: t.energy_per_mac_j).name
    assert spec_pair(tiers, drafter="economy")[0].name == "economy"
    with pytest.raises(KeyError):
        spec_pair(tiers, drafter="no-such-tier")
    with pytest.raises(ValueError):
        spec_pair([t for t in tiers if t.name != "exact"])
    d3, v3 = spec_pair(build_tiers(families=("exact",)))
    assert d3.name == "exact" and not d3.cim.per_token and v3.cim.per_token


def test_spec_backend_engine_and_launcher_contracts(models):
    from repro_torch.launch.serve import main

    _, cfg, _, tp = models
    tiers = build_tiers(mode="hardware")
    d_tier, v_tier = spec_pair(tiers)
    ex = next(t for t in tiers if t.name == "exact")
    vlm = LM(dataclasses.replace(cfg, cim=v_tier.cim), "cpu")
    dlm = LM(dataclasses.replace(cfg, cim=d_tier.cim), "cpu")
    kw = dict(n_slots=1, max_len=16, prompt_buckets=(4,),
              group_buckets=(1,))
    with pytest.raises(ValueError, match="mesh"):   # the drafter's own
        SpecDecodeBackend(vlm, dlm, tp, mesh=object(), **kw)
    with pytest.raises(ValueError, match="per_token"):
        SpecDecodeBackend(LM(dataclasses.replace(cfg, cim=ex.cim), "cpu"),
                          dlm, tp, **kw)
    with pytest.raises(ValueError, match="depth"):
        SpecDecodeBackend(vlm, dlm, tp, draft_k=0, **kw)
    with pytest.raises(ValueError, match="rounds_per_call"):
        SpecDecodeBackend(vlm, dlm, tp, rounds_per_call=0, **kw)
    b = SpecDecodeBackend(vlm, dlm, tp, draft_k=2, draft_ks=(1, 2), **kw)
    assert b.draft_ks == (1, 2)
    with pytest.raises(ValueError, match="not pre-built"):
        b.set_draft_k(3)
    b.set_draft_k(1)
    assert b.draft_k == 1
    # spec decoding composes with a mesh (tests/test_torch_mesh_spec.py);
    # faults still do not, spec lane or not
    from repro_torch.core.faults import FaultConfig

    with pytest.raises(ValueError, match="mesh"):
        build_engine(cfg, tp, tiers=tiers, spec_decode=2, mesh=object(),
                     fault=FaultConfig(p_sa0=0.01), **ENGINE_KW)
    import sys
    argv = sys.argv
    sys.argv = ["serve", "--spec-decode", "2", "--mesh", "2", "--ranks",
                "4", "--device", "cpu", "--mode", "hardware"]
    try:
        with pytest.raises(SystemExit):
            main()
    finally:
        sys.argv = argv


def test_chip_smoke_phase_11_rehearsed_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 11 end to end on the CPU at the smoke config
    (the kernels' plain versions, narrow GEMM shapes): its checks pass,
    it reports each part, and every launch check it makes expects the
    card's counts while the CPU's plain route launches nothing.  The
    timer, the profiler and phase 2's SASS reading, which need the card,
    are stood in for."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_p11", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "WEIGHT_SHAPES", ((64, 64), (128, 64)))
    monkeypatch.setattr(cs, "SPEC_DEVICE", "cpu")
    monkeypatch.setattr(cs, "_spec_config",
                        lambda: get_config(ARCH, smoke=True))
    monkeypatch.setattr(cs, "_timed_ms",
                        lambda torch, fn, reps, flush: (fn(), 1.0)[1])
    # phase 2 reads the log product's clocks from the card's SASS
    monkeypatch.setattr(cs, "LOG_CLOCKS", {False: 1.0, True: 1.0})
    profiled = []
    monkeypatch.setattr(cs, "_profile", lambda torch, lane, run, s, **kw: (
        profiled.append(lane), run()))
    checks = []
    monkeypatch.setattr(cs, "_expect_launches",
                        lambda where, got, want: checks.append(
                            (where, got, want)))
    assert cs.spec_phase(torch, "cpu", 132, 1.98e9) == ({}, {})
    assert all(got == {} for _, got, _ in checks)
    wants = {where: want for where, _, want in checks}
    n_layers = get_config(ARCH, smoke=True).n_layers
    per_fwd = cs.GEMMS_PER_LAYER * n_layers
    for name, kern in cs.PT_INT.items():
        for k, n in cs.WEIGHT_SHAPES:
            assert wants[f"phase 11 (a) {name} ({cs.PT_ROWS}, {k}, {n})"] \
                == ({kern: 1} if kern else {})
        assert wants[f"phase 11 (b) {name}: decode_multi"] == (
            {kern: per_fwd} if kern else {})
    # the wide pool on the exact lane: its steps and its decode_multi
    assert len(checks) == len(cs.PT_INT) * (
        len(cs.WEIGHT_SHAPES) + 2 * len(cs.MULTI_CASES)) + 2
    assert profiled == [f"spec k={cs.SPEC_KS[0]}"]
    out = capsys.readouterr().out
    for k in cs.SPEC_KS:
        assert f"spec k={k}, identical to the baseline" in out
    assert "full pool: " in out
    assert "(8 x 9) vs 9 decode_steps" in out
    assert "bitwise;" in out and "phase 11 took" in out
