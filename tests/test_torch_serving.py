"""PyTorch port, serving: the scheduler (seeded traces on a fake backend,
mirroring tests/test_serving.py), the tier router, the real LM lanes
(engine against lockstep, bitwise within the port; no plan misses after
warmup), workload parity with the JAX package, and the import rule: the
port and chip_smoke.py never import jax or repro."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro.serving import poisson_workload as j_poisson_workload
from repro_torch.configs import get_config
from repro_torch.models.transformer import LM
from repro_torch.serving import (Request, ServingEngine, SimClock,
                                 build_engine, build_tiers, poisson_workload)
from repro_torch.serving.engine import LMLaneBackend
from repro_torch.serving.tiers import AccuracyTier, TierRouter

ARCH = "qwen3-1.7b"
ROOT = pathlib.Path(__file__).resolve().parents[1]


class FakeLane:
    """Backend double: token = running counter, no model."""

    def __init__(self, n_slots, max_len=10_000):
        self.n_slots, self.max_len = n_slots, max_len
        self.max_group = n_slots
        self._n = 0
        self.slot_tok = np.zeros(n_slots, np.int64)
        self.admitted = 0

    def warmup(self):
        return 0

    def admit(self, prompts, slots):
        out = []
        for _, s in zip(prompts, slots):
            self._n += 1
            self.slot_tok[s] = self._n
            out.append(self._n)
        self.admitted += len(out)
        return np.asarray(out)

    def decode_round(self):
        self.slot_tok = self.slot_tok + 1
        return self.slot_tok.copy()


def _fake_tiers(names=("a", "b")):
    return [AccuracyTier(n, None, 0.001 * i, 1.0 + i)
            for i, n in enumerate(names)]


def _fake_engine(n_slots=3, names=("a", "b"), **kw):
    tiers = _fake_tiers(names)
    lanes = {t.name: FakeLane(n_slots) for t in tiers}
    return ServingEngine(lanes, TierRouter(tiers),
                         check_invariants=True, **kw), lanes


def _req(rid, tier="a", plen=4, max_new=3, arrival=0.0):
    return Request(rid=rid, prompt=np.zeros(plen, np.int64),
                   max_new=max_new, tier=tier, arrival=arrival)


def test_scheduler_basic_complete():
    eng, _ = _fake_engine()
    reqs = [_req(i, tier="ab"[i % 2], max_new=1 + i % 4,
                 arrival=0.01 * i) for i in range(10)]
    res = eng.run(reqs, clock=SimClock())
    assert len(res) == 10
    for r in reqs:
        assert res[r.rid].done
        assert len(res[r.rid].tokens) == r.max_new
    for lane in eng.lanes.values():          # eviction freed every slot
        assert not lane.running and not lane.queue
        assert sorted(lane.free) == list(range(lane.backend.n_slots))
    assert eng.active_tokens == 0


def test_scheduler_static_waits_for_full_batch():
    eng, lanes = _fake_engine(n_slots=2, names=("a",), continuous=False)
    reqs = [_req(i, max_new=2, arrival=0.1 * i) for i in range(4)]
    res = eng.run(reqs, clock=SimClock())
    assert all(r.done for r in res.values())
    assert lanes["a"].admitted == 4
    assert eng.peak_running <= 2


def test_scheduler_token_budget_blocks_head():
    eng, _ = _fake_engine(n_slots=3, names=("a",), token_budget=12)
    reqs = [_req(i, plen=4, max_new=2, arrival=0.0) for i in range(5)]
    res = eng.run(reqs, clock=SimClock())        # cost 6 each: 2 at a time
    assert all(r.done for r in res.values())
    assert eng.peak_running <= 2                 # 12 // 6


def test_submit_rejects_live_duplicate_rid():
    eng, _ = _fake_engine(n_slots=2, names=("a",))
    eng.submit(_req(0, max_new=3))
    with pytest.raises(ValueError):
        eng.submit(_req(0, max_new=3))       # still queued/running
    while not eng.results[0].done:
        eng.step()
    eng.submit(_req(0, max_new=2))           # done: rid reuse is fine
    res = eng.run([], clock=SimClock())
    assert not res
    assert eng.results[0].done


def test_submit_rejects_oversized_and_bounds_the_queue():
    from repro_torch.serving import AdmissionRejected

    eng, _ = _fake_engine(n_slots=2, names=("a",), token_budget=8)
    with pytest.raises(ValueError):
        eng.submit(_req(0, plen=6, max_new=6))   # cost 12 > budget
    eng2 = ServingEngine({"a": FakeLane(2, max_len=8)},
                         TierRouter(_fake_tiers(("a",))))
    with pytest.raises(ValueError):
        eng2.submit(_req(1, plen=6, max_new=6))  # cost 12 > max_len
    eng3, _ = _fake_engine(n_slots=1, names=("a",), max_queued=2)
    eng3.submit(_req(0))
    eng3.submit(_req(1))
    with pytest.raises(AdmissionRejected):
        eng3.submit(_req(2))


def check_random_trace(spec, n_slots, continuous):
    """No slot leak, no starvation, budget respected, eviction frees
    capacity — invariants asserted every tick."""
    tiers = _fake_tiers(("a", "b"))
    lanes = {t.name: FakeLane(n_slots) for t in tiers}
    budget = 2 * n_slots * 14                     # max cost = 8 + 6
    eng = ServingEngine(lanes, TierRouter(tiers), continuous=continuous,
                        token_budget=budget, check_invariants=True)
    t = 0.0
    reqs = []
    for i, (gap, plen, max_new, tier_i) in enumerate(spec):
        t += gap
        reqs.append(_req(i, tier="ab"[tier_i], plen=plen,
                         max_new=max_new, arrival=t))
    res = eng.run(reqs, clock=SimClock())
    assert len(res) == len(reqs)
    for r in reqs:
        assert res[r.rid].done
        assert len(res[r.rid].tokens) == r.max_new
    assert eng.active_tokens == 0
    assert sum(len(l.free) for l in eng.lanes.values()) == 2 * n_slots
    assert eng.peak_running <= 2 * n_slots


@pytest.mark.parametrize("seed", range(8))
def test_scheduler_random_traces_seeded(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 26))
    spec = [(float(rng.uniform(0, 0.5)), int(rng.integers(1, 9)),
             int(rng.integers(1, 7)), int(rng.integers(0, 2)))
            for _ in range(n)]
    check_random_trace(spec, n_slots=int(rng.integers(1, 4)),
                       continuous=bool(seed % 2))


def test_tier_router():
    tiers = build_tiers()
    r = TierRouter(tiers)
    assert r.route(0.0).name == "exact"
    assert r.route(None).name == "exact"
    by_name = {t.name: t for t in tiers}
    assert r.route(by_name["balanced"].nmed).name == "balanced"
    assert r.route(1.0).name == "balanced"
    assert r.route(tier="economy").name == "economy"
    with pytest.raises(KeyError):
        r.route(tier="no-such-tier")
    with pytest.raises(ValueError):
        TierRouter([t for t in tiers if t.nmed > 0]).route(0.0)


def test_workload_equals_reference():
    kw = dict(prompt_len=(2, 5), max_new=(1, 4),
              tier_mix=(("exact", None, 0.3), ("balanced", None, 0.4),
                        ("economy", None, 0.3)), seed=123)
    a = j_poisson_workload(9, 50.0, 97, **kw)
    b = poisson_workload(9, 50.0, 97, **kw)
    assert [(r.rid, r.arrival, r.max_new, r.tier, r.prompt.tolist())
            for r in a] == [(r.rid, r.arrival, r.max_new, r.tier,
                             r.prompt.tolist()) for r in b]


# ---------------------------------------------------------------------------
# real LM lanes (CPU: the kernels' plain versions)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_lm():
    cfg = get_config(ARCH, smoke=True)
    return cfg, LM(cfg, device="cpu").init(0)


@pytest.mark.parametrize("tier_name", ["exact", "balanced"])
def test_engine_bit_identical_to_lockstep(smoke_lm, tier_name):
    """All requests arriving together == the lockstep prefill/decode
    loop, logit for logit."""
    cfg, params = smoke_lm
    tier = {t.name: t for t in build_tiers(mode="hardware")}[tier_name]
    lm = LM(dataclasses.replace(cfg, cim=tier.cim), device="cpu")
    rng = np.random.default_rng(4)
    b, s, gen, max_len = 2, 8, 3, 16
    toks = rng.integers(0, cfg.vocab, (b, s))
    with torch.inference_mode():
        lp, caches = lm.prefill(params, {"tokens": torch.as_tensor(toks),
                                         "max_len": max_len})
        ref = [lp[:, -1].float().numpy()]
        tok = lp[:, -1].float().argmax(-1)[:, None]
        for i in range(gen - 1):
            lp, caches = lm.decode_step(params, caches, tok, s + i)
            tok = lp[:, -1].float().argmax(-1)[:, None]
            ref.append(lp[:, -1].float().numpy())

    lane = LMLaneBackend(lm, params, n_slots=b, max_len=max_len,
                         prompt_buckets=(s,), group_buckets=(b,))
    eng = ServingEngine({tier.name: lane}, TierRouter([tier]),
                        record_logits=True)
    eng.warmup()
    reqs = [Request(rid=i, prompt=toks[i], max_new=gen, tier=tier.name)
            for i in range(b)]
    res = eng.run(reqs, clock=SimClock())
    assert eng.steady_plan_misses() == 0
    for i in range(b):
        assert len(res[i].logits) == gen
        for t in range(gen):
            assert np.array_equal(res[i].logits[t], ref[t][i]), \
                f"req {i} token {t}: engine != lockstep ({tier_name})"


def test_engine_no_plan_misses_after_warmup(smoke_lm):
    """Every (tier x prompt-bucket x group-bucket) shape runs at warmup;
    mixed-tier Poisson traffic with occupancy churn builds no plan."""
    cfg, params = smoke_lm
    tiers = build_tiers(mode="hardware")
    eng = build_engine(cfg, params, tiers=tiers, slots_per_tier=2,
                       max_len=24, prompt_buckets=(6,),
                       group_buckets=(1, 2), device="cpu")
    assert eng.warmup() == len(tiers) * (1 * 2 + 1)
    wl = poisson_workload(8, rate=500.0, vocab=cfg.vocab,
                          prompt_len=(3, 6), max_new=(1, 5),
                          tier_mix=(("exact", None, 1.0),
                                    ("balanced", None, 1.0),
                                    ("economy", None, 1.0)), seed=5)
    res = eng.run(wl, clock=SimClock())
    assert all(r.done for r in res.values())
    assert {r.tier for r in res.values()} == {"exact", "balanced",
                                               "economy"}
    for r in wl:
        assert len(res[r.rid].tokens) == r.max_new
    assert eng.steady_plan_misses() == 0


def test_engine_reused_after_warmup_serves_identically(smoke_lm):
    """Idle slots enter every decode round's per-tensor scale, so a
    reused pool must restart them (warmup -> reset) to give a workload
    the tokens a fresh pool gives it."""
    cfg, params = smoke_lm
    tiers = build_tiers(mode="hardware", families=("exact", "mitchell"))
    kw = dict(tiers=tiers, slots_per_tier=3, max_len=16,
              prompt_buckets=(6,), group_buckets=(1, 2), device="cpu")
    wl = poisson_workload(6, rate=50.0, vocab=cfg.vocab, prompt_len=(3, 6),
                          max_new=(2, 8), tier_mix=(("economy", None, 1.0),),
                          seed=2)
    eng = build_engine(cfg, params, **kw)
    eng.warmup()
    first = eng.run(wl, clock=SimClock())
    eng.warmup()
    again = eng.run(wl, clock=SimClock())
    fresh = build_engine(cfg, params, **kw)
    fresh.warmup()
    ref = fresh.run(wl, clock=SimClock())
    for r in wl:
        assert first[r.rid].tokens == again[r.rid].tokens \
            == ref[r.rid].tokens


def test_attn_engine_serves_twice_identically(smoke_lm, monkeypatch):
    """An attn=True ladder: warmup plans every attention shape (no plan
    misses while serving), the approximate lanes run CiM attention with
    no float fallback, and a workload served twice gives identical
    tokens."""
    from repro_torch.core import approx_gemm as ag
    from repro_torch.models import attention as tattn

    cfg, params = smoke_lm
    tiers = build_tiers(mode="hardware", attn=True)
    assert all(t.cim.attn for t in tiers)
    eng = build_engine(cfg, params, tiers=tiers, slots_per_tier=2,
                       max_len=24, prompt_buckets=(6,), group_buckets=(1, 2),
                       device="cpu")
    eng.warmup()
    calls = []
    real = ag.cim_attention
    monkeypatch.setattr(ag, "cim_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    n0 = tattn.cim_attn_fallbacks()
    wl = poisson_workload(8, rate=500.0, vocab=cfg.vocab,
                          prompt_len=(3, 6), max_new=(1, 5),
                          tier_mix=(("exact", None, 1.0),
                                    ("balanced", None, 1.0),
                                    ("economy", None, 1.0)), seed=5)
    first = eng.run(wl, clock=SimClock())
    assert eng.steady_plan_misses() == 0
    assert calls and tattn.cim_attn_fallbacks() == n0
    assert {r.tier for r in first.values()} == {"exact", "balanced",
                                                 "economy"}
    eng.warmup()
    again = eng.run(wl, clock=SimClock())
    for r in wl:
        assert len(first[r.rid].tokens) == r.max_new
        assert first[r.rid].tokens == again[r.rid].tokens


@pytest.mark.parametrize("attn", [False, True])
def test_decode_scales_span_the_whole_cache(smoke_lm, attn):
    """Mirrored from the reference (its dense decode hands the whole
    (B, t) cache to CiM attention): the per-head K/V scales are taken
    over every cache row, those past the fill level included, so stale
    rows there change a CiM-attention decode although the mask hides
    them from the softmax.  The float path never reads them.  This is
    why LMLaneBackend.reset() zeroes the K/V rows."""
    cfg, params = smoke_lm
    tier = {t.name: t for t in build_tiers(mode="hardware",
                                           attn=attn)}["economy"]
    lm = LM(dataclasses.replace(cfg, cim=tier.cim), device="cpu")
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab, (2, 6)))
    out = []
    for stale in (0.0, 50.0):
        with torch.inference_mode():
            _, caches = lm.prefill(params, {"tokens": toks, "max_len": 16})
            for layer in caches["layers"]:
                layer["k"][:, 8:] = stale          # rows past the fill level
                layer["v"][:, 8:] = stale
            lg, _ = lm.decode_step(params, caches, toks[:, -1:], 6)
        out.append(lg)
    assert torch.equal(out[0], out[1]) != attn


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    parsed = {f.relative_to(ROOT).as_posix() for f in files}
    assert {f"src/repro_torch/{m}.py" for m in (
        "models/cnn", "kernels/conv_gemm", "kernels/sass", "data/pipeline",
        "launch/table4_cnn", "launch/kernel_ab", "kernels/cim_gemm",
        "launch/mesh", "parallel/sharding", "models/xlstm",
        "kernels/slstm_scan", "configs/hybrid_archs")} <= parsed
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "flax"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad
