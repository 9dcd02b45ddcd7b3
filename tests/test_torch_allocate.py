"""PyTorch port, per-module accuracy allocation (core/allocate.py) held
to the JAX package on the CPU: the `alloc` table's validation and
longest-prefix routing, the torch form of the multiplier emulators and
the batched characterization (byte-equal), the probe, the mixing
evaluator's single-module truth table, the numpy search helpers and the
surrogate MLP's training, `autoallocate` against the exhaustive oracle,
and the allocation lane served on the CPU engine.

Both evaluators run qwen3-1.7b-smoke in `bit_exact` mode (deterministic:
no noise key enters a measurement) on the JAX package's weights, carried
across by models/bridge.py, over the same (2, 16) token batch.

Tolerance of the truth table: rtol 0.15.  Every tier quantizes each
activation per tensor, so a last-ulp difference between the frameworks
that lands on a rounding boundary moves a code by a whole level (the
mechanism behind tests/test_torch_lm.py's 4e-2 on the logits); the
approximate tiers' NMEDs measured 0.2-8.1% apart.  The exact column is 0
in both, exactly, and the allocations both frameworks choose are equal."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import allocate as jalloc
from repro.core import error_model as jerm
from repro.core.compiler import CiMConfig as JCiMConfig
from repro.core.faults import FaultConfig as JFaultConfig
from repro.core.multipliers import MultiplierSpec as JSpec
from repro.models.common import CiMParams as JCiMParams
from repro.models.common import unbox
from repro.models.transformer import LM as JLM
from repro_torch.configs import get_config
from repro_torch.core import allocate
from repro_torch.core import error_model as erm
from repro_torch.core.compiler import CiMConfig
from repro_torch.core.error_model import ErrorMetrics
from repro_torch.core.faults import FaultConfig
from repro_torch.core.multipliers import MultiplierSpec, multiply_unsigned
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.common import CiMParams
from repro_torch.models.transformer import LM

ARCH = "qwen3-1.7b"
MODS = ("wq", "wv", "mlp_wo")       # 3 modules x 4 tiers: exhaustible
ALL_MODS = ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wg", "mlp_wo")
MODE = "bit_exact"
TRUTH_RTOL = 0.15
# the reference's allocation at budget 1e-2 (its oracle and its search)
REF_PICK = (("wq", "appro42[yang1/8c]8b"), ("wv", "appro42[yang1/8c]8b"),
            ("mlp_wo", "appro42[orplane/10c]8b"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch ops, restored after it.
    Its ops are small; next to the other test workers on the same cores,
    torch's default pool (a thread a core) spends its time waiting for
    cores those workers hold, not computing."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _singles(L, T):
    out = []
    for i in range(L):
        for t in range(T):
            a = [0] * L
            a[i] = t
            out.append(a)
    return out


@pytest.fixture(scope="module")
def ref():
    """The JAX package's evaluator and its single-module truth table."""
    cfg = jget_config(ARCH, smoke=True)
    lm = JLM(cfg)
    params = lm.init(jax.random.PRNGKey(0))
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (2, 16),
                                          0, cfg.vocab)}
    ev = jalloc.make_evaluator(lm, params=params, batch=batch,
                               modules=MODS, mode=MODE)
    L, T = len(ev.modules), len(ev.candidates)
    truth = ev.nmed_many(_singles(L, T)).reshape(L, T)
    tree = jax.tree_util.tree_map(np.asarray, unbox(params))
    return dict(lm=lm, ev=ev, truth=truth, tree=tree,
                tokens=np.asarray(batch["tokens"]))


@pytest.fixture(scope="module")
def port(ref):
    cfg = get_config(ARCH, smoke=True)
    lm = LM(cfg, "cpu")
    params = params_from_numpy(ref["tree"], "cpu")
    ev = allocate.make_evaluator(lm, params=params, tokens=ref["tokens"],
                                 modules=MODS, mode=MODE)
    return dict(cfg=cfg, lm=lm, params=params, ev=ev)


def _tier_index(ev, tier_map):
    by = {c.short_name(): i for i, c in enumerate(ev.candidates)}
    return [by[t] for _, t in tier_map]


# ------------------------------------------------------- alloc plumbing --


@pytest.mark.parametrize("kw", [
    dict(alloc=(("mlp", "appro42", "yang1", 8),), apply_to=("mlp",)),
    dict(alloc=(("mlp", "appro42", "yang1", 8),), fault="fault"),
    dict(alloc=(("mlp", "appro42"),)),
    dict(alloc=(("", "appro42", "yang1", 8),)),
    dict(alloc=((3, "appro42", "yang1", 8),)),
    dict(alloc=(("mlp", "booth", "yang1", 8),)),
    dict(alloc=(("mlp", "appro42", "yang1", -3),)),
    dict(alloc=(("mlp", "appro42", "yang1", 2.5),)),
], ids=["apply_to", "fault", "not_4_tuple", "empty_prefix", "int_prefix",
        "family", "negative_cols", "float_cols"])
def test_alloc_validation_messages_are_the_references(kw):
    """Each refusal raises ValueError with the reference's message."""
    def make(cls, fault_cls, **k):
        if k.get("fault") == "fault":
            k["fault"] = fault_cls(p_sa0=0.01, p_sa1=0.01)
        return cls(family="appro42", mode="hardware", **k)

    with pytest.raises(ValueError) as want:
        make(JCiMConfig, JFaultConfig, **kw)
    with pytest.raises(ValueError) as got:
        make(CiMConfig, FaultConfig, **kw)
    assert str(got.value) == str(want.value)


def test_alloc_normalizes_as_the_reference():
    table = [["mlp", "appro42", "orplane", 10], ("wq", "log_our", None,
                                                  None)]
    got = CiMConfig(mode="hardware", alloc=table).alloc
    assert got == JCiMConfig(mode="hardware", alloc=table).alloc
    assert got == (("mlp", "appro42", "orplane", 10),
                   ("wq", "log_our", "None", None))


@pytest.mark.parametrize("per_token", [False, True])
def test_alloc_longest_prefix_routing_equals_the_reference(per_token):
    """GemmParams field by field as the reference's for the same table
    (per-token carried through); longest prefix wins; exact entries and
    unmatched names run the exact macro (apply False)."""
    table = (("mlp", "appro42", "orplane", 10),
             ("mlp_wo", "log_our", "yang1", None),
             ("wq", "exact", "yang1", None))
    kw = dict(family="appro42", bits=8, mode="hardware", alloc=table,
              per_token=per_token)
    p = CiMParams.from_config(CiMConfig(**kw))
    jp = JCiMParams.from_config(JCiMConfig(**kw))
    for name in ALL_MODS + ("mlp", "lm_head"):
        gp, apply = p.routing(name)
        jgp, japply = jp.routing(name)
        assert apply == japply, name
        assert dataclasses.asdict(gp) == dataclasses.asdict(jgp), name
    assert p.routing("mlp_wi")[0].family == "appro42"
    assert p.routing("mlp_wo")[0].family == "log_our"
    assert not p.routing("wq")[1] and not p.routing("wk")[1]
    assert p.routing("wq")[0].family == "exact"
    assert p.routing("wk")[0] == p.gemm_params()
    assert all(gp.per_token == per_token for _, gp, _ in p.alloc)
    assert hash(p.alloc) is not None    # frozen: plan-cache keys


@pytest.mark.parametrize("mode", ["hardware", "surrogate"])
def test_all_exact_alloc_is_the_apply_nothing_baseline(port, mode):
    """An all-exact table and apply_to=("__none__",) run the same exact
    macro on every module: bitwise equal logits."""
    cfg, params = port["cfg"], port["params"]
    toks = port["ev"].tokens
    a = LM(dataclasses.replace(cfg, cim=CiMConfig(
        family="appro42", mode=mode,
        alloc=tuple((m, "exact", "yang1", None) for m in ALL_MODS))), "cpu")
    b = LM(dataclasses.replace(cfg, cim=CiMConfig(
        family="appro42", mode=mode, apply_to=("__none__",))), "cpu")
    with torch.inference_mode():
        la = a.forward_logits(params, toks)
        lb = b.forward_logits(params, toks)
    assert torch.equal(la, lb)


# ------------------------------------------- emulators + characterization --


@pytest.mark.parametrize("spec", [
    MultiplierSpec("exact", 8), MultiplierSpec("appro42", 8, False, "yang1", 8),
    MultiplierSpec("appro42", 8, False, "orplane", 10),
    MultiplierSpec("appro42", 8, False, "momeni_or", 6),
    MultiplierSpec("mitchell", 8), MultiplierSpec("log_our", 8),
], ids=lambda s: s.short_name())
def test_multiply_unsigned_on_torch_is_numpy_on_every_8bit_pair(spec):
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    a, b = a.ravel(), b.ravel()
    want = np.asarray(multiply_unsigned(a, b, spec), np.int64)
    got = multiply_unsigned(torch.from_numpy(a).to(torch.int32),
                            torch.from_numpy(b).to(torch.int32), spec)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("bits", [12, 15])
def test_multiply_unsigned_on_int32_holds_wide_products(bits):
    """Up to 15 bits the int32 products equal numpy's int64 ones."""
    rng = np.random.default_rng(bits)
    a = rng.integers(0, 1 << bits, 4096)
    b = np.concatenate([rng.integers(0, 1 << bits, 4095), [(1 << bits) - 1]])
    a[-1] = (1 << bits) - 1
    for spec in (MultiplierSpec("appro42", bits, False, "orplane", 10),
                 MultiplierSpec("exact", bits),
                 MultiplierSpec("log_our", bits),
                 MultiplierSpec("mitchell", bits)):
        want = np.asarray(multiply_unsigned(a, b, spec), np.int64)
        got = multiply_unsigned(torch.from_numpy(a).to(torch.int32),
                                torch.from_numpy(b).to(torch.int32), spec)
        assert np.array_equal(got.numpy().astype(np.int64), want), spec


# BENCH_dse's 12-bit grid, and one spec twice
CHAR_SPECS = ([("appro42", 12, False, "yang1", n) for n in (4, 8)]
              + [("appro42", 12, False, "orplane", n) for n in (6, 10)]
              + [("log_our", 12, False, "yang1", None),
                 ("mitchell", 12, False, "yang1", None),
                 ("appro42", 12, False, "yang1", 4)])


def test_characterize_batch_is_byte_equal_serial_and_reference(
        tmp_path, monkeypatch):
    path = str(tmp_path / "char.json")
    monkeypatch.setenv("OPENACM_TORCH_CHAR_CACHE", path)
    monkeypatch.setenv("OPENACM_CHAR_CACHE", str(tmp_path / "jax.json"))
    specs = [MultiplierSpec(*k) for k in CHAR_SPECS]
    n = 20_000
    outcomes = []

    class Sink:
        def char_cache(self, key, outcome):
            outcomes.append(outcome)

    erm.clear_memory_cache()
    prev = erm.set_obs_sink(Sink())
    try:
        batched = erm.characterize_batch(specs, n_samples=n, device="cpu")
    finally:
        erm.set_obs_sink(prev)
    assert outcomes == ["batched"] * 6     # the duplicate computed once
    serial = [erm.characterize(s, n_samples=n, cache=False) for s in specs]
    assert batched == serial
    assert batched[-1] == batched[0]
    ref = jerm.characterize_batch([JSpec(*k) for k in CHAR_SPECS],
                                  n_samples=n, cache=False)
    assert [dataclasses.asdict(m) for m in batched] == \
        [dataclasses.asdict(m) for m in ref]
    # one cache row per distinct spec, shared with the serial path
    rows = erm._load_disk(path)
    assert len(rows) == 6
    erm.clear_memory_cache()
    assert erm.characterize(specs[3], n_samples=n) == batched[3]
    with pytest.raises(ValueError, match="one device"):
        erm.characterize_batch(specs, n_samples=n, device="cpu",
                               mesh=object())


# ------------------------------------------------------ probe + evaluator --


def test_probe_matches_the_reference(ref, port):
    """All seven named matmuls, one call a layer; the evaluator's three
    are the reference's in name, k, n, calls, MACs and absmax_w (the
    weights are the same bits), absmax_x within 2 bf16 ulps."""
    stats = allocate.probe_modules(port["lm"], port["params"],
                                   ref["tokens"])
    assert tuple(s.name for s in stats) == ALL_MODS
    assert all(s.calls == port["cfg"].n_layers for s in stats)
    by = {s.name: s for s in stats}
    for js in ref["ev"].modules:
        s = by[js.name]
        assert (s.k, s.n, s.calls, s.macs, s.absmax_w) == \
            (js.k, js.n, js.calls, js.macs, js.absmax_w), js.name
        assert s.absmax_x == pytest.approx(js.absmax_x, rel=2 ** -7)
    assert [s.name for s in port["ev"].modules] == list(MODS)


def test_truth_table_matches_the_reference(ref, port):
    ev = port["ev"]
    L, T = len(ev.modules), len(ev.candidates)
    truth = ev.nmed_many(_singles(L, T)).reshape(L, T)
    assert [c.short_name() for c in ev.candidates] == \
        [c.short_name() for c in ref["ev"].candidates]
    assert np.all(truth[:, 0] == 0.0) and np.all(ref["truth"][:, 0] == 0.0)
    assert np.all(truth[:, 1:] > 0.0)
    np.testing.assert_allclose(truth, ref["truth"], rtol=TRUTH_RTOL)
    # deterministic: the same selection twice measures the same
    assert ev.nmed([1] * L) == ev.nmed([1] * L)


# ------------------------------------------------------- search helpers --


def _port_candidates(jcands):
    return [allocate.TierCandidate(
        MultiplierSpec(*dataclasses.astuple(c.spec)),
        ErrorMetrics(**dataclasses.asdict(c.metrics)), c.energy_per_mac_j)
        for c in jcands]


def _port_modules(jmods):
    return [allocate.ModuleStats(**dataclasses.asdict(m)) for m in jmods]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_helpers_equal_the_references(ref, seed):
    jev = ref["ev"]
    cands, mods = _port_candidates(jev.candidates), _port_modules(
        jev.modules)
    total = sum(m.macs for m in mods)
    for c, jc in zip(cands, jev.candidates):
        for m, jm in zip(mods, jev.modules):
            assert np.array_equal(allocate._features(c, m, total),
                                  jalloc._features(jc, jm, total))
    rng = np.random.default_rng(seed)
    L, T = 5, 4
    table = 10.0 ** rng.uniform(-4, -1.5, (L, T))
    table[:, 0] = 0.0
    energies = np.sort(rng.uniform(1e-12, 3e-12, T))[::-1]
    macs = rng.uniform(1e4, 1e6, L)
    for budget in (1e-3, 5e-3, 2e-2):
        assert allocate._greedy(table, energies, macs, budget) == \
            jalloc._greedy(table, energies, macs, budget)
        assert allocate._beam(table, energies, macs, budget, width=4) == \
            jalloc._beam(table, energies, macs, budget, width=4)
    for _ in range(5):
        a = list(rng.integers(0, T, size=L))
        assert allocate._combined_risk(table, a) == \
            jalloc._combined_risk(table, a)
        b, jb = list(a), list(a)
        while True:
            more = allocate._repair(b, table)
            assert more == jalloc._repair(jb, table) and b == jb
            if not more:
                break


def test_surrogate_fit_from_the_reference_init(ref):
    """Given the reference's initial parameters, the torch trainer's
    table matches the JAX trainer's and proposes the same allocations."""
    jev = ref["ev"]
    jsur = jalloc.ContributionSurrogate.fit(jev.candidates, jev.modules,
                                            ref["truth"])
    init = jax.tree_util.tree_map(
        np.asarray, jalloc._mlp_init(jax.random.PRNGKey(0), 12))
    cands, mods = _port_candidates(jev.candidates), _port_modules(
        jev.modules)
    sur = allocate.ContributionSurrogate.fit(cands, mods, ref["truth"],
                                             init=init, device="cpu")
    np.testing.assert_allclose(sur.table, jsur.table, rtol=1e-4, atol=0)
    energies = np.array([c.energy_per_mac_j for c in cands])
    macs = np.array([m.macs for m in mods])
    for budget in (3e-3, 8e-3, 1e-2, 2e-2):
        assert allocate._greedy(sur.table, energies, macs, budget) == \
            jalloc._greedy(jsur.table, energies, macs, budget)
        assert allocate._beam(sur.table, energies, macs, budget) == \
            jalloc._beam(jsur.table, energies, macs, budget)


# ----------------------------------------------------------- the search --


def test_oracle_and_autoallocate_pick_the_references_allocation(ref, port):
    ev = port["ev"]
    budget = 1e-2
    o = allocate.exhaustive_oracle(port["lm"], budget, evaluator=ev)
    a = allocate.autoallocate(port["lm"], budget, evaluator=ev)
    jo = jalloc.exhaustive_oracle(ref["lm"], budget, evaluator=ref["ev"])
    assert jo.tier_map == REF_PICK
    assert o.tier_map == REF_PICK and a.tier_map == REF_PICK
    assert o.evals == 64 and a.evals < o.evals
    assert a.nmed <= budget and o.nmed <= budget
    assert a.energy_per_mac_j <= 1.10 * o.energy_per_mac_j
    assert a.energy_per_mac_j == pytest.approx(jo.energy_per_mac_j,
                                               rel=1e-12)
    assert a.alloc == jo.alloc


@pytest.mark.parametrize("budget", [3e-3, 8e-3, 2e-2])
def test_autoallocate_budget_always_satisfied(port, budget):
    ev = port["ev"]
    a = allocate.autoallocate(port["lm"], budget, evaluator=ev)
    assert a.nmed <= budget
    assert a.nmed == ev.nmed(_tier_index(ev, a.tier_map))
    assert a.energy_per_mac_j <= a.exact_energy_per_mac_j


def test_autoallocate_tightest_budget_degrades_to_exact(port):
    a = allocate.autoallocate(port["lm"], 1e-9, evaluator=port["ev"])
    assert a.nmed == 0.0
    assert all(t == "exact8b" for _, t in a.tier_map)
    assert a.energy_per_mac_j == a.exact_energy_per_mac_j


def test_allocation_roundtrip_through_cim_config(port):
    """The returned table drives a real forward whose deviation from the
    all-exact table's is of the evaluator's order."""
    a = allocate.autoallocate(port["lm"], 1e-2, evaluator=port["ev"])
    cim = a.to_cim_config()
    assert cim.alloc == a.alloc and cim.mode == MODE
    exact = dataclasses.replace(cim, alloc=tuple(
        (n, "exact", "yang1", None) for n, *_ in cim.alloc))
    with torch.inference_mode():
        got, want = (LM(dataclasses.replace(port["cfg"], cim=c), "cpu")
                     .forward_logits(port["params"], port["ev"].tokens)
                     .to(torch.float32) for c in (cim, exact))
    assert bool(torch.isfinite(got).all())
    nmed = float((got - want).abs().mean() / want.abs().max())
    assert 0.0 < nmed < 10 * a.max_nmed


# --------------------------------------------------------- serving lane --


def test_allocation_lane_serves_with_no_plan_misses(port):
    from repro_torch.serving import (allocation_tier, build_engine,
                                     build_tiers, poisson_workload)
    from repro_torch.serving.workload import SimClock

    cfg = port["cfg"]
    a = allocate.autoallocate(port["lm"], 1e-2, evaluator=port["ev"])
    tier = allocation_tier(a, mode="hardware")
    assert tier.nmed == a.nmed and tier.cim.alloc == a.alloc
    assert tier.cim.mode == "hardware"
    tiers = build_tiers(families=("exact",)) + (tier,)
    eng = build_engine(cfg, port["params"], tiers=tiers, slots_per_tier=2,
                       max_len=24, prompt_buckets=(6,), group_buckets=(1, 2),
                       device="cpu")
    eng.warmup()
    wl = poisson_workload(6, rate=500.0, vocab=cfg.vocab,
                          prompt_len=(3, 6), max_new=(1, 4),
                          tier_mix=(("exact", None, 1.0),
                                    ("autoalloc", None, 1.0)), seed=9)
    res = eng.run(wl, clock=SimClock())
    assert all(r.done for r in res.values())
    assert {r.tier for r in res.values()} == {"exact", "autoalloc"}
    assert eng.steady_plan_misses() == 0
