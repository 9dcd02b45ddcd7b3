"""chip_smoke.py's profile summary (`_profile`): a profile that lost
kernels (the profiler recorded none, or fewer of the port's kernels than
the launch counters say the call launched) is left out and made again,
at most twice more, never divided by; the median and spread come from
the profiles that measured; every port kernel is told by its name; and
phase 2's checks of the nibble int form's and the attention kernels'
instantiations."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch ops, restored after it.
    Its ops are small; next to the other test workers on the same cores,
    torch's default pool (a thread a core) spends its time waiting for
    cores those workers hold, not computing."""
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _feed(smoke, monkeypatch, busy):
    """Make `_profile_once` return one profile per entry of `busy`
    (device busy ms; None where no kernel was recorded; ("lost", ms)
    where the profiler saw 2 of the call's 3 port kernels); return the
    list of calls made."""
    calls = []

    def once(torch, run):
        b = busy[len(calls)]
        calls.append(b)
        seen = 3
        if isinstance(b, tuple):
            b, seen = b[1], 2
        return {"wall_ms": 10.0, "n_ops": 7,
                "n_kern": 0 if b is None else 3, "busy_ms": b,
                "span_ms": 9.5, "launched": 3,
                "seen": 0 if b is None else seen,
                "by_class": {} if b is None else {"CiM LUT kernel": 1e3 * b},
                "by_name": {} if b is None else {"lut": 1e3 * b}}

    monkeypatch.setattr(smoke, "_profile_once", once)
    return calls


@pytest.mark.parametrize("busy,made,kept,left_out", [
    ([4.0, 2.0, 3.0], 3, 3, 0),
    ([None, 4.0, 2.0, 3.0], 4, 3, 1),
    ([2.0, None, 4.0, None, 3.0], 5, 3, 2),
    ([None, 2.0, None, None, None], 5, 1, 4),
    ([("lost", 1.0), 4.0, 2.0, 3.0], 4, 3, 1),
    ([("lost", 1.0), 2.0, None, 4.0, 5.0], 5, 3, 2),
])
def test_profile_leaves_out_profiles_without_kernels(
        smoke, monkeypatch, capsys, busy, made, kept, left_out):
    calls = _feed(smoke, monkeypatch, busy)
    smoke._profile(None, "balanced", lambda: None, 0.02)
    out = capsys.readouterr().out
    assert len(calls) == made
    assert f"{kept} profiled runs: median" in out
    median = sorted(b for b in busy
                    if b is not None and not isinstance(b, tuple))[kept // 2]
    assert f"device busy median {median:.2f} ms" in out
    assert "CUDA-event span median 9.50 ms" in out
    assert out.count("lost kernels") == left_out
    assert f"{left_out} profile(s) left out" in out


def test_profile_with_no_kernel_in_any_run_says_not_measured(
        smoke, monkeypatch, capsys):
    calls = _feed(smoke, monkeypatch, [None] * 5)
    smoke._profile(None, "economy", lambda: None, 0.02)
    out = capsys.readouterr().out
    assert len(calls) == 5
    assert "device time not measured" in out
    assert "median" not in out


@pytest.mark.parametrize("name, cls", [
    ("_ZN3cim24surrogate_cluster_kernelILi16ELi64ELb1ELb1EEEvNS_6SgArgsE",
     "CiM surrogate kernel"),
    ("_ZN3cim21int8_mma_dense_kernelILb1EEEvPKaS2_PiPfiiii",
     "CiM surrogate kernel"),
    ("_ZN3cim11gemm_kernelINS_9IntSqCoreENS_5DenseIaEEaNS_7CoreOutEEEvT0_",
     "CiM surrogate kernel"),
    ("_ZN3cim19cluster_gemm_kernelINS_14ClusterLogCoreILb1EEELi4ELi64EEEvNS_"
     "6ClArgsE", "CiM log kernel"),
    ("_ZN3cim19cluster_gemm_kernelINS_14ClusterLogCoreILb0EEELi64ELi32ENS_"
     "8ScaleOutEEEvNS_6ClArgsE", "CiM log kernel"),
    ("_ZN3cim19cluster_gemm_kernelINS_14ClusterLutCoreELi4ELi64ENS_"
     "8ScaleOutEEEvNS_6ClArgsE", "CiM LUT kernel"),
    ("_ZN3cim19cluster_gemm_kernelINS_14ClusterLutCoreELi64ELi64ENS_"
     "6IntOutEEEvNS_6ClArgsE", "CiM LUT kernel"),
    ("_ZN3cim19cluster_gemm_kernelINS_17ClusterMagLutCoreELi16ELi64ENS_"
     "6IntOutEEEvNS_6ClArgsE", "CiM LUT kernel"),
    ("_ZN3cim19cluster_gemm_kernelINS_14ClusterLogCoreILb0EEELi4ELi64ENS_"
     "6IntOutEEEvNS_6ClArgsE", "CiM log kernel"),
    ("_ZN3cim19cluster_gemm_kernelINS_17ClusterNibbleCoreELi4ELi64ENS_"
     "6IntOutEEEvNS_6ClArgsE", "CiM nibble kernel"),
    ("_ZN3cim24surrogate_partial_kernelILi16ELi64ELb0EEEvNS_6SgArgsE",
     "CiM surrogate partial"),
    ("void cim::surrogate_partial_kernel<64, 32, true>(cim::SgArgs)",
     "CiM surrogate partial"),
    ("_ZN3cim19cluster_gemm_kernelINS_14ClusterLutCoreELi4ELi64ENS_"
     "11QuantIntOutEEEvNS_6ClArgsE", "CiM partial kernel"),
    ("_ZN3cim19cluster_gemm_kernelINS_14ClusterLogCoreILb1EEELi16ELi64ENS_"
     "11QuantIntOutEEEvNS_6ClArgsE", "CiM partial kernel"),
    ("_ZN3cim11gemm_kernelINS_7LogCoreILb1EEENS_7ConvSrcIfEEfNS_11QuantIntOut"
     "EEEvT0_PKT1_PKhPKfSB_PNT2_3OutES8_iiii", "CiM partial kernel"),
    ("_ZN3cim16conv_tile_kernelINS_7TileLogILb1EEELi4ELi1EEEvNS_6CtArgsE",
     "CiM conv kernel"),
    ("_ZN3cim20int8_mma_conv_kernelEPKfS1_S1_S1_PfNS_8ConvGeomEii",
     "CiM conv kernel"),
    ("_ZN4attn19attn_cluster_kernelILi1ELb0EEEvNS_6AcArgsE",
     "CiM attention kernel"),
    ("_ZN4attn19attn_cluster_kernelILi1ELb0ELi1EEEvNS_6AcArgsE",
     "CiM attention kernel"),
    ("void attn::attn_cluster_kernel<3, true, 2>(attn::AcArgs)",
     "CiM attention kernel"),
    ("void attn::attn_cluster_kernel<3, true>(attn::AcArgs)",
     "CiM attention kernel"),
    ("_ZN45_GLOBAL__N__a1670d44_12_attn_gemm_cu_b6a0606011attn_kernelILi3ELb1E"
     "sLi0EEEvNS_4ArgsE", "CiM attention kernel"),
    ("_ZN5slstm20slstm_cluster_kernelENS_6SlArgsE", "sLSTM scan"),
    ("slstm::slstm_cluster_kernel(slstm::SlArgs)", "sLSTM scan"),
    ("_ZN46_GLOBAL__N__53a415f7_13_slstm_scan_cu_8df9e1a012slstm_kernelEPKf"
     "S1_S1_S1_S1_S1_S1_PfS2_S2_S2_S2_iiii", "sLSTM scan")],
    ids=lambda v: v[-30:])
def test_port_kernels_are_told_by_name(smoke, name, cls):
    """The profile counts a port kernel by its class (PORT_CLASSES), read
    from its mangled name: every kernel of the port's wrappers has one."""
    assert smoke._kernel_class(name, set()) == cls
    assert cls in smoke.PORT_CLASSES


@pytest.mark.parametrize("busy,kept,left_out", [
    ([4.0, 2.0, 3.0, 5.0, 6.0], 3, 0),
    ([None, ("lost", 1.0), 4.0, 2.0, 3.0], 3, 2),
    ([None, None, None, 2.0, None], 1, 4)])
def test_profile_reads_records_made_elsewhere(smoke, monkeypatch, capsys,
                                              busy, kept, left_out):
    """Phase 9: rank 0 makes MESH_PROFILE_ROUNDS records while every rank
    decodes; `_profile(made=...)` takes them in order under the same
    rule, never profiles a call itself, and never reads past them."""
    records = []
    _feed(smoke, monkeypatch, busy)
    for _ in busy:
        records.append(smoke._profile_once(None, None))
    calls = _feed(smoke, monkeypatch, [])       # any call would fail
    assert len(busy) == smoke.MESH_PROFILE_ROUNDS
    smoke._profile(None, "balanced", None, 0.02, made=records)
    out = capsys.readouterr().out
    assert not calls
    assert f"{kept} profiled runs: median" in out
    assert out.count("lost kernels") == left_out


_NIB = ("_ZN3cim19cluster_gemm_kernelINS_17ClusterNibbleCoreELi{}ELi64ENS_{}"
        "EEEvNS_6ClArgsE")
_NIB_TEMPLATE = ("_ZN3cim11gemm_kernelINS_10NibbleCoreENS_5DenseIaEEaNS_"
                 "6IntOutEEEvT0_PKT1_PKhPKfSB_PNT2_3OutES8_iiii")


@pytest.mark.parametrize("names, ok", [
    ([_NIB.format(r, e) for r in (4, 16)
      for e in ("6IntOut", "8ScaleOut", "11QuantIntOut")], True),
    ([_NIB.format(4, "6IntOut"), _NIB.format(16, "11QuantIntOut")], False),
    ([_NIB.format(r, "6IntOut") for r in (4, 16)] + [_NIB_TEMPLATE], False),
], ids=["shipped", "int_rows_16_missing", "template_left"])
def test_phase_2_requires_the_nibble_int_instantiations(smoke, monkeypatch,
                                                        capsys, names, ok):
    """Phase 2 reads libnibble_gemm's functions: the int form's cluster
    instantiations (ClusterNibbleCore with IntOut at rows 4 and 16, the
    partial form's QuantIntOut not counting) must all be there, and no
    tiled template kernel on NibbleCore; else the run fails."""
    from repro_torch.kernels import sass

    monkeypatch.setattr(sass, "disassemble", lambda path: path)
    monkeypatch.setattr(sass, "functions",
                        lambda text: {n: [] for n in names})

    class Build:
        @staticmethod
        def library_path(name):
            assert name == "nibble_gemm"
            return name

    if ok:
        smoke.nibble_int_check(Build)
        assert "for RB [4, 16] in libnibble_gemm" in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit):
            smoke.nibble_int_check(Build)


_ATTN = "_ZN4attn19attn_cluster_kernelILi{}ELb{}ELi{}EEEvNS_6AcArgsE"
_ATTN_TEMPLATE = ("_ZN45_GLOBAL__N__a1670d44_12_attn_gemm_cu_b6a0606011attn_"
                  "kernelILi{}ELb{}E{}Li{}EEEvNS_4ArgsE")
_KINDS = ((0, 0), (1, 0), (2, 0), (3, 0), (3, 1))


def _attn_names(modes=(0, 1, 2), kinds=_KINDS):
    return [_ATTN.format(p, c, m) for p, c in kinds for m in modes] + [
        _ATTN_TEMPLATE.format(p, c, "s" if p == 3 else "a", m)
        for p, c in _KINDS for m in (0, 1, 2)]


@pytest.mark.parametrize("names, ok", [
    (_attn_names(), True),
    (_attn_names(modes=(0,)), False),
    (_attn_names(kinds=_KINDS[:4]), False),
    (_attn_names()[:15], False),
], ids=["shipped", "oracle_modes_missing", "log_our_missing",
        "template_missing"])
def test_phase_2_requires_the_attention_instantiations(smoke, monkeypatch,
                                                       capsys, names, ok):
    """Phase 2 reads libattn_gemm's functions: the cluster kernel in each
    of its modes (fused, scores, PV) on each path, log as mitchell and
    log_our, and the template in each of its three modes (the 9..12-bit
    log operands' route and the witness) must all be there; else the run
    fails."""
    from repro_torch.kernels import sass

    monkeypatch.setattr(sass, "disassemble", lambda path: path)
    monkeypatch.setattr(sass, "functions",
                        lambda text: {n: [] for n in names})

    class Build:
        @staticmethod
        def library_path(name):
            assert name == "attn_gemm"
            return name

    if ok:
        smoke.attn_instances_check(Build)
        assert "15 each" in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit):
            smoke.attn_instances_check(Build)


def same_as_the_tree(smoke, prof):
    """Hold `_profile_read` of a finished torch.profiler run to what
    `_profile_once` read from the profiler's own event list before it:
    the device events as (name, microseconds), the top-level aten ops and
    the kernels MATMUL_OPS launched.  Returns them."""
    from torch.autograd import DeviceType

    events = prof.events()
    want = (sorted((e.name, round(e.time_range.elapsed_us(), 3))
                   for e in events if e.device_type == DeviceType.CUDA),
            sum(1 for e in events if e.device_type == DeviceType.CPU
                and e.cpu_parent is None and e.name.startswith("aten::")),
            {k.name for e in events if e.name in smoke.MATMUL_OPS
             for k in e.kernels})
    kern, n_ops, mm = smoke._profile_read(prof)
    got = (sorted((n, round((e - s) / 1e3, 3)) for n, s, e in kern), n_ops,
           mm)
    assert got == want
    return got


def test_profile_read_counts_the_ops_of_the_profilers_tree(smoke):
    """`_profile_read` counts the top-level aten ops that the profiler's
    own event tree does: ops nested in ops and in a record_function range
    (whose matmul is not top-level), in-place ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(16, 32)

    def run():
        for _ in range(5):
            with record_function("block"):
                y = torch.matmul(x, x.T)
            z = torch.nn.functional.linear(x, x).relu()
            torch.cat([y, z]).softmax(-1).sum()
            x.add_(0).mul_(1)

    run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    kern, n_ops, mm = same_as_the_tree(smoke, prof)
    assert kern == [] and mm == set() and n_ops >= 5 * 5


@pytest.mark.parametrize("phases, ok", [
    (["3"], True), (["13"], True), (["5", "13"], True), (["2"], False),
    (["14"], True), (["12", "14"], True), (["15"], False),
    (["13", "15"], False),
], ids=["3", "13", "5_13", "2", "14", "12_14", "15", "13_15"])
def test_phases_take_3_to_14(smoke, phases, ok):
    """`--phases` runs phases 3 to 14 (1 and 2 always run)."""
    if ok:
        assert smoke.parse_args(["--phases", *phases]).phases == \
            [int(p) for p in phases]
    else:
        with pytest.raises(SystemExit):
            smoke.parse_args(["--phases", *phases])
    assert smoke.parse_args([]).phases is None


def test_phase_9_serves_8_layers_at_the_published_widths(smoke,
                                                         monkeypatch):
    """Phase 9's config, and every engine of its parts (c) hardware, (e)
    and (g) surrogate with the telemetry, (f) the spec lane with
    sentinels and the per-token exact engine): 8 of qwen3-1.7b's layers
    at its published widths; (d)'s shard GEMMs at the LM's shapes."""
    from types import SimpleNamespace

    from repro_torch import serving
    from repro_torch.configs import get_config

    full = get_config("qwen3-1.7b")
    cfg = smoke._mesh_config()
    assert (cfg.n_layers, cfg.n_periods) == (8, 8)
    assert len(cfg.layer_pattern) == 8
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) \
        == (full.d_model, full.n_heads, full.n_kv_heads, full.d_ff,
            full.vocab)
    built = []
    monkeypatch.setattr(serving, "build_engine", lambda c, **kw: (
        built.append((c, kw)), SimpleNamespace(lanes={}))[1])
    tel = object()
    smoke._mesh_engine(cfg)
    smoke._mesh_engine(cfg, mode="surrogate", telemetry=tel)
    smoke._mesh_spec_engine(cfg)
    smoke._per_token_exact_engine(cfg)
    assert [c for c, _ in built] == [cfg] * 4
    modes = [{t.cim.mode for t in kw["tiers"]} for _, kw in built]
    assert modes == [{"exact", "hardware"}, {"exact", "surrogate"},
                     {"exact", "hardware"}, {"exact"}]
    assert built[1][1]["telemetry"] is tel
    assert built[2][1]["spec_decode"] == smoke.MESH_SPEC_K
    assert built[2][1]["sentinel_cfg"].period == smoke.MESH_SENTINEL_PERIOD
    assert [t.cim.per_token for t in built[3][1]["tiers"]] == [True]
    assert {(k, n) for _, k, n in smoke.MAIN_SHAPES} == set(
        smoke.WEIGHT_SHAPES)
    assert {(full.d_model, full.n_heads * full.head_dim_),
            (full.d_model, full.d_ff), (full.d_ff, full.d_model)} <= set(
        smoke.WEIGHT_SHAPES)


def test_chip_smoke_phase_13_rehearsed_on_the_cpu(smoke, monkeypatch):
    """chip_smoke.py's phase 13 end to end on the CPU at the smoke config
    (the kernels' plain versions; fewer characterization samples): (a)
    byte-equal, (b) the truth table (here the CPU's against itself), the
    oracle and the search within the budget, (c) an allocation that is
    not all-exact, (d) the ladder served twice with no plan built, the
    all-balanced table bitwise the balanced tier; the launch check
    expects the card's counts while the CPU launches nothing.  The
    profiler stands in for the card's."""
    import torch

    from repro_torch.configs import get_config

    monkeypatch.setattr(smoke, "ALLOC_DEVICE", "cpu")
    monkeypatch.setattr(smoke, "ALLOC_CHAR_SAMPLES", 2000)
    monkeypatch.setattr(smoke, "_alloc_config",
                        lambda: get_config("qwen3-1.7b", smoke=True))
    profiled = []
    monkeypatch.setattr(smoke, "_profile", lambda torch, lane, run, s, **kw: (
        profiled.append(lane), run()))
    checks = []
    monkeypatch.setattr(smoke, "_expect_launches",
                        lambda where, got, want: checks.append(
                            (where, got, want)))
    launches = smoke.alloc_phase(torch, "cpu")
    assert not any(launches.values())
    assert profiled == ["autoalloc"]
    [(where, got, want)] = checks
    assert got == {} and want
    assert set(want) <= {"lut_matmul_fused", "mitchell_matmul_fused",
                         "nibble_lut_matmul_fused"}
    # one launch a layer per module on its multiplier, a forward
    n_layers = get_config("qwen3-1.7b", smoke=True).n_layers
    assert all(v % n_layers == 0 and v > 0 for v in want.values())


def test_chip_smoke_phase_14_rehearsed_on_the_cpu(smoke, monkeypatch):
    """chip_smoke.py's phase 14 end to end on the CPU at the smoke config
    (the kernels' plain versions, two off/on pairs): the overhead runs'
    checks (tokens identical, no plan built, live MACs = the meters'),
    the launch check, which expects the card's fused surrogate launches
    while the CPU launches nothing, a profiled decode round a lane, and
    the trace's spans.  The profiler stands in for the card's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import obs

    cfg = get_config("qwen3-1.7b", smoke=True)
    monkeypatch.setattr(smoke, "OBS_DEVICE", "cpu")
    monkeypatch.setattr(smoke, "_obs_config", lambda: cfg)
    monkeypatch.setattr(obs, "PAIRS", 2)
    profiled = []

    def profile(torch, lane, run, s, **kw):
        profiled.append(lane)
        run()
        return {"by_class": {"CiM surrogate kernel": 1.0}}

    monkeypatch.setattr(smoke, "_profile", profile)
    checks = []
    monkeypatch.setattr(smoke, "_expect_launches",
                        lambda where, got, want: checks.append(
                            (where, got, want)))
    launches = smoke.obs_phase(torch, "cpu")
    assert not any(launches.values())
    assert profiled == ["exact", "balanced", "economy"]
    [(where, got, want)] = checks
    assert got == {} and list(want) == ["cim_gemm_fused"]
    per_fwd = smoke.GEMMS_PER_LAYER * cfg.n_layers
    assert want["cim_gemm_fused"] > 0
    assert want["cim_gemm_fused"] % per_fwd == 0
