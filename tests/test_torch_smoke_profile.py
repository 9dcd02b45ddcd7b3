"""chip_smoke.py's profile summary (`_profile`): a profile that lost
kernels (the profiler recorded none, or fewer of the port's kernels than
the launch counters say the call launched) is left out and made again,
at most twice more, never divided by; the median and spread come from
the profiles that measured."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
