"""chip_smoke.py's profile summary (`_profile`): a profile in which the
profiler recorded no kernel is left out and made again, never divided
by; the median and spread come from the profiles that measured."""

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
    (device busy ms, None where no kernel was recorded); return the
    list of calls made."""
    calls = []

    def once(torch, run):
        b = busy[len(calls)]
        calls.append(b)
        return (10.0, 7, 0 if b is None else 3, b,
                {} if b is None else {"CiM LUT kernel": 1e3 * b},
                {} if b is None else {"lut": 1e3 * b})

    monkeypatch.setattr(smoke, "_profile_once", once)
    return calls


@pytest.mark.parametrize("busy,made,kept,left_out", [
    ([4.0, 2.0, 3.0], 3, 3, 0),
    ([None, 4.0, 2.0, 3.0], 4, 3, 1),
    ([2.0, None, 4.0, None, 3.0], 5, 3, 2),
    ([None, 2.0, None, None], 4, 1, 3),
])
def test_profile_leaves_out_profiles_without_kernels(
        smoke, monkeypatch, capsys, busy, made, kept, left_out):
    calls = _feed(smoke, monkeypatch, busy)
    smoke._profile(None, "balanced", lambda: None, 0.02)
    out = capsys.readouterr().out
    assert len(calls) == made
    assert f"{kept} profiled runs: median" in out
    median = sorted(b for b in busy if b is not None)[kept // 2]
    assert f"device busy median {median:.2f} ms" in out
    assert ("recorded no kernel left out" in out) == bool(left_out)
    if left_out:
        assert f"{left_out} profile(s) that recorded no kernel" in out


def test_profile_with_no_kernel_in_any_run_says_not_measured(
        smoke, monkeypatch, capsys):
    calls = _feed(smoke, monkeypatch, [None, None, None])
    smoke._profile(None, "economy", lambda: None, 0.02)
    out = capsys.readouterr().out
    assert len(calls) == 3
    assert "device time not measured" in out
    assert "median" not in out
