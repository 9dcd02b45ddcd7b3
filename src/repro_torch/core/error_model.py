"""Error characterization + the calibrated surrogate coefficients.

`characterize(spec)` gives the exhaustive (<=10-bit) or sampled error
metrics of a multiplier: NMED, MRED, WCE, bias, one-sidedness, and the
Gaussian-weighted least-squares fit of the surrogate noise law

    e(a, b) = mu_rel * p + r,     E[r^2 | p] ~= c0_abs + c1_rel * p^2

(see the JAX package's module docstring for the derivation).

`characterize_batch(specs)` evaluates a whole spec grid with one torch
evaluation per bit width on a device (the card unless the caller asks
for the CPU): the bit-exact emulators of core/multipliers.py run on
int32 tensors, the stacked products come back to the host and are
reduced by the same float64 numpy routine as the serial path, so the
batched metrics are byte-equal to `characterize`'s and share its cache
rows.

Characterization is the DSE inner loop (`core/dse.enumerate_space`,
`serving/tiers.build_tiers`, `core/allocate.build_candidates`), so
results are cached in memory and on disk.  The port keeps its own cache
file (``OPENACM_TORCH_CHAR_CACHE``, default ``build/characterize.json``
in the repository checkout), written
atomically (per-PID temp + `os.replace`, merge-on-save) and read
defensively (a corrupt file is treated as cold).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .luts import MAX_LUT_BITS, build_lut
from .multipliers import MultiplierSpec, multiply_unsigned

# reference integer operand distribution for surrogate fitting: per-tensor
# symmetric quantization of ~N(0,1) data maps sigma to roughly qmax/3.2
_GAUSS_SIGMA_FRAC = 1.0 / 3.2

# the batched products are int32 tensors: unsigned products need 2*bits
# magnitude bits (the reference's limit with JAX's x64 off)
_MAX_BATCHED_BITS = 15


@dataclasses.dataclass(frozen=True)
class ErrorMetrics:
    nmed: float          # mean |err| / max product           (uniform)
    mred: float          # mean |err| / |exact|, nonzero exact (uniform)
    wce: int             # max |err|
    bias: float          # mean signed err                     (uniform)
    mu_rel: float        # gaussian-weighted LS slope of err on product
    c0_abs: float        # residual variance floor (int^2 units)
    c1_rel: float        # residual variance slope on p^2
    one_sided: bool
    exhaustive: bool

    @property
    def sigma_rel(self) -> float:
        return float(np.sqrt(self.c1_rel))


def _spec_key(spec: MultiplierSpec) -> Tuple:
    # constructor order: MultiplierSpec(*_spec_key(spec)) round-trips
    return (spec.family, spec.bits, spec.signed, spec.compressor,
            spec.n_approx_cols)


def _operands(bits: int, n_samples: int, seed: int):
    """(a, b, exhaustive): the same operand stream for the serial and the
    batched path — exhaustive grid below the LUT cap, else the seeded MC
    draw (two `integers` calls off one fresh Generator)."""
    if bits <= MAX_LUT_BITS:
        n = 1 << bits
        a, b = np.meshgrid(np.arange(n, dtype=np.int64),
                           np.arange(n, dtype=np.int64), indexing="ij")
        return a.ravel(), b.ravel(), True
    rng = np.random.default_rng(seed)
    hi = 1 << bits
    a = rng.integers(0, hi, n_samples, dtype=np.int64)
    b = rng.integers(0, hi, n_samples, dtype=np.int64)
    return a, b, False


def _error_grid(spec: MultiplierSpec, n_samples: int, seed: int):
    a, b, exhaustive = _operands(spec.bits, n_samples, seed)
    if exhaustive:
        return a, b, build_lut(spec).astype(np.int64).ravel(), True
    p = np.asarray(multiply_unsigned(a, b, spec), dtype=np.int64)
    return a, b, p, False


def _gauss_weights(a: np.ndarray, bits: int) -> np.ndarray:
    """Folded-gaussian pmf over unsigned magnitudes (signed symmetric)."""
    sigma = ((1 << (bits - 1)) - 1) * _GAUSS_SIGMA_FRAC
    return np.exp(-0.5 * (a / sigma) ** 2)


def _metrics_from_products(a: np.ndarray, b: np.ndarray, p: np.ndarray,
                           bits: int, exhaustive: bool) -> ErrorMetrics:
    """The metric/fit reduction, float64 numpy op for op as in the
    reference (equal metrics are a tested contract)."""
    exact = a * b
    err = (p - exact).astype(np.float64)
    maxp = float(((1 << bits) - 1) ** 2)
    nz = exact > 0
    rel = err[nz] / exact[nz].astype(np.float64)

    w = _gauss_weights(a, bits) * _gauss_weights(b, bits)
    w = w / w.sum()
    pf = exact.astype(np.float64)
    wp2 = float((w * pf * pf).sum())
    mu_rel = float((w * err * pf).sum() / max(wp2, 1e-30))
    r = err - mu_rel * pf
    r2 = r * r
    # weighted LS of r^2 on [1, p^2], clamped nonnegative
    p2 = pf * pf
    s1, sp2 = 1.0, float((w * p2).sum())
    sp4 = float((w * p2 * p2).sum())
    sr2 = float((w * r2).sum())
    sr2p2 = float((w * r2 * p2).sum())
    det = s1 * sp4 - sp2 * sp2
    if det > 1e-30:
        c0 = (sr2 * sp4 - sp2 * sr2p2) / det
        c1 = (s1 * sr2p2 - sp2 * sr2) / det
    else:
        c0, c1 = sr2, 0.0
    if c0 < 0.0:  # refit with c0 = 0
        c0, c1 = 0.0, sr2p2 / max(sp4, 1e-30)
    if c1 < 0.0:  # refit with c1 = 0
        c0, c1 = sr2, 0.0

    return ErrorMetrics(
        nmed=float(np.abs(err).mean() / maxp),
        mred=float(np.abs(rel).mean()),
        wce=int(np.abs(err).max()),
        bias=float(err.mean()),
        mu_rel=mu_rel,
        c0_abs=float(c0),
        c1_rel=float(c1),
        one_sided=bool((err <= 0).all() or (err >= 0).all()),
        exhaustive=exhaustive,
    )


# ---------------------------------------------------------------------------
# Characterization cache (memory + cross-process disk)
# ---------------------------------------------------------------------------

_ENV_CACHE = "OPENACM_TORCH_CHAR_CACHE"
_SCHEMA = "acm1"
_mem_cache: Dict[str, ErrorMetrics] = {}
_lock = threading.Lock()


def cache_path() -> str:
    default = Path(__file__).resolve().parents[3] / "build" / \
        "characterize.json"
    return os.environ.get(_ENV_CACHE, str(default))


def clear_memory_cache() -> None:
    with _lock:
        _mem_cache.clear()


def _cache_key(spec: MultiplierSpec, n_samples: int, seed: int) -> str:
    # below the LUT cap the metrics are exhaustive: independent of the
    # sample count and seed, so all (n, seed) requests share one row
    tail = ("exh" if spec.bits <= MAX_LUT_BITS
            else f"n{n_samples}:s{seed}")
    return (f"{_SCHEMA}:{spec.family}:b{spec.bits}:{spec.compressor}"
            f":c{spec.n_approx_cols}:sg{int(spec.signed)}:{tail}")


def _load_disk(path: str) -> Dict[str, ErrorMetrics]:
    """Parse the disk cache defensively: a corrupt/truncated file, a
    non-dict payload or malformed rows are ignored, never fatal."""
    try:
        with open(path) as fh:
            raw = json.load(fh)
    except (OSError, ValueError):
        return {}
    if not isinstance(raw, dict):
        return {}
    out: Dict[str, ErrorMetrics] = {}
    for k, v in raw.items():
        if not (isinstance(k, str) and k.startswith(_SCHEMA + ":")
                and isinstance(v, dict)):
            continue
        try:
            out[k] = ErrorMetrics(
                nmed=float(v["nmed"]), mred=float(v["mred"]),
                wce=int(v["wce"]), bias=float(v["bias"]),
                mu_rel=float(v["mu_rel"]), c0_abs=float(v["c0_abs"]),
                c1_rel=float(v["c1_rel"]), one_sided=bool(v["one_sided"]),
                exhaustive=bool(v["exhaustive"]))
        except (KeyError, TypeError, ValueError):
            continue
    return out


def _save_disk(path: str, table: Dict[str, ErrorMetrics]) -> None:
    """Atomic publish: per-PID temp + os.replace; a read-only filesystem
    degrades to memory-only caching."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "w") as fh:
            json.dump({k: dataclasses.asdict(v)
                       for k, v in sorted(table.items())}, fh, indent=1)
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass


def _store(rows: Dict[str, ErrorMetrics], path: str) -> None:
    with _lock:
        _mem_cache.update(rows)
        merged = _load_disk(path)
        merged.update(rows)
        _save_disk(path, merged)


# Observability sink: notified once per resolved spec with the cache
# outcome ("mem_hit" | "disk_hit" | "serial" | "batched").  Guarded with
# getattr, so a sink without the hook is left alone.
_OBS_SINK: List[Optional[object]] = [None]


def set_obs_sink(sink) -> Optional[object]:
    """Install the characterization telemetry sink (should expose
    ``char_cache(key, outcome)``); returns the previous one."""
    prev = _OBS_SINK[0]
    _OBS_SINK[0] = sink
    return prev


def _obs(key: str, outcome: str) -> None:
    sink = _OBS_SINK[0]
    if sink is not None:
        fn = getattr(sink, "char_cache", None)
        if fn is not None:
            fn(key=key, outcome=outcome)


def _cache_get(key: str, path: str) -> Optional[ErrorMetrics]:
    with _lock:
        if key in _mem_cache:
            _obs(key, "mem_hit")
            return _mem_cache[key]
    disk = _load_disk(path)
    if key in disk:
        with _lock:
            _mem_cache[key] = disk[key]
        _obs(key, "disk_hit")
        return disk[key]
    return None


# ---------------------------------------------------------------------------
# Serial + batched characterization
# ---------------------------------------------------------------------------


def characterize(spec: MultiplierSpec, n_samples: int = 200_000,
                 seed: int = 0, cache: bool = True,
                 cache_file: Optional[str] = None) -> ErrorMetrics:
    key = _cache_key(spec, n_samples, seed)
    path = cache_file or cache_path()
    if cache:
        hit = _cache_get(key, path)
        if hit is not None:
            return hit
    a, b, p, exhaustive = _error_grid(spec, n_samples, seed)
    m = _metrics_from_products(a, b, p, spec.bits, exhaustive)
    if cache:
        _store({key: m}, path)
    _obs(key, "serial")
    return m


def _products(spec_keys: Tuple[Tuple, ...], a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """The stacked int32 products of a whole spec group on the operands'
    device: the batched replacement for the per-spec numpy loop."""
    return torch.stack([
        multiply_unsigned(a, b, MultiplierSpec(*k)).to(torch.int32)
        for k in spec_keys])


def characterize_batch(specs: Sequence[MultiplierSpec],
                       n_samples: int = 200_000, seed: int = 0,
                       mesh=None, cache: bool = True,
                       cache_file: Optional[str] = None,
                       device=None) -> List[ErrorMetrics]:
    """Characterize a whole spec grid with one torch evaluation per bit
    width on `device` (the card unless ``device="cpu"``) instead of a
    serial per-spec numpy loop.

    Metrics are byte-equal to `characterize` (same operand stream, same
    host-side reduction) and land in the same caches.  Specs wider than
    the int32 product budget (bits > 15) and cache hits take the serial
    path.  `mesh` is the reference's sample-axis partition; the port
    runs on one card and takes None only."""
    from repro_torch.device import resolve_device

    if mesh is not None:
        raise ValueError(
            "characterize_batch runs on one device: a mesh partition of "
            "the samples is not ported (pass mesh=None)")
    dev = resolve_device(device)
    path = cache_file or cache_path()
    results: List[Optional[ErrorMetrics]] = [None] * len(specs)
    todo: List[int] = []
    seen: Dict[str, int] = {}
    for i, spec in enumerate(specs):
        key = _cache_key(spec, n_samples, seed)
        if cache:
            hit = _cache_get(key, path)
            if hit is not None:
                results[i] = hit
                continue
        todo.append(i)
        seen.setdefault(key, i)           # one compute per distinct key

    groups: Dict[int, List[int]] = {}
    for i in seen.values():
        groups.setdefault(specs[i].bits, []).append(i)

    fresh: Dict[str, ErrorMetrics] = {}
    for bits, idxs in sorted(groups.items()):
        a, b, exhaustive = _operands(bits, n_samples, seed)
        if bits <= _MAX_BATCHED_BITS:
            keys = tuple(_spec_key(specs[i]) for i in idxs)
            stacked = _products(
                keys, torch.from_numpy(a.astype(np.int32)).to(dev),
                torch.from_numpy(b.astype(np.int32)).to(dev),
            ).cpu().numpy().astype(np.int64)
            outcome = "batched"
        else:
            stacked = np.stack(
                [np.asarray(multiply_unsigned(a, b, specs[i]),
                            dtype=np.int64) for i in idxs])
            outcome = "serial"
        for row, i in enumerate(idxs):
            m = _metrics_from_products(a, b, stacked[row], bits,
                                       exhaustive)
            key = _cache_key(specs[i], n_samples, seed)
            results[i] = m
            fresh[key] = m
            _obs(key, outcome)
    if cache and fresh:
        _store(fresh, path)
    # duplicates of freshly computed keys resolve off the new rows
    for i in todo:
        if results[i] is None:
            results[i] = fresh[_cache_key(specs[i], n_samples, seed)]
    return results  # type: ignore[return-value]


@dataclasses.dataclass(frozen=True)
class SurrogateModel:
    """Calibrated (mu_rel, c0_abs, c1_rel) noise model for one multiplier."""

    mu_rel: float
    c0_abs: float
    c1_rel: float
    wce: int
    spec: MultiplierSpec

    @classmethod
    def fit(cls, spec: MultiplierSpec, **kw) -> "SurrogateModel":
        m = characterize(spec, **kw)
        return cls(mu_rel=m.mu_rel, c0_abs=m.c0_abs, c1_rel=m.c1_rel,
                   wce=m.wce, spec=spec)

    @classmethod
    def exact(cls, spec: MultiplierSpec) -> "SurrogateModel":
        return cls(0.0, 0.0, 0.0, 0, spec)

    @property
    def is_exact(self) -> bool:
        return self.mu_rel == 0.0 and self.c0_abs == 0.0 and self.c1_rel == 0.0

    @property
    def has_noise(self) -> bool:
        return self.c0_abs > 0.0 or self.c1_rel > 0.0
