"""Telemetry core: counters, gauges, histograms, span/event rings (the
JAX package's DESIGN.md §15).  A copy of the JAX package's
``obs/metrics.py``, which is framework-free: the same metric names, the
same label keying and the same gating on ``registry.enabled``, so that
the exporters render the same registry contents to the same bytes.  It
adds `Counter.inc_key`, which files a count under a label key built
once: the port's dispatch hook fires on every GEMM call.

Design contract (the overhead budget `launch/obs.py` measures: at most
3% serving tokens/s):

  * **Host-side only.**  Instruments record at dispatch boundaries
    (`core/approx_gemm.set_obs_sink`) and scheduler host steps
    (`obs/telemetry.EngineTelemetry`), never inside a kernel.  The port
    runs eagerly, so the dispatch hooks fire on every frontend call: a
    handful of dict updates per GEMM call and per scheduler tick.

  * **Preallocated rings.**  Spans and events land in fixed-capacity
    ring buffers allocated up front; steady-state recording never grows
    a Python list without bound, and overflow drops the *oldest*
    entries (the count is kept so exporters can report truncation).

  * **Near-zero when disabled.**  Every record path is gated on one
    attribute read (`registry.enabled`); a disabled registry reduces
    each instrument call to an attribute load + branch.

Metric naming scheme: ``repro_<subsystem>_<metric>[_total]`` with
snake_case label keys, e.g. ``repro_dispatch_calls_total{op="gemm",
family="appro42", mode="hardware"}`` — see `obs/export.prometheus_text`
for the exposition rules.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    """The (sorted, stringified) key an instrument files `labels` under."""
    return tuple(sorted((k, str(v)) for k, v in labels.items()))



class Counter:
    """Monotone counter, keyed by a (sorted) label tuple."""

    def __init__(self, name: str, help: str = "", registry=None):
        self.name, self.help = name, help
        self._reg = registry
        self.values: Dict[Tuple, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        if self._reg is not None and not self._reg.enabled:
            return
        key = label_key(labels)
        self.values[key] = self.values.get(key, 0.0) + n

    def inc_key(self, key: Tuple, n: float = 1.0) -> None:
        """`inc` under a `label_key` the caller built once: the port's
        dispatch hook runs on every GEMM call and memoizes its keys."""
        if self._reg is not None and not self._reg.enabled:
            return
        self.values[key] = self.values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        return self.values.get(label_key(labels), 0.0)

    @property
    def total(self) -> float:
        return sum(self.values.values())


class Gauge:
    """Last-write-wins value, keyed by a (sorted) label tuple."""

    def __init__(self, name: str, help: str = "", registry=None):
        self.name, self.help = name, help
        self._reg = registry
        self.values: Dict[Tuple, float] = {}

    def set(self, v: float, **labels) -> None:
        if self._reg is not None and not self._reg.enabled:
            return
        self.values[label_key(labels)] = float(v)

    def value(self, **labels) -> Optional[float]:
        return self.values.get(label_key(labels))


class Histogram:
    """Fixed-bucket histogram (cumulative on export, Prometheus-style).

    `buckets` are the finite upper bounds; an implicit +inf bucket
    catches the tail.  Observation is a bisect + three scalar updates —
    no allocation on the record path.
    """

    def __init__(self, name: str, buckets: Sequence[float],
                 help: str = "", registry=None):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError("histogram buckets must be a non-empty "
                             "ascending sequence")
        self.name, self.help = name, help
        self._reg = registry
        self.buckets = tuple(float(b) for b in buckets)
        # per label set: [count per bucket incl. +inf], sum, count
        self._counts: Dict[Tuple, List[float]] = {}
        self._sum: Dict[Tuple, float] = {}
        self._n: Dict[Tuple, int] = {}

    def observe(self, v: float, **labels) -> None:
        if self._reg is not None and not self._reg.enabled:
            return
        key = label_key(labels)
        counts = self._counts.get(key)
        if counts is None:
            counts = [0.0] * (len(self.buckets) + 1)
            self._counts[key] = counts
            self._sum[key] = 0.0
            self._n[key] = 0
        counts[bisect.bisect_left(self.buckets, v)] += 1
        self._sum[key] += v
        self._n[key] += 1

    def snapshot(self, **labels) -> Dict[str, object]:
        """(cumulative bucket counts, sum, count) for one label set."""
        key = label_key(labels)
        counts = self._counts.get(key, [0.0] * (len(self.buckets) + 1))
        cum, acc = [], 0.0
        for c in counts:
            acc += c
            cum.append(acc)
        return {"buckets": list(zip(self.buckets + (float("inf"),), cum)),
                "sum": self._sum.get(key, 0.0),
                "count": self._n.get(key, 0)}

    @property
    def label_sets(self) -> List[Tuple]:
        return list(self._counts)


@dataclasses.dataclass
class Span:
    """One timed interval on the engine clock (seconds)."""

    name: str
    t0: float
    dur: float
    tid: int = 0                      # trace row: request id / lane row
    labels: Dict[str, object] = dataclasses.field(default_factory=dict)


class Ring:
    """Fixed-capacity append-only ring: overflow drops the oldest.

    The buffer is preallocated once; `append` is an index store + two
    integer updates.  `items()` returns entries in insertion order.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.capacity = int(capacity)
        self._buf: List[object] = [None] * self.capacity
        self._head = 0                # next write index
        self._size = 0
        self.total = 0                # appends ever (dropped = total-size)

    def append(self, item) -> None:
        self._buf[self._head] = item
        self._head = (self._head + 1) % self.capacity
        self._size = min(self._size + 1, self.capacity)
        self.total += 1

    def __len__(self) -> int:
        return self._size

    @property
    def dropped(self) -> int:
        return self.total - self._size

    def items(self) -> List[object]:
        if self._size < self.capacity:
            return [x for x in self._buf[:self._size]]
        return self._buf[self._head:] + self._buf[:self._head]

    def clear(self) -> None:
        self._buf = [None] * self.capacity
        self._head = self._size = self.total = 0


class MetricsRegistry:
    """Instrument factory + span/event sink for one telemetry domain.

    One registry per engine (`EngineTelemetry` owns it); `enabled=False`
    turns every instrument into an attribute-load + branch no-op without
    detaching any hook.
    """

    def __init__(self, enabled: bool = True, span_capacity: int = 8192,
                 event_capacity: int = 4096):
        self.enabled = bool(enabled)
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self.spans = Ring(span_capacity)
        self.events = Ring(event_capacity)

    # -- instrument factories (idempotent by name) -------------------------
    def counter(self, name: str, help: str = "") -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name, help, self)
        return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, help, self)
        return g

    def histogram(self, name: str, buckets: Sequence[float],
                  help: str = "") -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, buckets, help,
                                                   self)
        return h

    # -- spans / events ----------------------------------------------------
    def span(self, name: str, t0: float, dur: float, tid: int = 0,
             **labels) -> None:
        if not self.enabled:
            return
        self.spans.append(Span(name, float(t0), float(dur), int(tid),
                               labels))

    def event(self, kind: str, t: float, **fields) -> None:
        if not self.enabled:
            return
        self.events.append({"kind": kind, "t": float(t), **fields})

    # -- introspection -----------------------------------------------------
    @property
    def counters(self) -> Iterable[Counter]:
        return self._counters.values()

    @property
    def gauges(self) -> Iterable[Gauge]:
        return self._gauges.values()

    @property
    def histograms(self) -> Iterable[Histogram]:
        return self._histograms.values()
