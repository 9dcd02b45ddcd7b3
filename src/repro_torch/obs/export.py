"""Exporters: Prometheus text exposition, JSONL event dump, and
Chrome-trace/Perfetto span export (the JAX package's DESIGN.md §15), a
copy of its framework-free ``obs/export.py``: from the same registry
contents the output is byte-equal to the JAX package's.

All three render from one `MetricsRegistry` snapshot — the exporters
never mutate telemetry state, so they can run mid-serve (a scrape) or
at shutdown (the launcher's ``--metrics`` / ``--trace-out`` flags).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Optional

from .metrics import MetricsRegistry, Span


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _fmt_labels(pairs) -> str:
    if not pairs:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in pairs)
    return "{" + body + "}"


def prometheus_text(registry: MetricsRegistry) -> str:
    """Prometheus text exposition (format version 0.0.4) of every
    counter, gauge, and histogram in the registry, names sorted for a
    deterministic (golden-testable) output."""
    lines = []
    for c in sorted(registry.counters, key=lambda i: i.name):
        if c.help:
            lines.append(f"# HELP {c.name} {c.help}")
        lines.append(f"# TYPE {c.name} counter")
        for key in sorted(c.values):
            lines.append(f"{c.name}{_fmt_labels(key)} "
                         f"{_fmt_value(c.values[key])}")
    for g in sorted(registry.gauges, key=lambda i: i.name):
        if g.help:
            lines.append(f"# HELP {g.name} {g.help}")
        lines.append(f"# TYPE {g.name} gauge")
        for key in sorted(g.values):
            lines.append(f"{g.name}{_fmt_labels(key)} "
                         f"{_fmt_value(g.values[key])}")
    for h in sorted(registry.histograms, key=lambda i: i.name):
        if h.help:
            lines.append(f"# HELP {h.name} {h.help}")
        lines.append(f"# TYPE {h.name} histogram")
        for key in sorted(h.label_sets):
            snap = h.snapshot(**dict(key))
            for le, cum in snap["buckets"]:
                lines.append(
                    f"{h.name}_bucket"
                    f"{_fmt_labels(key + (('le', _fmt_value(le)),))} "
                    f"{_fmt_value(cum)}")
            lines.append(f"{h.name}_sum{_fmt_labels(key)} "
                         f"{_fmt_value(snap['sum'])}")
            lines.append(f"{h.name}_count{_fmt_labels(key)} "
                         f"{_fmt_value(snap['count'])}")
    return "\n".join(lines) + "\n"


def chrome_trace(spans: Iterable[Span], pid: int = 0,
                 process_name: str = "repro-serving",
                 tid_names: Optional[dict] = None) -> dict:
    """Chrome trace-event JSON (the format Perfetto / chrome://tracing
    load): one complete ("ph": "X") event per span, timestamps in
    microseconds on the engine clock, `tid` = the span's trace row
    (request id for lifecycle spans, a negative lane row for engine
    spans — name overrides via `tid_names`)."""
    events = [{
        "name": "process_name", "ph": "M", "pid": pid,
        "cat": "__metadata", "args": {"name": process_name},
    }]
    tid_names = tid_names or {}
    tids = set()
    for s in spans:
        tids.add(s.tid)
        events.append({
            "name": s.name,
            "cat": str(s.labels.get("cat", "serving")),
            "ph": "X",
            "ts": round(s.t0 * 1e6, 3),
            "dur": round(max(s.dur, 0.0) * 1e6, 3),
            "pid": pid,
            "tid": s.tid,
            "args": {k: v for k, v in s.labels.items() if k != "cat"},
        })
    for tid in sorted(tids):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "cat": "__metadata",
            "args": {"name": tid_names.get(
                tid, f"request {tid}" if tid >= 0 else "engine")},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans: Iterable[Span], path: str, **kw) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(spans, **kw), f, indent=1)


def _jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    return obj


def events_jsonl(events: Iterable[object],
                 path: Optional[str] = None) -> str:
    """Serialize the event stream one-JSON-object-per-line (structured
    trip/breaker/autotune events); returns the text, optionally also
    writing it to `path`."""
    text = "".join(json.dumps(_jsonable(e), sort_keys=True,
                              default=str) + "\n" for e in events)
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text
