# Runtime telemetry (the JAX package's DESIGN.md §15): host-side metrics
# core, dispatch-boundary instrumentation sinks, energy metering over the
# paper's per-MAC anchors, and Prometheus / JSONL / Perfetto exporters.
# Records only on the host, never inside a kernel.
from .energy import (LaneEnergyMeter, MacCapture, capture_macs,  # noqa: F401
                     macs_to_energy_j, profile_macs)
from .export import (chrome_trace, events_jsonl, prometheus_text,  # noqa: F401
                     write_chrome_trace)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                      Ring, Span)
from .telemetry import EngineTelemetry  # noqa: F401
