# Continuous-batching CiM serving engine: slot-pool KV caches,
# token-budget scheduler, per-request accuracy tiers routed to CiM
# configs through the DSE characterization, and per-lane accuracy
# sentinels with graceful tier degradation.
from repro_torch.core.faults import FaultConfig  # noqa: F401

from .engine import (AdmissionRejected, EngineStats, LMLaneBackend,  # noqa: F401
                     Request, RequestResult, ServingEngine, TripEvent,
                     build_engine, servable_archs)
from .sentinel import (CircuitBreaker, LaneHealthError, LaneSentinel,  # noqa: F401
                       RollingStats, SentinelConfig)
from .tiers import (AccuracyTier, TierRouter, allocation_tier,  # noqa: F401
                    build_tiers, spec_pair)
from .workload import (Clock, RealClock, SharedClock, SimClock,  # noqa: F401
                       poisson_workload)
