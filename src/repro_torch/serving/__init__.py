# Continuous-batching CiM serving engine: slot-pool KV caches,
# token-budget scheduler, per-request accuracy tiers routed to CiM
# configs through the DSE characterization.
from .engine import (AdmissionRejected, EngineStats, LaneHealthError,  # noqa: F401
                     LMLaneBackend, Request, RequestResult, ServingEngine,
                     build_engine, servable_archs)
from .tiers import AccuracyTier, TierRouter, build_tiers, spec_pair  # noqa: F401
from .workload import (Clock, RealClock, SharedClock, SimClock,  # noqa: F401
                       poisson_workload)
