"""Synthetic serving workloads + clocks.

`poisson_workload` draws a Poisson arrival process (exponential
inter-arrival gaps at the given rate) over random prompts with mixed
accuracy tiers and generation lengths — the traffic shape the
continuous-batching engine is benchmarked under (bench_serve.py).

Clocks abstract "now" so the same engine loop serves both wall-clock
benchmarking (`RealClock`) and deterministic, instantly-advancing
property tests (`SimClock` — `wait_until` jumps instead of sleeping).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .engine import Request


class Clock:
    """The engine's single injectable time source.

    Everything downstream of the serving loop — scheduler ticks and
    throughput accounting (`engine.last_run_s`) — reads seconds from
    ONE clock, so tests are clock-independent.  `RealClock` backs
    wall-clock serving and
    benchmarking; `SimClock` backs deterministic scheduler tests.
    Implementations provide ``now() -> float`` and ``wait_until(t)``.
    """

    def now(self) -> float:
        raise NotImplementedError

    def wait_until(self, t: float) -> None:
        raise NotImplementedError


class RealClock(Clock):
    """Wall time; waiting sleeps (coarsely — the engine loop re-polls)."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def wait_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(min(dt, 0.05))


class SimClock(Clock):
    """Deterministic clock for scheduler tests: time only moves when the
    engine explicitly waits (idle with future arrivals pending)."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def wait_until(self, t: float) -> None:
        self.t = max(self.t, t)


def poisson_workload(n_requests: int, rate: float, vocab: int,
                     prompt_len: Tuple[int, int] = (8, 16),
                     max_new: Tuple[int, int] = (4, 32),
                     tier_mix: Optional[Sequence[Tuple[Optional[str],
                                                       Optional[float],
                                                       float]]] = None,
                     gen_mix: Optional[Sequence[Tuple[Tuple[int, int],
                                                      float]]] = None,
                     seed: int = 0) -> List[Request]:
    """Draw `n_requests` with exponential inter-arrival gaps (mean
    1/rate seconds), uniform prompt/generation lengths over the given
    inclusive ranges, and tiers sampled from `tier_mix` — a sequence of
    (tier_name, tolerance, probability) triples (name XOR tolerance per
    entry; defaults to everything on the exact tier).

    `gen_mix` replaces the single `max_new` range with a weighted
    mixture of ((lo, hi), probability) ranges — real serving traffic is
    heavy-tailed (many short answers, a few long generations), which is
    exactly the shape static batching handles worst (the whole batch
    idles until its longest member drains)."""
    rng = np.random.default_rng(seed)
    if tier_mix is None:
        tier_mix = ((None, 0.0, 1.0),)
    probs = np.asarray([w for _, _, w in tier_mix], np.float64)
    probs = probs / probs.sum()
    if gen_mix is None:
        gen_mix = ((tuple(max_new), 1.0),)
    gprobs = np.asarray([w for _, w in gen_mix], np.float64)
    gprobs = gprobs / gprobs.sum()
    t = 0.0
    out = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        glo, ghi = gen_mix[int(rng.choice(len(gen_mix), p=gprobs))][0]
        gen = int(rng.integers(glo, ghi + 1))
        name, tol, _ = tier_mix[int(rng.choice(len(tier_mix), p=probs))]
        out.append(Request(
            rid=i, prompt=rng.integers(0, vocab, (plen,), dtype=np.int64),
            max_new=gen, tier=name, tolerance=tol, arrival=t))
    return out
