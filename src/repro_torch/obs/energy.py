"""Energy/accuracy metering: attribute `core/energy_model` per-MAC
estimates to live serving traffic (the JAX package's DESIGN.md §15).

The dispatch frontends (`core/approx_gemm`) announce every GEMM / conv /
attention call, with its exact MAC count, to the installed obs sink.
The meter builds **per-call MAC profiles once**, at engine warmup, and at
serve time counts *invocations* of each profiled call (decode rounds,
(G, P)-bucket prefills, spec sub-rounds) and multiplies.

The reference profiles abstractly, with ``jax.eval_shape`` under a
scoped `MacCapture` (no FLOPs).  The port has no such evaluation that
reaches the frontends: they choose a route by the operands' device type
and the CUDA entries refuse meta tensors.  So `LaneEnergyMeter.build`
profiles by *running* each steady-state call once, under
``torch.inference_mode()`` and a scoped `MacCapture`, at the shapes
warmup already ran (so it builds no plan).  The pool decode and the spec
sub-round write K/V into the lane's caches; the engine's warmup clears
them with each backend's ``reset()`` after profiling, before it arms its
plan-miss probe.  The reference scales MACs captured in a ``lax.scan``
body by the stack depth (``obs_mac_scale``); the port runs its layers in
a Python loop, so every layer's call is announced and nothing is scaled.
On a mesh every rank profiles its own slots' calls, and every frontend
of the shard paths announces the global product's MACs (m over the data
axes, k and n over the model axis), so each rank's meters count the
global MACs, as the unsharded engine's do.

Energy = sum over captured (family, bits) of macs *
`energy_model.energy_per_mac_j`: the paper's FreePDK45 anchors (a model
number, not a measurement of any device), making **estimated energy per
token per tier** a serving metric.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple


class MacCapture:
    """Dispatch sink that accumulates MAC counts by (family, bits) and
    by op kind; satisfies the full sink protocol so it can be installed
    anywhere a telemetry sink can."""

    def __init__(self):
        self.by_family: Dict[Tuple[str, int], float] = {}
        self.by_op: Dict[str, float] = {}
        self.total = 0.0

    def dispatch(self, op: str, family: str, mode: str, bits: int,
                 macs: float, cache_hit: bool) -> None:
        key = (family, int(bits))
        self.by_family[key] = self.by_family.get(key, 0.0) + macs
        self.by_op[op] = self.by_op.get(op, 0.0) + macs
        self.total += macs

    def retrace(self) -> None:
        pass

    def autotune(self, key: str, outcome: str) -> None:
        pass


@contextlib.contextmanager
def capture_macs():
    """Scoped MAC capture: installs a `MacCapture` as the dispatch sink
    and restores the previous sink on exit."""
    from repro_torch.core import approx_gemm

    cap = MacCapture()
    prev = approx_gemm.set_obs_sink(cap)
    try:
        yield cap
    finally:
        approx_gemm.set_obs_sink(prev)


def profile_macs(fn, *args, **kwargs) -> MacCapture:
    """MAC profile of one call of `fn(*args, **kwargs)`, run under
    ``torch.inference_mode()`` on its operands' device (the port's
    stand-in for the reference's abstract ``jax.eval_shape``)."""
    import torch

    with capture_macs() as cap, torch.inference_mode():
        fn(*args, **kwargs)
    return cap


def macs_to_energy_j(by_family: Dict[Tuple[str, int], float],
                     fallback_j_per_mac: Optional[float] = None) -> float:
    """Convert a (family, bits) -> macs profile to Joules via the
    paper's per-MAC anchors; families the energy model does not cover
    fall back to `fallback_j_per_mac` (or contribute 0)."""
    from repro_torch.core import energy_model

    total = 0.0
    for (family, bits), macs in by_family.items():
        try:
            e = energy_model.energy_per_mac_j(family, bits)
        except (KeyError, ValueError):
            e = fallback_j_per_mac or 0.0
        total += macs * e
    return total


class LaneEnergyMeter:
    """Per-lane invocation counting over pre-built MAC profiles.

    `build(backend)` profiles the lane's steady-state calls (pool
    decode, every (G, P) prefill bucket, spec sub-rounds per draft
    depth): call it from engine warmup, before the plan-miss probe arms,
    and reset the backend after it.  The `on_*` hooks then cost a dict
    lookup + float adds per scheduler event and return the energy
    increment so the caller can attribute shares to live requests.
    """

    def __init__(self, name: str,
                 fallback_j_per_mac: Optional[float] = None):
        self.name = name
        self.fallback_j_per_mac = fallback_j_per_mac
        self.profiled = False
        self.macs = 0.0
        self.energy_j = 0.0
        self.tokens = 0
        self.n_decode_rounds = 0
        self.n_prefills = 0
        self.n_spec_subrounds = 0
        self._decode: Tuple[float, float] = (0.0, 0.0)   # (macs, J)
        self._prefill: Dict[Tuple[int, int], Tuple[float, float]] = {}
        self._spec: Dict[int, Tuple[float, float]] = {}
        self._g_buckets: Tuple[int, ...] = ()
        self._p_buckets: Tuple[int, ...] = ()

    # -- profile construction (warmup-time) --------------------------------
    def _cost(self, cap: MacCapture) -> Tuple[float, float]:
        return (cap.total, macs_to_energy_j(cap.by_family,
                                            self.fallback_j_per_mac))

    def build(self, backend) -> bool:
        """Profile an `LMLaneBackend`-shaped lane by running each of its
        steady-state calls once; returns False (meter stays inert) for
        backends without the LM surface (fake lanes)."""
        import torch

        if not all(hasattr(backend, a) for a in
                   ("lm", "params", "caches", "prompt_buckets",
                    "group_buckets", "n_slots", "max_len")):
            return False
        lm, params, caches = backend.lm, backend.params, backend.caches
        dev = backend.device
        b = backend.n_local            # this rank's slots (all without a mesh)
        mesh = backend.mesh is not None
        tok = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        self._decode = self._cost(profile_macs(
            lm.decode_step, params, caches, tok, pos, data_parallel=mesh))
        for g in backend.group_buckets:
            for p in backend.prompt_buckets:
                cap = profile_macs(lm.prefill, params, {
                    "tokens": torch.zeros((g, p), dtype=torch.int64,
                                          device=dev),
                    "lengths": torch.full((g,), p, dtype=torch.int32,
                                          device=dev),
                    "max_len": backend.max_len})
                self._prefill[(g, p)] = self._cost(cap)
        for k in getattr(backend, "draft_ks", ()):
            # one spec sub-round = k drafter steps + one (k+1)-wide
            # verify (runtime counting is per executed sub-round)
            d = profile_macs(backend.drafter_lm.decode_step, params, caches,
                             tok, pos, data_parallel=mesh)
            v = profile_macs(lm.decode_multi, params, caches,
                             torch.zeros((b, k + 1), dtype=torch.int64,
                                         device=dev), pos,
                             data_parallel=mesh)
            self._spec[k] = (
                k * d.total + v.total,
                k * macs_to_energy_j(d.by_family, self.fallback_j_per_mac)
                + macs_to_energy_j(v.by_family, self.fallback_j_per_mac))
        self._g_buckets = tuple(backend.group_buckets)
        self._p_buckets = tuple(backend.prompt_buckets)
        self.profiled = True
        return True

    # -- serve-time counting ------------------------------------------------
    @staticmethod
    def _bucket_up(v: int, buckets: Tuple[int, ...]) -> int:
        for b in buckets:
            if b >= v:
                return b
        return buckets[-1] if buckets else v

    def _add(self, cost: Tuple[float, float]) -> float:
        m, j = cost
        self.macs += m
        self.energy_j += j
        return j

    def on_decode(self) -> float:
        """One full-pool decode round; returns the Joule increment."""
        self.n_decode_rounds += 1
        return self._add(self._decode)

    def on_prefill(self, n_prompts: int, prompt_len: int) -> float:
        """One grouped prefill (bucketed to the profiled (G, P))."""
        self.n_prefills += 1
        g = self._bucket_up(n_prompts, self._g_buckets)
        p = self._bucket_up(prompt_len, self._p_buckets)
        return self._add(self._prefill.get((g, p), (0.0, 0.0)))

    def on_spec_rounds(self, k: int, n_subrounds: int) -> float:
        """`n_subrounds` executed draft+verify sub-rounds at depth k."""
        self.n_spec_subrounds += n_subrounds
        m, j = self._spec.get(k, (0.0, 0.0))
        self.macs += m * n_subrounds
        self.energy_j += j * n_subrounds
        return j * n_subrounds

    def add_tokens(self, n: int) -> None:
        self.tokens += n

    @property
    def energy_per_token_j(self) -> float:
        return self.energy_j / max(self.tokens, 1)
