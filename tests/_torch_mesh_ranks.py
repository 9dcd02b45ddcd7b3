"""Rank functions of the port's mesh tests (tests/test_torch_mesh*.py).

`repro_torch.launch.mesh.spawn` starts each rank in a fresh process that
imports its function by name, so they live here, in a module that
imports torch and the port only (no JAX: the tests compute the JAX
oracles in their own process and compare the ranks' numpy results)."""

import numpy as np
import torch

from repro_torch.core import approx_gemm as ag
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel.sharding import P

# (name, GemmParams kwargs): the reference's _TP_GEMM / _TP_CONV cases
GEMM_CASES = [
    ("exact/bit_exact", dict(family="exact", bits=8, mode="bit_exact")),
    ("exact/hardware", dict(family="exact", bits=8, mode="hardware")),
    ("appro42/hardware", dict(family="appro42", bits=8, mode="hardware",
                              n_approx_cols=6)),
    ("log_our/hardware", dict(family="log_our", bits=8, mode="hardware")),
    ("mitchell/hardware", dict(family="mitchell", bits=8, mode="hardware")),
]
CONV_CASES = [c for c in GEMM_CASES if not c[0].startswith("mitchell")]
CONV_GEOMS = [(3, 1), (3, 2), (5, 1)]
GEMM_LAYOUTS = [("K", P("data", "model"), P("model", None)),
                ("N", P("data", None), P(None, "model"))]
CONV_LAYOUTS = [("C", P("model", None)), ("N", P(None, "model"))]


def frontends(rank, world, device, x, w, xb, x4, conv_w):
    """The mesh frontends on a (2, 2) mesh: every case in both layouts,
    the bucket-bypass refusals after a warm call of the same bucket, and
    the plan misses of three sweeps over the tiers and the meshes (2, 2),
    (1, 4) and none after a warming sweep."""
    mesh = make_host_mesh(2)
    mesh_b = make_host_mesh(4)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    out = {}
    for name, kw in GEMM_CASES:
        gp = ag.GemmParams(**kw)
        for lname, xs, ws in GEMM_LAYOUTS:
            out[f"cim/{name}/{lname}"] = ag.cim_matmul(
                tx, tw, gp, mesh=mesh, x_spec=xs, w_spec=ws).numpy()
    gp = ag.GemmParams(family="exact", bits=8, mode="hardware")
    mm = ag.model_matmul(torch.from_numpy(xb).to(torch.bfloat16), tw, gp,
                         mesh=mesh, x_spec=P("data", "model"),
                         w_spec=P("model", None))
    out["model/dtype"] = str(mm.dtype)
    out["model/exact/hardware/K"] = mm.float().numpy()
    try:                  # m = 15 shares m = 16's bucket, not its split
        ag.cim_matmul(tx[:15], tw, gp, mesh=mesh, x_spec=P("data", "model"),
                      w_spec=P("model", None))
        out["bypass/gemm"] = None
    except ValueError as err:
        out["bypass/gemm"] = str(err)
    tx4 = torch.from_numpy(x4)
    for (kh, stride), w2 in zip(CONV_GEOMS, conv_w):
        for name, kw in CONV_CASES:
            gp = ag.GemmParams(**kw)
            for lname, ws in CONV_LAYOUTS:
                out[f"conv/{name}/{kh}x{kh}s{stride}/{lname}"] = \
                    ag.cim_conv2d(tx4, torch.from_numpy(w2), gp, kh=kh,
                                  kw=kh, stride=stride, mesh=mesh,
                                  x_spec=P("data", None, None, None),
                                  w_spec=ws).numpy()
    # 3x3 stride 3 is bit-safe at 8 x 8, not at 6 x 6; both bucket to 8
    gp = ag.GemmParams(family="exact", bits=8, mode="hardware")
    w2s = torch.from_numpy(conv_w[0])
    conv = dict(kh=3, kw=3, stride=3, mesh=mesh,
                x_spec=P("data", None, None, None), w_spec=P("model", None))
    ag.cim_conv2d(tx4, w2s, gp, **conv)
    try:
        ag.cim_conv2d(tx4[:, :6, :6], w2s, gp, **conv)
        out["bypass/conv"] = None
    except ValueError as err:
        out["bypass/conv"] = str(err)

    tiers = [ag.GemmParams(family="exact", bits=8, mode="hardware"),
             ag.GemmParams(family="log_our", bits=8, mode="hardware"),
             ag.GemmParams(family="exact", bits=8, mode="bit_exact")]

    def sweep():
        for gp in tiers:
            for m in (mesh, mesh_b, None):
                kw = {} if m is None else dict(
                    mesh=m, x_spec=P(None, "model"), w_spec=P("model", None))
                ag.cim_matmul(tx, tw, gp, **kw)

    sweep()
    mark = ag.plan_misses()
    for _ in range(3):
        sweep()
    out["steady_misses"] = ag.plan_misses() - mark
    out["comm_calls"] = mesh.comm["calls"] + mesh_b.comm["calls"]
    return out


def serve(rank, world, device, cfg_name, ladder, tree, reqs):
    """Serve `reqs` on a (2, 2) mesh with the given tier ladder over the
    carried weights; returns each request's (tier, tokens, logits), the
    plan misses after warmup and the collectives made."""
    from repro_torch.configs import get_config
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.serving import SimClock, build_engine

    mesh = make_host_mesh(2)
    cfg = get_config(cfg_name, smoke=True)
    eng = build_engine(cfg, params_from_numpy(tree, device), tiers=ladder,
                       slots_per_tier=4, max_len=32, prompt_buckets=(8,),
                       group_buckets=(1, 2, 4), record_logits=True,
                       device=device, mesh=mesh)
    eng.warmup()
    res = eng.run(reqs, clock=SimClock())
    return ({i: (r.tier, r.tokens, [np.asarray(a) for a in r.logits])
             for i, r in res.items()}, eng.steady_plan_misses(),
            mesh.comm["calls"])


# ---------------------------------------------------------------------------
# surrogate modes on shards (tests/test_torch_mesh_surrogate.py)
# ---------------------------------------------------------------------------

# (layout, x spec, w spec): the column-parallel (output-sharded) and the
# row-parallel (contraction-sharded) linear, rows over "data"
LINEAR_LAYOUTS = [("col", P("data", None), P(None, "model")),
                  ("row", P("data", "model"), P("model", None))]


def _linear_ctx(mode, key, name, w_spec, per_token=False):
    from repro_torch.core.compiler import CiMConfig
    from repro_torch.models.common import CiMContext, CiMParams

    family = dict(family="exact") if mode == "exact" else dict(
        family="appro42", compressor="orplane", n_approx_cols=10)
    p = CiMParams.from_config(CiMConfig(mode=mode, per_token=per_token,
                                        **family))
    return CiMContext(p, key=key, specs={name: w_spec}, row_axes=("data",))


def smoke_gemms(cfg):
    """(name, x, w) for every linear of a smoke layer: 8 rows of x (4 a
    data rank), weights at N(0, 0.05^2)."""
    d, ff = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_
    shapes = {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
              "mlp_wi": (d, ff), "mlp_wg": (d, ff), "mlp_wo": (ff, d)}
    rng = np.random.default_rng(21)
    return [(name, rng.standard_normal((8, k)).astype(np.float32),
             (rng.standard_normal((k, n)) * 0.05).astype(np.float32))
            for name, (k, n) in shapes.items()]


def reassembled(ranked, part, key, layout):
    """One output from the ranks' blocks `o[part][key]`: rows over
    "data", and for the column-parallel layout columns over "model"."""
    by = {(o["coords"]["data"], o["coords"]["model"]): o[part][key]
          for o in ranked}
    rows = []
    for d in range(2):
        parts = [by[(d, m)] for m in range(2)]
        if layout == "row":
            assert np.array_equal(parts[0], parts[1])   # the model group's
            rows.append(parts[0])
        else:
            rows.append(np.concatenate(parts, axis=-1))
    return np.concatenate(rows, axis=0)


def check_against_jax(got, want, tol):
    """tests/test_torch_lm.py's rule for an engine against the JAX
    engine, `got` and `want` {rid: (tokens, logits)}: up to a request's
    first differing token, every step's logits within `tol` of the JAX
    engine's and the same token wherever the JAX top-2 margin exceeds
    `tol`; under that gap the port's logit at the JAX token within `tol`
    of its largest.  Returns (steps checked above the gap, under it)."""
    checked = under_gap = 0
    for i, (tokens, logits) in want.items():
        got_tokens, got_logits = got[i]
        assert len(got_tokens) == len(tokens), i
        for step, (a, b) in enumerate(zip(got_logits, logits)):
            assert float(np.abs(a - b).max()) <= tol, (i, step)
            top2 = np.sort(b)[-2:]
            if top2[1] - top2[0] > tol:
                checked += 1
                assert got_tokens[step] == tokens[step], (i, step)
            else:
                under_gap += 1
                assert a[int(b.argmax())] >= a.max() - tol, (i, step)
            if got_tokens[step] != tokens[step]:
                break                  # the contexts differ from here on
    return checked, under_gap


def shard_linears(mesh, gemms, modes, per_token=False):
    """`cim_linear` on this rank's shards of each (name, x, w) of
    `gemms`, in both LINEAR_LAYOUTS, f32 and bf16, for each (mode, key
    seed or None) of `modes`: {(name, layout, dtype, mode, seed): f32
    numpy}."""
    from repro_torch.core.approx_gemm import NoiseKey
    from repro_torch.models.common import cim_linear
    from repro_torch.parallel.sharding import shard

    out = {}
    for name, x, w in gemms:
        for lname, xs, ws in LINEAR_LAYOUTS:
            for dt in (torch.float32, torch.bfloat16):
                xl = shard(torch.from_numpy(x).to(dt), xs, mesh)
                wl = shard(torch.from_numpy(w).to(dt), ws, mesh)
                for mode, seed in modes:
                    key = None if seed is None else NoiseKey(seed)
                    ctx = _linear_ctx(mode, key, name, ws, per_token)
                    with mesh:
                        y = cim_linear(xl, wl, ctx, name)
                    out[(name, lname, str(dt), mode, seed)] = \
                        y.float().numpy()
    return out


def surrogate(rank, world, device, gemms, modes, cfg_name, ladder, tree,
              reqs):
    """On a (2, 2) mesh: `cim_linear` on this rank's shards of each
    (name, x, w) of `gemms`, in both LINEAR_LAYOUTS, for each (mode, key
    seed or None) of `modes`; then `ladder` served over the carried
    weights with the telemetry attached.  Returns the shard outputs (f32
    numpy), the kernels' shapes the surrogate route gave them, the served
    results, plan misses, the run's dispatch MACs by family and the
    meters' MACs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cim_gemm
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.obs import EngineTelemetry, prometheus_text
    from repro_torch.serving import SimClock, build_engine

    mesh = make_host_mesh(2)
    seen = []
    real = {n: getattr(cim_gemm, n) for n in ("cim_gemm_fused",
                                              "cim_gemm_partial")}

    def spy(n):
        def call(x, w, *a, **kw):
            seen.append((n, tuple(x.shape), tuple(w.shape)))
            return real[n](x, w, *a, **kw)
        return call

    for n in real:
        setattr(cim_gemm, n, spy(n))
    try:
        out = shard_linears(mesh, gemms, modes)
    finally:
        for n, fn in real.items():
            setattr(cim_gemm, n, fn)

    tel = EngineTelemetry()
    cfg = get_config(cfg_name, smoke=True)
    eng = build_engine(cfg, params_from_numpy(tree, device), tiers=ladder,
                       slots_per_tier=4, max_len=32, prompt_buckets=(8,),
                       group_buckets=(1, 2, 4), record_logits=True,
                       device=device, mesh=mesh, telemetry=tel)
    eng.warmup()
    mac0 = dict(tel.dispatch_macs.values)
    met0 = sum(m.macs for m in tel.meters.values())
    res = eng.run(reqs, clock=SimClock())
    macs = {k: v - mac0.get(k, 0.0) for k, v in tel.dispatch_macs.values.items()}
    meters = sum(m.macs for m in tel.meters.values()) - met0
    text = prometheus_text(tel.registry)
    tel.detach()
    served = {i: (r.tier, r.tokens, [np.asarray(a) for a in r.logits])
              for i, r in res.items()}
    return {"gemms": out, "seen": seen, "served": served,
            "misses": eng.steady_plan_misses(), "macs": macs,
            "meters": meters, "prometheus": text,
            "coords": dict(mesh.coords)}


# ---------------------------------------------------------------------------
# per-token exact rungs on shards: spec decoding and sentinels
# (tests/test_torch_mesh_spec.py)
# ---------------------------------------------------------------------------

FAKE_VOCAB = 16


def _fake_row(slot, pos, drift):
    """A scripted logit row of slot `slot` at position `pos`: the
    reference's, plus, past position 5, `drift` times the positions past
    it in a fixed direction (the lane's): clean early (a probe's short
    prompt passes), drifting along a long request."""
    r = np.random.default_rng(97 * int(slot) + 7)
    ref = r.standard_normal(FAKE_VOCAB) + 0.1 * int(pos)
    return ref + drift * max(int(pos) - 5, 0) * r.standard_normal(FAKE_VOCAB)


class FakeRefLM:
    """The sentinel's reference LM double: `decode_multi` returns the
    scripted reference rows of the slots its caches name."""

    def __init__(self, mesh, row_axes):
        self.mesh, self.row_axes = mesh, row_axes

    def decode_multi(self, params, caches, tok, pos, data_parallel=False):
        assert data_parallel == (self.mesh is not None)
        rows = [_fake_row(s, p, 0.0)
                for s, p in zip(caches["slot_ids"], pos.tolist())]
        return torch.tensor(np.stack(rows))[:, None, :], caches


class FakePool:
    """A slot-pool lane double, data-parallel on a mesh like
    `LMLaneBackend` (this rank's slots [slot0, slot0 + n_local)); its
    decode logits are the whole pool's scripted rows, drifting by
    `drift` a position."""

    def __init__(self, n_slots, drift, mesh=None, row_axes=()):
        from types import SimpleNamespace

        self.n_slots, self.drift, self.mesh = n_slots, drift, mesh
        n_data = 1 if mesh is None else mesh.axes_size(row_axes)
        self.n_local = n_slots // n_data
        self.slot0 = 0 if mesh is None else mesh.index(row_axes) * \
            self.n_local
        self.max_len, self.max_group = 10_000, n_slots
        self.prompt_buckets = (4,)
        self.device = torch.device("cpu")
        self.lm = SimpleNamespace(cfg=SimpleNamespace(vocab=FAKE_VOCAB))
        self.caches = {"layers": [], "slot_ids": list(
            range(self.slot0, self.slot0 + self.n_local))}
        self.slot_tokens = np.zeros(n_slots, np.int64)
        self.slot_pos = np.zeros(n_slots, np.int64)
        self.last_decode_logits = None

    def prompt_bucket(self, plen):
        return 4

    def warmup(self):
        return 0

    def admit(self, prompts, slots):
        for p, s in zip(prompts, slots):
            self.slot_pos[s] = len(p)
            self.slot_tokens[s] = 1
        return np.ones(len(prompts), np.int64)

    def decode_round(self):
        lg = np.stack([_fake_row(s, self.slot_pos[s], self.drift)
                       for s in range(self.n_slots)])
        self.last_decode_logits = lg
        self.slot_tokens = lg.argmax(axis=-1)
        self.slot_pos += 1
        return self.slot_tokens.copy()


def fake_sentinel_run(mesh=None):
    """The engine with a real `LaneSentinel` on a drifting fake lane "b"
    (and a clean fake lane "a", the demotion target), stepped on a fixed
    schedule of times; returns every sample (agree, nmed, tripped), probe
    verdict and trip, and each request's status and tier."""
    from repro_torch.serving import (Request, SentinelConfig, ServingEngine,
                                     TierRouter)
    from repro_torch.serving.sentinel import LaneSentinel
    from repro_torch.serving.tiers import AccuracyTier

    axes = ("data",) if mesh is not None else ()
    tiers = [AccuracyTier(n, None, 0.001 * i, 1.0 + i)
             for i, n in enumerate(("a", "b"))]
    lanes = {"a": FakePool(4, 0.0, mesh, axes),
             "b": FakePool(4, 0.1, mesh, axes)}
    sen = LaneSentinel(FakeRefLM(mesh, axes), None, tiers[1].nmed,
                       SentinelConfig(period=1, window=2, min_samples=2,
                                      cooldown_s=0.3, probe_rounds=2))
    log = []
    observe, probe = sen.observe, sen.probe

    def observed(*a, **kw):
        tripped = observe(*a, **kw)
        log.append(("sample", sen.last_agree, sen.last_nmed, tripped))
        return tripped

    def probed(*a, **kw):
        ok = probe(*a, **kw)
        log.append(("probe", ok))
        return ok

    sen.observe, sen.probe = observed, probed
    eng = ServingEngine(lanes, TierRouter(tiers), check_invariants=True,
                        sentinels={"b": sen})
    eng.warmup()
    for i in range(6):
        eng.submit(Request(rid=i, prompt=np.zeros(3 + i % 2, np.int64),
                           max_new=6 + i, tier="ab"[i % 2]))
    for t in range(200):
        eng.step(0.1 * t)
        if all(r.done for r in eng.results.values()):
            break
    trips = [(e.lane, e.t, e.reason, e.tokens_before_trip)
             for e in eng.trip_log]
    results = {rid: (r.tier, r.status, r.tokens, r.retries)
               for rid, r in eng.results.items()}
    return log, trips, results


def fake_sentinel(rank, world, device):
    return fake_sentinel_run(make_host_mesh(2))


def spec(rank, world, device, cfg_name, tree, reqs, serve_args, gemms):
    """On a (2, 2) mesh: the admit scatter and `_rollback` of a sharded
    pool against one device's, `_float_tp`'s per-token rows alone and
    batched, the per-token exact `cim_linear` on the shards of each
    (name, x, w) of `gemms`, the spec + sentinel engine on the hardware
    ladder and the per-token exact engine over the carried weights (the
    latter with the telemetry and its logits), the fake-lane sentinel
    run, and launch/serve.py's `serve` on the surrogate ladder (rank 0's
    printed report)."""
    import contextlib
    import dataclasses
    import io

    from repro_torch.configs import get_config
    from repro_torch.core.compiler import CiMConfig
    from repro_torch.launch.serve import serve
    from repro_torch.models.bridge import params_from_numpy, shard_params
    from repro_torch.models.common import cim_linear
    from repro_torch.models.transformer import LM
    from repro_torch.obs import EngineTelemetry
    from repro_torch.parallel.sharding import shard
    from repro_torch.serving import (SentinelConfig, SimClock, build_engine,
                                     build_tiers)
    from repro_torch.serving.engine import LMLaneBackend
    from repro_torch.serving.spec import _rollback
    from repro_torch.serving.tiers import spec_pair

    mesh = make_host_mesh(2)
    cfg = get_config(cfg_name, smoke=True)
    params = params_from_numpy(tree, device)
    out = {"coords": dict(mesh.coords)}

    # the admit scatter and the rollback, on an integer lane (bitwise)
    lcfg = dataclasses.replace(cfg, cim=CiMConfig(family="exact", bits=8,
                                                  mode="hardware"))
    kw = dict(n_slots=8, max_len=16, prompt_buckets=(6,), group_buckets=(4,))
    host = LMLaneBackend(LM(lcfg, device), params, **kw)
    shrd = LMLaneBackend(LM(lcfg, device, mesh=mesh),
                         shard_params(params, cfg, mesh), mesh=mesh, **kw)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, (n,)) for n in (6, 4, 2)]
    host.admit(prompts, [0, 3, 5])
    shrd.admit(prompts, [0, 3, 5])
    rows = slice(shrd.slot0, shrd.slot0 + shrd.n_local)
    kv = shrd.caches["layers"][0]["k"].shape[-1]
    cols = slice(mesh.coords["model"] * kv, (mesh.coords["model"] + 1) * kv)

    def block(caches):
        return [(lay["k"][rows][..., cols].clone(),
                 lay["v"][rows][..., cols].clone(), lay["pos"][rows].clone())
                for lay in caches["layers"]]

    def local(caches):
        return [(lay["k"].clone(), lay["v"].clone(), lay["pos"].clone())
                for lay in caches["layers"]]

    def same(a, b):
        return all(torch.equal(x, y) for p, q in zip(a, b)
                   for x, y in zip(p, q))

    out["insert_equal"] = same(block(host.caches), local(shrd.caches))
    fill = torch.as_tensor(np.maximum(host.slot_pos - 1, 0), dtype=torch.int32)
    rb_h = _rollback(host.caches, fill, 3)
    with mesh:
        rb_s = _rollback(shrd.caches, fill[rows], 3)
    out["rollback_equal"] = same(block(rb_h), local(rb_s))
    del host, shrd

    # per-token rows on shards, batched and alone
    g = torch.Generator().manual_seed(3)
    pure = {}
    for lname, xs, ws in LINEAR_LAYOUTS:
        x = torch.randn(8, cfg.d_model, generator=g).to(torch.bfloat16)
        w = (torch.randn(cfg.d_model, cfg.d_model, generator=g)
             * 0.05).to(torch.bfloat16)
        xl, wl = shard(x, xs, mesh), shard(w, ws, mesh)
        ctx = _linear_ctx("exact", None, "wo", ws, per_token=True)
        with mesh:
            both = cim_linear(xl, wl, ctx, "wo")
            alone = torch.cat([cim_linear(xl[i:i + 1], wl, ctx, "wo")
                               for i in range(xl.shape[0])])
        pure[lname] = torch.equal(both, alone)
    out["row_pure"] = pure
    out["pt_gemms"] = shard_linears(mesh, gemms, [("exact", None)],
                                    per_token=True)

    # the spec + sentinel engine, and the per-token exact engine
    ladder = build_tiers(mode="hardware")
    ekw = dict(slots_per_tier=4, max_len=32, prompt_buckets=(8,),
               group_buckets=(1, 2, 4), device=device, mesh=mesh)
    eng = build_engine(cfg, params, tiers=ladder, spec_decode=2,
                       sentinel_cfg=SentinelConfig(period=2), **ekw)
    eng.warmup()
    res = eng.run(reqs, clock=SimClock())
    out["spec"] = {i: (r.tier, r.status, r.tokens) for i, r in res.items()}
    out["spec_misses"] = eng.steady_plan_misses()
    out["trips"] = [(e.lane, e.t, e.reason) for e in eng.trip_log]
    out["checks"] = {n: lane.sentinel.n_checks
                     for n, lane in eng.lanes.items()
                     if lane.sentinel is not None}
    sb = eng.lanes["exact"].backend
    out["accepted"] = (sb.n_rounds, sb.n_drafted, sb.n_accepted)
    del eng
    tel = EngineTelemetry()
    _, v_tier = spec_pair(ladder)
    eng = build_engine(cfg, params, tiers=(v_tier,), telemetry=tel,
                       record_logits=True, **ekw)
    eng.warmup()
    mac0 = dict(tel.dispatch_macs.values)
    res = eng.run([dataclasses.replace(r, tier="exact") for r in reqs],
                  clock=SimClock())
    out["per_token"] = {i: r.tokens for i, r in res.items()}
    out["per_token_logits"] = {i: [np.asarray(a) for a in r.logits]
                               for i, r in res.items()}
    out["macs"] = {k: v - mac0.get(k, 0.0)
                   for k, v in tel.dispatch_macs.values.items()}
    out["serving"] = {(m.name, k): v for m in (tel.tokens_c, tel.requests_c,
                                               tel.decode_rounds_c,
                                               tel.prefills_c)
                      for k, v in m.values.items()}
    tel.detach()
    del eng

    out["fake"] = fake_sentinel_run(mesh)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["launcher_ok"] = serve(serve_args, mesh, device)
    out["launcher"] = buf.getvalue()
    return out
