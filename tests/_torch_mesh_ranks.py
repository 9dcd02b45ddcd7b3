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
