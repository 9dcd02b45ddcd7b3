"""PyTorch port, mesh-partitioned execution (the JAX package's DESIGN.md
§11) on the CPU: the partial kernels' plain versions, the sharding rules,
the mesh plans' refusals, and the mesh frontends on a (2, 2) gloo mesh of
four processes, held to the JAX package.

  * the plain partials bitwise against the JAX ``*_partial`` kernels in
    interpret mode, given the same inputs and global scales;
  * `logical_to_spec` / `batch_axes` equal to the JAX rules on the cases
    of tests/test_sharding_dryrun.py;
  * the refusals of tests/test_mesh_dispatch.py (float modes, a weight
    sharded on K and N, dims that do not divide, an unsafe conv
    geometry, and a shape whose bucket was planned but which does not
    divide);
  * `cim_matmul` / `model_matmul` / `cim_conv2d` with a mesh, in both
    layouts, bitwise equal to the JAX single-device call on the
    reference's _TP_GEMM / _TP_CONV cases.  Each operand's max |x| (per
    tensor) and max |w| (per column) is 127 * 2^k, so its scale is a
    power of two and the reference's jitted rewrite of x / (m / qmax)
    cannot move a quantized code;
  * no plan built in three sweeps over tiers and meshes after a warming
    one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx_gemm as jag
from repro.core.luts import nibble_sub_luts, signed_product_lut
from repro.core.multipliers import MultiplierSpec as JSpec
from repro.kernels.approx_matmul import lut_matmul_partial as j_lut_p
from repro.kernels.approx_matmul import nibble_lut_matmul_partial as j_nib_p
from repro.kernels.conv_gemm import conv_log_partial as j_conv_log_p
from repro.kernels.conv_gemm import conv_lut_partial as j_conv_lut_p
from repro.kernels.mitchell_gemm import mitchell_matmul_partial as j_log_p
from repro.parallel import sharding as jsh
from repro_torch.core import approx_gemm as ag
from repro_torch.core.multipliers import MultiplierSpec
from repro_torch.kernels import approx_matmul, conv_gemm, mitchell_gemm, ops
from repro_torch.launch.mesh import spawn
from repro_torch.parallel import sharding as tsh

import _torch_mesh_ranks as ranks

# ---------------------------------------------------------------------------
# the plain partials against the JAX partial kernels
# ---------------------------------------------------------------------------

SHAPES = [(8, 16, 8), (33, 70, 17)]
# (core, family, compressor, n_approx_cols): the balanced tier's table, the
# exact family's sub-tables, appro42 with 4 approximate columns, the logs
KERNEL_CASES = [("lut", "appro42", "orplane", 10), ("lut", "exact", "yang1",
                                                     None),
                ("nibble", "exact", "yang1", None),
                ("nibble", "appro42", "yang1", 4),
                ("log", "mitchell", "yang1", None),
                ("log", "log_our", "yang1", None)]


def _global_scales(x, w, widen: float):
    """Scales of a tensor `widen` times larger than this shard (a global
    max over the shards is at least the local one)."""
    sx = np.float32(np.abs(x).max() * np.float32(widen) / np.float32(127))
    sw = (np.abs(w.reshape(-1, w.shape[-1])).max(axis=0)
          * np.float32(widen) / np.float32(127)).astype(np.float32)
    return sx, sw


def _tables(family, comp, nac, nibble):
    spec = MultiplierSpec(family, 8, True, comp, nac)
    js = JSpec(family, 8, True, comp, nac)
    if nibble:
        return ops.nibble_table(spec, "cpu"), nibble_sub_luts(js).ravel()
    return ops.lut_table(spec, "cpu"), signed_product_lut(js).ravel()


@pytest.mark.parametrize("widen", [1.0, 1.6])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("case", KERNEL_CASES, ids=str)
def test_gemm_partial_plain_matches_jax_kernel(case, shape, widen):
    core, family, comp, nac = case
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    sx, sw = _global_scales(x, w, widen)
    tx, tw, tsx, tsw = (torch.from_numpy(x), torch.from_numpy(w),
                        torch.tensor(sx), torch.from_numpy(sw))
    jx, jw, jsx, jsw = map(jnp.asarray, (x, w, sx, sw))
    if core == "log":
        c = family == "log_our"
        got = mitchell_gemm.mitchell_matmul_partial(tx, tw, tsx, tsw,
                                                    compensated=c)
        want = j_log_p(jx, jw, jsx, jsw, compensated=c, interpret=True)
    else:
        ttab, jtab = _tables(family, comp, nac, core == "nibble")
        kern, jkern = ((approx_matmul.nibble_lut_matmul_partial, j_nib_p)
                       if core == "nibble"
                       else (approx_matmul.lut_matmul_partial, j_lut_p))
        got = kern(tx, tw, ttab, tsx, tsw)
        want = jkern(jx, jw, jnp.asarray(jtab), jsx, jsw, interpret=True)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


# (B, H, W, C, N, kh, kw, stride): a Table IV conv at a small batch with C
# halved, and the reference tests' ragged geometries
CONV_SHAPES = [(2, 8, 8, 8, 16, 3, 3, 1), (2, 9, 10, 5, 7, 3, 3, 1),
               (2, 10, 9, 3, 6, 3, 3, 2)]


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
@pytest.mark.parametrize("case", KERNEL_CASES[1:], ids=str)
def test_conv_partial_plain_matches_jax_kernel(case, shape):
    core, family, comp, nac = case
    b, h, w_, c, n, kh, kw, s = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((b, h, w_, c)).astype(np.float32)
    w3 = (rng.standard_normal((kh * kw, c, n)) * 0.1).astype(np.float32)
    sx, sw = _global_scales(x, w3, 1.3)
    geo = dict(kh=kh, kw=kw, stride=s)
    targs = (torch.from_numpy(x), torch.from_numpy(w3))
    jargs = (jnp.asarray(x), jnp.asarray(w3))
    tsc = (torch.tensor(sx), torch.from_numpy(sw))
    jsc = (jnp.asarray(sx), jnp.asarray(sw))
    if core == "log":
        c_ = family == "log_our"
        got = conv_gemm.conv_log_partial(*targs, *tsc, compensated=c_, **geo)
        want = j_conv_log_p(*jargs, *jsc, compensated=c_, interpret=True,
                            **geo)
    else:
        nib = core == "nibble"
        ttab, jtab = _tables(family, comp, nac, nib)
        got = conv_gemm.conv_lut_partial(*targs, ttab, *tsc, nibble=nib,
                                         **geo)
        want = j_conv_lut_p(*jargs, jnp.asarray(jtab), *jsc, nibble=nib,
                            interpret=True, **geo)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_partials_are_the_fused_forms_before_the_epilogue():
    """ops' scaled fused forms equal the partial forms and (acc * sx) * sw,
    bit for bit, for every core."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((9, 40)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((40, 12)) * 0.1).astype(
        np.float32))
    sx, sw = ops._scales(x, w, 8)
    spec = MultiplierSpec("appro42", 8, True, "orplane", 10)
    ex = MultiplierSpec("exact", 8, True)
    pairs = [(ops.lut_partial_acc(x, w, spec, sx, sw),
              ops.lut_fused_scaled(x, w, spec, sx, sw)),
             (ops.nibble_partial_acc(x, w, ex, sx, sw),
              ops.nibble_fused_scaled(x, w, ex, sx, sw)),
             (ops.log_partial_acc(x, w, sx, sw),
              ops.log_fused_scaled(x, w, sx, sw))]
    for acc, fused in pairs:
        assert torch.equal(approx_matmul.epilogue(acc, sx, sw), fused)
    x4 = torch.from_numpy(rng.random((2, 6, 6, 4)).astype(np.float32))
    w3 = torch.from_numpy(rng.standard_normal((9, 4, 5)).astype(np.float32))
    s4, s5 = ops._scales(x4, w3.reshape(-1, 5), 8)
    for nib, sp in ((False, spec), (True, ex)):
        acc = ops.conv2d_lut_partial(x4, w3, sp, s4, s5, nibble=nib)
        fused = ops.conv2d_lut_fused_scaled(x4, w3, sp, s4, s5, nibble=nib)
        assert torch.equal((acc.float() * s4) * s5, fused)
    acc = ops.conv2d_log_partial(x4, w3, s4, s5, compensated=False)
    fused = ops.conv2d_log_fused_scaled(x4, w3, s4, s5, compensated=False)
    assert torch.equal((acc.float() * s4) * s5, fused)


# ---------------------------------------------------------------------------
# sharding rules against the JAX package's
# ---------------------------------------------------------------------------


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


M2 = {"data": 4, "model": 4}
M3 = {"pod": 2, "data": 4, "model": 4}
# (mesh shape, logical spec, tensor shape): tests/test_sharding_dryrun.py's
RULE_CASES = [
    (M2, ("embed", "ff"), (64, 128)), (M2, ("vocab", "embed"), (1000, 64)),
    (M3, ("batch", None), (32, 7)),
    (M2, ("embed", "heads", None), (64, 10, 16)),
    (M2, ("vocab", None), (3, 8)), (M2, ("embed", "batch"), (64, 32)),
    (M2, ("ff", "vocab"), (64, 64)), (M3, ("batch", "embed"), (32, 64)),
    (M3, ("embed", "batch"), (64, 32)), (M3, ("embed", "batch"), (64, 31)),
    (M2, ("embed", "ff"), (66, 67)),
    ({"data": 2, "model": 2}, ("embed", "heads", None), (64, 4, 16)),
]


@pytest.mark.parametrize("rules", ["default", "decode"])
@pytest.mark.parametrize("mesh,spec,shape", RULE_CASES, ids=str)
def test_logical_to_spec_matches_the_reference(mesh, spec, shape, rules):
    fake = _FakeMesh(mesh)
    jr = jsh.DEFAULT_RULES if rules == "default" else jsh.DECODE_RULES
    tr = tsh.DEFAULT_RULES if rules == "default" else tsh.DECODE_RULES
    want = tuple(jsh.logical_to_spec(spec, shape, fake, jr))
    assert tuple(tsh.logical_to_spec(spec, shape, fake, tr)) == want


@pytest.mark.parametrize("mesh,dim0", [(M2, None), (M2, 8), (M2, 6),
                                       (M3, 16), (M3, 4),
                                       ({"data": 1, "model": 1}, 8)],
                         ids=str)
def test_batch_axes_matches_the_reference(mesh, dim0):
    fake = _FakeMesh(mesh)
    assert tsh.batch_axes(fake, dim0) == jsh.batch_axes(fake, dim0)


def test_shard_cuts_contiguous_blocks():
    """A mesh's `shard` keeps the block of this rank's coordinates (row-
    major over composite axes)."""
    from repro_torch.launch.mesh import Mesh

    t = torch.arange(32).reshape(4, 8)
    mesh = Mesh({"data": 2, "model": 2})
    mesh.coords = {"data": 1, "model": 0}
    spec = tsh.P("data", "model")
    assert torch.equal(tsh.shard(t, spec, mesh), t[2:4, 0:4])
    # over (data, model) this rank's index is 1 * 2 + 0 = 2 of 4
    assert torch.equal(tsh.shard(t, tsh.P(None, ("data", "model")), mesh),
                       t[:, 4:6])


# ---------------------------------------------------------------------------
# the mesh plans' refusals (shapes only: no ranks needed)
# ---------------------------------------------------------------------------

_MESH = _FakeMesh({"data": 2, "model": 4})


# (name, mode, m, k, x_spec, w_spec, error): tests/test_mesh_dispatch.py's
REFUSALS = [
    ("exact-mode", "exact", 16, 64, None, ("model", None), "integer modes"),
    ("surrogate", "surrogate", 16, 64, None, ("model", None),
     "integer modes"),
    ("surrogate_fast", "surrogate_fast", 16, 64, None, ("model", None),
     "integer modes"),
    ("double-sharded", "hardware", 16, 64, None, ("model", "data"),
     "both K .* and N"),
    ("K=63", "hardware", 16, 63, None, ("model", None), "not divisible"),
    ("M=15", "hardware", 15, 64, ("data", None), ("model", None),
     "not divisible"),
]


@pytest.mark.parametrize("name,mode,m,k,x_spec,w_spec,match", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_mesh_plan_refuses(name, mode, m, k, x_spec, w_spec, match):
    with pytest.raises(ValueError, match=match):
        ag.plan_gemm("exact", mode, 8, m, k, 32, "cpu", mesh=_MESH,
                     x_spec=None if x_spec is None else tsh.P(*x_spec),
                     w_spec=tsh.P(*w_spec))
    with pytest.raises(ValueError, match=match):
        jag.plan_gemm("exact", mode, 8, m, k, 32, mesh=_MESH,
                      x_spec=x_spec, w_spec=w_spec)


def test_mesh_conv_refuses_an_unsafe_geometry():
    # stride 4 > kernel 3: unsampled pixels, the per-tensor scale unsafe
    with pytest.raises(ValueError, match="bit-safe"):
        ag.plan_conv("exact", "hardware", 8, 4, 8, 8, 16, 8,
                     ag.ConvParams(3, 3, 4), "cpu", mesh=_MESH,
                     w_spec=tsh.P("model", None))
    with pytest.raises(ValueError, match="batch .* only"):
        ag.plan_conv("exact", "hardware", 8, 4, 8, 8, 16, 8,
                     ag.ConvParams(3, 3, 1), "cpu", mesh=_MESH,
                     x_spec=tsh.P(None, "data", None, None),
                     w_spec=tsh.P("model", None))


@pytest.mark.parametrize("what", ["per_token", "fault"])
def test_mesh_frontends_refuse_per_token_and_faults(what):
    gp = ag.GemmParams(family="exact", bits=8, mode="hardware")
    object.__setattr__(gp, what, True if what == "per_token" else object())
    x, w = torch.zeros(4, 8), torch.zeros(8, 4)
    with pytest.raises(ValueError, match=what.replace("_", "-")
                       if what == "per_token" else "fault injection"):
        ag.cim_matmul(x, w, gp, mesh=_MESH, w_spec=tsh.P("model", None))


# ---------------------------------------------------------------------------
# the mesh frontends on a (2, 2) gloo mesh against the JAX oracle
# ---------------------------------------------------------------------------


def _pinned(rng, shape, col_pow=None):
    """Normal values whose max |v| is exactly 127 * 2^k per tensor
    (k = -3, col_pow None) or per column (exponents col_pow), so every
    scale is a power of 2."""
    v = rng.standard_normal(shape).astype(np.float32)
    flat = v.reshape(-1, shape[-1])
    if col_pow is None:
        peak = np.float32(127 * 2.0 ** -3)
        flat *= peak / np.abs(flat).max() * np.float32(0.999)
        i = np.unravel_index(np.abs(flat).argmax(), flat.shape)
        flat[i] = np.copysign(peak, flat[i])
    else:
        peak = (np.float32(127) * np.exp2(col_pow)).astype(np.float32)
        flat *= peak / np.abs(flat).max(axis=0) * np.float32(0.999)
        rows = np.abs(flat).argmax(axis=0)
        cols = np.arange(flat.shape[1])
        flat[rows, cols] = np.copysign(peak, flat[rows, cols])
    return flat.reshape(shape)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = _pinned(rng, (16, 64))
    w = _pinned(rng, (64, 32), col_pow=rng.integers(-9, -5, 32))
    xb = np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())
    x4 = _pinned(rng, (4, 8, 8, 16))
    conv_w = [_pinned(rng, (kh * kh * 16, 8),
                      col_pow=rng.integers(-9, -5, 8))
              for kh, _ in ranks.CONV_GEOMS]
    res = spawn(ranks.frontends, 4, device="cpu", threads=1, timeout=300,
                args=(x, w, xb, x4, conv_w),
                workdir=str(tmp_path_factory.mktemp("mesh")))
    return (x, w, xb, x4, conv_w), res


def _jgp(kw):
    return jag.GemmParams(**kw)


@pytest.mark.parametrize("layout", ["K", "N"])
@pytest.mark.parametrize("name,kw", ranks.GEMM_CASES,
                         ids=[c[0] for c in ranks.GEMM_CASES])
def test_mesh_cim_matmul_bitwise_equals_jax_single_device(mesh_run, name, kw,
                                                          layout):
    (x, w, *_), res = mesh_run
    want = np.asarray(jag.cim_matmul(jnp.asarray(x), jnp.asarray(w),
                                     _jgp(kw)))
    mine = ag.cim_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         ag.GemmParams(**kw)).numpy()
    assert np.array_equal(mine, want)
    for r in res:                       # every rank holds the whole result
        assert np.array_equal(r[f"cim/{name}/{layout}"], want)


def test_mesh_model_matmul_keeps_bf16_bitwise(mesh_run):
    (x, w, xb, *_), res = mesh_run
    kw = dict(family="exact", bits=8, mode="hardware")
    want = np.asarray(jag.model_matmul(jnp.asarray(xb, jnp.bfloat16),
                                       jnp.asarray(w), _jgp(kw)),
                      np.float32)
    for r in res:
        assert r["model/dtype"] == "torch.bfloat16"
        assert np.array_equal(r["model/exact/hardware/K"], want)


@pytest.mark.parametrize("layout", ["C", "N"])
@pytest.mark.parametrize("geom", ranks.CONV_GEOMS, ids=str)
@pytest.mark.parametrize("name,kw", ranks.CONV_CASES,
                         ids=[c[0] for c in ranks.CONV_CASES])
def test_mesh_cim_conv2d_bitwise_equals_jax_single_device(mesh_run, name, kw,
                                                          geom, layout):
    (_, _, _, x4, conv_w), res = mesh_run
    kh, stride = geom
    w2 = conv_w[ranks.CONV_GEOMS.index(geom)]
    want = np.asarray(jag.cim_conv2d(jnp.asarray(x4), jnp.asarray(w2),
                                     _jgp(kw), kh=kh, kw=kh, stride=stride))
    for r in res:
        assert np.array_equal(
            r[f"conv/{name}/{kh}x{kh}s{stride}/{layout}"], want)


@pytest.mark.parametrize("what", ["gemm", "conv"])
def test_mesh_bucket_bypass_raises(mesh_run, what):
    """A shape whose bucket a warm call planned, but which does not split
    (m = 15 over 2 data ranks) or is not bit-safe (6 x 6 at stride 3),
    raises on every rank instead of reusing the plan."""
    _, res = mesh_run
    match = "not divisible" if what == "gemm" else "bit-safe"
    for r in res:
        assert r[f"bypass/{what}"] is not None
        assert (match in r[f"bypass/{what}"])


def test_no_plans_built_across_mesh_and_tier_switches(mesh_run):
    _, res = mesh_run
    for r in res:
        assert r["steady_misses"] == 0
        assert r["comm_calls"] > 0
