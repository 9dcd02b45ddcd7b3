"""PyTorch port, xLSTM blocks and the sLSTM recurrence, the xlstm-125m
configs and the bridge of its weights, held to the JAX package on the
CPU (the kernel's plain version; the CUDA kernel is held
to it on the card in tests/test_torch_gpu.py and chip_smoke.py).

Tolerances:
  * the sLSTM recurrence 3e-5 (rtol and atol), the reference kernel
    test's: f32 throughout, exp/tanh/log1p and the recurrent dot's sum
    order differ in the last ulps between the two frameworks;
  * the mLSTM chunkwise scan and step 2e-4 against JAX (f32 einsums in
    another order, exp of stabilized logs), and chunkwise against
    sequential 2e-4, the reference block test's;
  * the blocks against JAX 1e-2 with CiM off and 4e-2 on the integer
    tiers (bf16 activations at |out| ~0.1: a bf16 rounding at another
    place, and on the integer tiers a quantization code moved by it, as
    tests/test_torch_lm.py states for the dense layers).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.compiler import CiMConfig as JCiMConfig
from repro.kernels.ref import slstm_scan_ref as j_scan_ref
from repro.kernels.slstm_scan import slstm_scan as j_scan
from repro.models import xlstm as jx
from repro.models.common import CiMContext as JCtx
from repro.models.common import CiMParams as JParams
from repro.models.common import unbox
from repro.models.transformer import LM as JLM
from repro.models.transformer import count_params as jcount_params
from repro.serving.tiers import build_tiers as jbuild_tiers
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import slstm_scan as tscan
from repro_torch.kernels.ref import slstm_scan_ref
from repro_torch.models import xlstm as tx
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.common import CiMContext as TCtx
from repro_torch.models.common import CiMParams as TParams
from repro_torch.models.transformer import count_params
from repro_torch.serving.tiers import build_tiers as tbuild_tiers

SCAN_TOL = 3e-5
MLSTM_TOL = 2e-4
BLOCK_TOL = {"off": 1e-2, "balanced": 4e-2, "economy": 4e-2}
ARCH = "xlstm-125m"


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _scan_inputs(b, t, nh, dh, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, t, 4 * nh * dh)).astype(np.float32)
    r = (rng.standard_normal((nh, dh, 4 * dh)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal((nh, 4 * dh)) * 0.1).astype(np.float32)
    return u, r, bias


def _state(b, nh, dh, seed):
    """A nonzero state as a run leaves it: c, h within [-1, 1], n > 0."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (b, nh, dh)).astype(np.float32)
    n = rng.uniform(0.5, 2.0, (b, nh, dh)).astype(np.float32)
    h = rng.uniform(-0.5, 0.5, (b, nh, dh)).astype(np.float32)
    m = rng.uniform(-1, 1, (b, nh, dh)).astype(np.float32)
    return c, n, h, m


# ------------------------------------------------------------------ sLSTM --

@pytest.mark.parametrize("t,block_t", [(16, 4), (32, 8), (64, 64), (48, 13)])
def test_slstm_scan_plain_matches_reference_kernel(t, block_t):
    """The port's plain version against the reference's Pallas kernel
    (interpret mode) and its sequential oracle, at the reference kernel
    test's cases; on CPU tensors the wrapper is the plain version."""
    b, nh, dh = 2, 2, 8
    u, r, bias = _scan_inputs(b, t, nh, dh, seed=t)
    want_k = np.asarray(j_scan(jnp.asarray(u), jnp.asarray(r),
                               jnp.asarray(bias), nh, block_t=block_t))
    want_r = np.asarray(j_scan_ref(jnp.asarray(u), jnp.asarray(r),
                                   jnp.asarray(bias), nh))
    got, _ = slstm_scan_ref(_t(u), _t(r), _t(bias), nh)
    assert got.shape == (b, t, nh, dh) and got.dtype == torch.float32
    for want in (want_k, want_r):
        np.testing.assert_allclose(got.numpy(), want, rtol=SCAN_TOL,
                                   atol=SCAN_TOL)
    wrapped, _ = tscan.slstm_scan(_t(u), _t(r), _t(bias), nh)
    assert torch.equal(wrapped, got)
    assert tscan.KERNELS["slstm_scan"].launches == 0


def _j_cell_steps(u, r, bias, nh, state):
    params = {"r": type("P", (), {"value": jnp.asarray(r)})(),
              "b": type("P", (), {"value": jnp.asarray(bias).reshape(-1)})()}
    state = tuple(jnp.asarray(s) for s in state)
    hs = []
    for i in range(u.shape[1]):
        state = jx._slstm_cell(params, jnp.asarray(u[:, i]), state, nh)
        hs.append(state[2])
    return np.asarray(jnp.stack(hs, axis=1)), [np.asarray(s) for s in state]


@pytest.mark.parametrize("start", ["zero", "nonzero"])
def test_slstm_scan_state_matches_reference_cell(start):
    """h and the final (c, n, h, m) against the reference's `_slstm_cell`
    stepped from the same state: zero (prefill) or a cached one (the
    decode step's start)."""
    b, t, nh, dh = 2, 12, 2, 4
    u, r, bias = _scan_inputs(b, t, nh, dh, seed=5)
    state = (_state(b, nh, dh, 9) if start == "nonzero"
             else tuple(np.zeros((b, nh, dh), np.float32) for _ in range(4)))
    want_h, want_st = _j_cell_steps(u, r, bias, nh, state)
    got_h, got_st = tscan.slstm_scan(_t(u), _t(r), _t(bias), nh,
                                     tuple(_t(s) for s in state))
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    for g, w in zip(got_st, want_st):
        np.testing.assert_allclose(g.numpy(), w, rtol=SCAN_TOL, atol=SCAN_TOL)


def test_slstm_scan_wrapper_contract():
    u, r, bias = (_t(a) for a in _scan_inputs(1, 3, 2, 4, 0))
    with pytest.raises(ValueError, match="r must be"):
        tscan.slstm_scan(u, r[:, :3], bias, 2)
    with pytest.raises(ValueError, match="state must be"):
        tscan.slstm_scan(u, r, bias, 2, (torch.zeros(1, 2, 4),) * 3)
    with pytest.raises(ValueError, match="different devices"):
        tscan.slstm_scan(u, r.to("meta"), bias, 2)


# ------------------------------------------------------------------ mLSTM --

def _mlstm_inputs(b, t, nh, dk, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, nh, dk)).astype(np.float32)
    k = (rng.standard_normal((b, t, nh, dk)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, t, nh, dk)).astype(np.float32)
    li = (rng.standard_normal((b, t, nh)) * 0.5).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(
        rng.standard_normal((b, t, nh)).astype(np.float32) + 1.0))
    return q, k, v, li, lf


def _mlstm_state(b, nh, dk, start, seed=3):
    if start == "zero":
        return (np.zeros((b, nh, dk, dk), np.float32),
                np.zeros((b, nh, dk), np.float32), np.zeros((b, nh),
                                                            np.float32))
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, nh, dk, dk)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, nh, dk)) * 0.3).astype(np.float32),
            rng.uniform(-1, 1, (b, nh)).astype(np.float32))


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("start", ["zero", "nonzero"])
def test_mlstm_chunk_scan_matches_reference(chunk, start):
    b, t, nh, dk = 2, 16, 2, 8
    ins = _mlstm_inputs(b, t, nh, dk, seed=chunk)
    st = _mlstm_state(b, nh, dk, start)
    jh, jst = jx._mlstm_chunk_scan(*(jnp.asarray(a) for a in ins),
                                   tuple(jnp.asarray(s) for s in st), chunk)
    th, tst = tx._mlstm_chunk_scan(*(_t(a) for a in ins),
                                   tuple(_t(s) for s in st), chunk)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=MLSTM_TOL,
                               atol=MLSTM_TOL)
    for g, w in zip(tst, jst):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=MLSTM_TOL,
                                   atol=MLSTM_TOL)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mlstm_chunkwise_equals_sequential(chunk):
    """As the reference's block test: the chunkwise form equals stepping
    `_mlstm_step` token by token (h and the final n)."""
    b, t, nh, dk = 2, 16, 2, 8
    q, k, v, li, lf = (_t(a) for a in _mlstm_inputs(b, t, nh, dk, seed=0))
    st0 = tuple(_t(s) for s in _mlstm_state(b, nh, dk, "zero"))
    h_c, st_c = tx._mlstm_chunk_scan(q, k, v, li, lf, st0, chunk)
    st, hs = st0, []
    for i in range(t):
        h, st = tx._mlstm_step(q[:, i], k[:, i], v[:, i], li[:, i],
                               lf[:, i], st)
        hs.append(h)
    np.testing.assert_allclose(h_c.numpy(), torch.stack(hs, 1).numpy(),
                               rtol=MLSTM_TOL, atol=MLSTM_TOL)
    np.testing.assert_allclose(st_c[1].numpy(), st[1].numpy(),
                               rtol=MLSTM_TOL, atol=MLSTM_TOL)


def test_mlstm_step_matches_reference():
    b, nh, dk = 2, 2, 8
    q, k, v, li, lf = (a[:, 0] for a in _mlstm_inputs(b, 1, nh, dk, 4))
    st = _mlstm_state(b, nh, dk, "nonzero")
    jh, jst = jx._mlstm_step(*(jnp.asarray(a) for a in (q, k, v, li, lf)),
                             tuple(jnp.asarray(s) for s in st))
    th, tst = tx._mlstm_step(*(_t(a) for a in (q, k, v, li, lf)),
                             tuple(_t(s) for s in st))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=MLSTM_TOL,
                               atol=MLSTM_TOL)
    for g, w in zip(tst, jst):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=MLSTM_TOL,
                                   atol=MLSTM_TOL)


# ----------------------------------------------------------------- blocks --

def _ctxs(tier):
    if tier == "off":
        return JCtx(JParams()), TCtx(TParams())
    jt = {t.name: t for t in jbuild_tiers(mode="hardware")}[tier]
    tt = {t.name: t for t in tbuild_tiers(mode="hardware")}[tier]
    assert isinstance(jt.cim, JCiMConfig)
    return (JCtx(JParams.from_config(jt.cim)),
            TCtx(TParams.from_config(tt.cim)))


def _carry(tree):
    """A JAX block's params as the port's: every leaf bit for bit."""
    from repro_torch.models.bridge import _tensor

    return {k: _tensor(np.asarray(v), "cpu")
            for k, v in unbox(tree).items()}


def _block_case(kind, tier, cached):
    """(JAX out, port out, JAX cache, port cache) of one block call on a
    seeded bf16 input: a 12-token prefill from a fresh cache, then one
    decode token, or (cached=False) one uncached 12-token call."""
    d, nh, b, s = 32, 2, 2, 12
    jctx, tctx = _ctxs(tier)
    if kind == "mlstm":
        jp = jx.init_mlstm(jax.random.PRNGKey(1), d, nh)
        jfn = functools.partial(jx.mlstm_block, jp, n_heads=nh, chunk=4,
                                ctx=jctx)
        tfn = functools.partial(tx.mlstm_block, _carry(jp), n_heads=nh,
                                chunk=4, ctx=tctx)
        jc0, tc0 = (jx.init_mlstm_cache(b, d, nh),
                    tx.init_mlstm_cache(b, d, nh, "cpu"))
    else:
        jp = jx.init_slstm(jax.random.PRNGKey(2), d, nh)
        jfn = functools.partial(jx.slstm_block, jp, n_heads=nh, ctx=jctx)
        tfn = functools.partial(tx.slstm_block, _carry(jp), n_heads=nh,
                                ctx=tctx)
        jc0, tc0 = (jx.init_slstm_cache(b, d, nh),
                    tx.init_slstm_cache(b, d, nh, "cpu"))
    x = (np.random.default_rng(11).standard_normal((b, s + 1, d))
         ).astype(np.float32)
    jxb = jnp.asarray(x, jnp.bfloat16)
    txb = torch.from_numpy(x).to(torch.bfloat16)
    outs = []
    with torch.inference_mode():
        if not cached:
            (jo, _), (to, _) = jfn(jxb[:, :s]), tfn(txb[:, :s])
            return [(jo, to)]
        (jo, jc), (to, tc) = (jfn(jxb[:, :s], cache=jc0),
                              tfn(txb[:, :s], cache=tc0))
        outs.append((jo, to))
        (jo, jc), (to, tc) = jfn(jxb[:, s:], cache=jc), tfn(txb[:, s:],
                                                           cache=tc)
        outs.append((jo, to))
    for key in jc:
        np.testing.assert_allclose(np.asarray(tc[key], np.float32),
                                   np.asarray(jc[key], np.float32),
                                   rtol=BLOCK_TOL[tier], atol=BLOCK_TOL[tier],
                                   err_msg=f"{kind} cache {key}")
    return outs


@pytest.mark.parametrize("tier", ["off", "balanced", "economy"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("cached", [False, True], ids=["nocache", "cache"])
def test_block_matches_reference(kind, tier, cached):
    """mlstm_block / slstm_block against JAX with carried weights: one
    uncached call, or a prefill that fills a fresh cache and a decode
    step from it (outputs and the cache states)."""
    for step, (jo, to) in enumerate(_block_case(kind, tier, cached)):
        assert to.dtype == torch.bfloat16 and tuple(to.shape) == jo.shape
        np.testing.assert_allclose(to.float().numpy(),
                                   np.asarray(jo, np.float32),
                                   rtol=BLOCK_TOL[tier], atol=BLOCK_TOL[tier],
                                   err_msg=f"{kind} {tier} call {step}")


# ------------------------------------------------------ configs, bridge --

@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_configs_and_param_counts_equal_reference(smoke):
    jcfg, tcfg = jget_config(ARCH, smoke=smoke), tget_config(ARCH,
                                                            smoke=smoke)
    for f in dataclasses.fields(tcfg):
        want = getattr(jcfg, f.name)
        got = getattr(tcfg, f.name)
        if dataclasses.is_dataclass(want):
            want, got = dataclasses.asdict(want), dataclasses.asdict(got)
        assert got == want, f.name
    assert count_params(tcfg) == jcount_params(jcfg)


def test_bridge_carries_every_leaf_in_layer_order():
    """Two periods of (MLSTM, MLSTM, SLSTM): layer p*3 + j is body[j] at
    index p, every leaf bit for bit (bf16 through the uint16 view), no
    head (tied embeddings)."""
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), n_layers=6,
                               n_periods=2)
    tree = jax.tree_util.tree_map(
        np.asarray, unbox(JLM(jcfg).init(jax.random.PRNGKey(3))))
    tp = params_from_numpy(tree, "cpu")
    assert "head" not in tp and len(tp["layers"]) == 6

    def bits(t):
        return (t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16
                else t.numpy())

    def jbits(a):
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    n = 0
    for p in range(2):
        for j in range(3):
            layer = tp["layers"][p * 3 + j]
            body = tree["body"][str(j)]
            assert set(layer) == {"norm1", "rnn"}
            for grp in ("norm1", "rnn"):
                assert set(layer[grp]) == set(body[grp])
                for name, leaf in body[grp].items():
                    assert np.array_equal(bits(layer[grp][name]),
                                          jbits(leaf[p])), (p, j, name)
                    n += 1
    assert n == 2 * (2 * 11 + 6)
    assert np.array_equal(bits(tp["embed"]), jbits(tree["embed"]))
    assert set(tp["layers"][2]["rnn"]) == {"w_in", "r", "b", "gn", "w_out"}
