"""PyTorch port, dense LM: qwen3-1.7b-smoke with the JAX package's
weights carried across (models/bridge.py), prefill + 3 greedy decode
steps on each tier of the hardware ladder, held to the JAX LM.

Tolerance on last-token logits (|logits| ~ 0.3 at this random init):
  * exact tier 1e-2: bf16 rounding happens at other places (torch
    computes bf16 ops through f32 and rounds once; XLA may round between
    fused ops) and exp/rsqrt differ in the last ulp, a few bf16 ulps at
    the logit scale (measured 4.4e-3);
  * balanced/economy 4e-2: the integer tiers quantize every activation
    per tensor, so a 1-ulp difference landing on a rounding boundary
    moves a whole quantization step (1/127 of the tensor's max) and
    propagates through the layers (measured 1.7e-2 / 8.3e-3).
Greedy tokens must be equal wherever the JAX top-2 logit gap exceeds the
tier's tolerance; at a closer gap (random weights give nearly flat
logits) the JAX token's port logit must lie within the tolerance of the
port's maximum.  Both models are fed the JAX token at every step, so a
near-tie never desynchronizes the comparison."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.common import unbox
from repro.models.transformer import LM as JLM
from repro.serving.tiers import build_tiers as jbuild_tiers
from repro_torch.configs import get_config as tget_config
from repro_torch.models.attention import _chunked_attn
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import LM as TLM
from repro_torch.models.transformer import count_params
from repro_torch.serving.tiers import build_tiers as tbuild_tiers

ARCH = "qwen3-1.7b"
TOL = {"exact": 1e-2, "balanced": 4e-2, "economy": 4e-2}


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config(ARCH, smoke=True)
    tcfg = tget_config(ARCH, smoke=True)
    jp = JLM(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, unbox(jp))
    return jcfg, tcfg, jp, tree, params_from_numpy(tree, "cpu")


def test_bridge_carries_bf16_bits(models):
    jcfg, tcfg, _, tree, tp = models
    assert tree["embed"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(tp["embed"].view(torch.uint16).numpy(),
                          tree["embed"].view(np.uint16))
    wq = tree["body"]["0"]["attn"]["wq"]            # (L, D, H, hd)
    assert len(tp["layers"]) == jcfg.n_layers == wq.shape[0]
    assert np.array_equal(
        tp["layers"][1]["attn"]["wq"].view(torch.uint16).numpy(),
        wq[1].reshape(wq.shape[1], -1).view(np.uint16))
    n = sum(t.numel() for t in (tp["embed"], tp["head"]))
    n += sum(tp["layers"][i][blk][k].numel()
             for i in range(tcfg.n_layers) for blk in ("attn", "mlp")
             for k in tp["layers"][i][blk] if k.startswith("w"))
    assert n == count_params(tcfg)


@pytest.mark.parametrize("tier", ["exact", "balanced", "economy"])
def test_lm_logits_and_greedy_tokens_match_reference(models, tier,
                                                     record_property):
    record_property("positions_under_gap_rule",
                    _compare_with_reference(models, tier, attn=False))


def _compare_with_reference(models, tier, attn, b=2, mode="hardware"):
    jcfg, tcfg, jp, _, tp = models
    jt = {t.name: t for t in jbuild_tiers(mode=mode, attn=attn)}[tier]
    tt = {t.name: t for t in tbuild_tiers(mode=mode, attn=attn)}[tier]
    jlm = JLM(dataclasses.replace(jcfg, cim=jt.cim))
    tlm = TLM(dataclasses.replace(tcfg, cim=tt.cim), device="cpu")
    rng = np.random.default_rng(7)
    s, max_len, steps = 8, 16, 3
    toks = rng.integers(0, jcfg.vocab, (b, s))
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks),
                              "max_len": max_len})
    with torch.inference_mode():
        tl, tc = tlm.prefill(tp, {"tokens": torch.as_tensor(toks),
                                  "max_len": max_len})
    tol = TOL[tier]
    under_gap = 0
    for step in range(steps + 1):
        a = np.asarray(jl[:, -1], np.float32)
        c = tl[:, -1].to(torch.float32).numpy()
        assert tl.shape == (b, 1, tcfg.vocab)
        np.testing.assert_allclose(c, a, rtol=0, atol=tol,
                                   err_msg=f"{tier} step {step}")
        top2 = np.sort(a, axis=-1)[:, -2:]
        for i in range(b):
            if top2[i, 1] - top2[i, 0] > tol:
                assert c[i].argmax() == a[i].argmax(), (tier, step, i)
            else:
                under_gap += 1
                assert c[i, a[i].argmax()] >= c[i].max() - tol
        if step == steps:
            break
        tok = a.argmax(-1)[:, None]
        jl, jc = jlm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32),
                                 jnp.int32(s + step))
        with torch.inference_mode():
            tl, tc = tlm.decode_step(tp, tc, torch.as_tensor(tok), s + step)
    assert under_gap < b * (steps + 1)
    return under_gap


@pytest.mark.parametrize("sq,qc", [(41, 8), (37, 16)])
def test_chunked_attn_prime_sq_bit_identical_to_unpadded(sq, qc):
    """The docstring contract: a prime Sq pads the q axis, and the sliced
    result is bit-identical to the single-chunk run (dense and ragged)."""
    rng = np.random.default_rng(23)
    b, h, kh, d = 2, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((b, sq, n, d))
                                .astype(np.float32)) for n in (h, kh, kh))
    a = _chunked_attn(q, k, v, qc, 16, True, None, 0, sq)
    want = _chunked_attn(q, k, v, sq, 16, True, None, 0, sq)
    assert a.shape == q.shape and torch.equal(a, want)
    pos = torch.arange(sq).expand(b, sq)
    info = (pos, pos, pos < torch.tensor([[11], [sq]]))
    assert torch.equal(_chunked_attn(q, k, v, qc, 8, True, None, 0, sq,
                                     seq_info=info),
                       _chunked_attn(q, k, v, sq, 8, True, None, 0, sq,
                                     seq_info=info))


def test_chunked_attn_matches_reference_float_path():
    from repro.models.attention import _chunked_attn as j_chunked

    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 19, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 19, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 19, 2, 16)).astype(np.float32)
    want = np.asarray(j_chunked(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), 8, 8, True, None, 0, 19))
    got = _chunked_attn(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), 8, 8, True, None, 0, 19)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_ragged_prefill_matches_solo(models):
    """Right-padded ragged batch: each row's last-real-token logits equal
    its solo prefill (pad tokens invisible), on the balanced tier."""
    _, tcfg, _, _, tp = models
    tier = {t.name: t for t in tbuild_tiers(mode="hardware")}["exact"]
    lm = TLM(dataclasses.replace(tcfg, cim=tier.cim), device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, tcfg.vocab, (3, 12)))
    lens = torch.tensor([12, 7, 4])
    with torch.inference_mode():
        lp, caches = lm.prefill(tp, {"tokens": toks, "lengths": lens,
                                     "max_len": 16})
        assert caches["layers"][0]["pos"].tolist() == [12, 7, 4]
        for i in range(3):
            solo, _ = lm.prefill(tp, {"tokens": toks[i:i + 1, :lens[i]],
                                      "max_len": 16})
            np.testing.assert_allclose(lp[i, -1].float().numpy(),
                                       solo[0, -1].float().numpy(),
                                       rtol=5e-2, atol=5e-2)
