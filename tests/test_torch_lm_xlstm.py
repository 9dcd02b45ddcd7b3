"""PyTorch port, the xLSTM LM: xlstm-125m-smoke with the JAX package's
weights carried across (models/bridge.py), prefill + 4 greedy decode
steps on each tier of the hardware ladder, held to the JAX LM; the
port's own prefill + decode against its teacher-forced prefill; the
arch gates (the bridge and the configs: tests/test_torch_xlstm.py).

Tolerance on last-token logits, with the top-2 gap rule of
tests/test_torch_lm.py (|logits| ~0.3 at this random init):
  * exact tier 1e-2: bf16 roundings at other places and exp/tanh/rsqrt
    in the last ulp, a few bf16 ulps at the logit scale (measured
    5.9e-3);
  * balanced/economy 4e-2: every activation is quantized per tensor, so
    such an ulp on a rounding boundary moves a whole quantization step
    and propagates through the layers (measured 3.0e-2 / 1.5e-2).
The consistency check holds prefill + decode to the teacher-forced
prefill of each prefix at the reference's 0.12 (tests/
test_serve_consistency.py, bf16 state round trips)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.common import unbox
from repro.models.transformer import LM as JLM
from repro.serving.tiers import build_tiers as jbuild_tiers
from repro_torch.configs import get_config as tget_config
from repro_torch.models import xlstm as tx
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import LM as TLM
from repro_torch.models.transformer import check_arch
from repro_torch.serving import servable_archs
from repro_torch.serving.tiers import build_tiers as tbuild_tiers

ARCH = "xlstm-125m"
TOL = {"exact": 1e-2, "balanced": 4e-2, "economy": 4e-2}
CONSISTENCY_TOL = 0.12


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config(ARCH, smoke=True)
    tcfg = tget_config(ARCH, smoke=True)
    jp = JLM(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, unbox(jp))
    return jcfg, tcfg, jp, tree, params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("tier", ["exact", "balanced", "economy"])
def test_lm_logits_and_greedy_tokens_match_reference(models, tier,
                                                     record_property,
                                                     monkeypatch):
    """Prefill + 4 decode steps on each hardware tier against the JAX LM;
    every sLSTM call goes through the fused recurrence's entry point
    (its plain version on the CPU)."""
    jcfg, tcfg, jp, _, tp = models
    jt = {t.name: t for t in jbuild_tiers(mode="hardware")}[tier]
    tt = {t.name: t for t in tbuild_tiers(mode="hardware")}[tier]
    jlm = JLM(dataclasses.replace(jcfg, cim=jt.cim))
    tlm = TLM(dataclasses.replace(tcfg, cim=tt.cim), device="cpu")
    calls = []
    real = tx.slstm_scan
    monkeypatch.setattr(tx, "slstm_scan", lambda u, *a, **k: calls.append(
        u.shape[1]) or real(u, *a, **k))
    b, s, steps = 4, 8, 4
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (b, s))
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks), "max_len": 16})
    with torch.inference_mode():
        tl, tc = tlm.prefill(tp, {"tokens": torch.as_tensor(toks),
                                  "max_len": 16})
    tol, under_gap = TOL[tier], 0
    for step in range(steps + 1):
        a = np.asarray(jl[:, -1], np.float32)
        c = tl[:, -1].to(torch.float32).numpy()
        assert tl.shape == (b, 1, tcfg.vocab)
        np.testing.assert_allclose(c, a, rtol=0, atol=tol,
                                   err_msg=f"{tier} step {step}")
        top2 = np.sort(a, axis=-1)[:, -2:]
        for i in range(b):
            if top2[i, 1] - top2[i, 0] > tol:
                assert c[i].argmax() == a[i].argmax(), (step, i)
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
    record_property("positions_under_gap_rule", under_gap)
    # one sLSTM layer in the smoke stack: the prefill, then T = 1 a step
    assert calls == [s] + [1] * steps


def test_prefill_decode_matches_teacher_forced_prefill(models):
    """The reference's consistency check on the port (cim=None): the
    logits of prefill + decode equal the teacher-forced prefill of each
    prefix, so the recurrence started from a cached state (T = 1) agrees
    with the one started from zeros."""
    _, tcfg, _, _, tp = models
    lm = TLM(tcfg, device="cpu")
    b, s, n_dec = 2, 24, 4
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, tcfg.vocab, (b, s + n_dec)))
    with torch.inference_mode():
        full = [lm.prefill(tp, {"tokens": toks[:, :t],
                                "max_len": s + n_dec})[0][:, -1]
                for t in range(s, s + n_dec)]
        lp, caches = lm.prefill(tp, {"tokens": toks[:, :s],
                                     "max_len": s + n_dec})
        got = [lp[:, -1]]
        for i in range(n_dec - 1):
            lp, caches = lm.decode_step(tp, caches, toks[:, s + i:s + i + 1],
                                        s + i)
            got.append(lp[:, -1])
    assert [int(c["pos"]) for c in caches["layers"]] == [s + n_dec - 1] * 3
    for i in range(n_dec):
        np.testing.assert_allclose(got[i].float().numpy(),
                                   full[i].float().numpy(),
                                   rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL,
                                   err_msg=f"decode step {i}")


def test_forward_logits_matches_prefill(models):
    _, tcfg, _, _, tp = models
    lm = TLM(tcfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, tcfg.vocab, (2, 10)))
    with torch.inference_mode():
        full = lm.forward_logits(tp, toks)
        last, _ = lm.prefill(tp, {"tokens": toks})
    assert full.shape == (2, 10, tcfg.vocab)
    assert torch.equal(full[:, -1:], last)


def test_arch_gates(models):
    """The engine keeps refusing xLSTM (as the reference's slot pool
    does); per-slot caches, ragged prefill and mesh LMs raise for the
    recurrent kinds; the LM runs on CUDA unless given the CPU."""
    _, tcfg, _, _, tp = models
    assert servable_archs() == ["chatglm3-6b", "qwen2.5-32b", "qwen3-1.7b",
                                "stablelm-1.6b"]
    lm = TLM(tcfg, device="cpu")
    with pytest.raises(ValueError, match="per-slot caches"):
        lm.init_caches(2, 16, per_slot=True)
    with pytest.raises(ValueError, match="per-slot caches"):
        lm.prefill(tp, {"tokens": torch.zeros((2, 4), dtype=torch.int64),
                        "lengths": torch.tensor([4, 2])})
    with pytest.raises(NotImplementedError, match="under a mesh"):
        TLM(tcfg, device="cpu", mesh=object())
    mixed = dataclasses.replace(tcfg, period=("attn", "mlstm", "slstm"))
    with pytest.raises(NotImplementedError, match="later slice"):
        check_arch(mixed)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TLM(tget_config(ARCH))


def test_lockstep_launcher_drives_the_ladder_on_the_cpu(capsys):
    """The lockstep launcher (the xLSTM path's entry point) on the CPU:
    every hardware lane prefills and decodes, finite logits, and the
    exact lane's tokens equal a direct generate() on the same LM."""
    from repro_torch.launch import lockstep

    lockstep.main(["--device", "cpu", "--batch", "2", "--prompt", "8",
                   "--max-new", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("xlstm-125m-smoke on cpu")
    assert [ln.split()[0] for ln in out[1:]] == ["exact", "balanced",
                                                 "economy"]
    assert all("logits finite True" in ln for ln in out[1:])
    cfg = tget_config(ARCH, smoke=True)
    lm = TLM(cfg, device="cpu")
    params = lm.init(0)
    prompts = torch.randint(0, cfg.vocab, (2, 8),
                            generator=torch.Generator().manual_seed(1))
    exact = {t.name: t for t in tbuild_tiers(mode="hardware")}["exact"]
    toks, finite, *_ = lockstep.generate(
        TLM(dataclasses.replace(cfg, cim=exact.cim), device="cpu"), params,
        prompts, 3)
    assert finite and toks.shape == (2, 3)
    assert out[1].endswith(f"row 0: {toks[0].tolist()}")
    with pytest.raises(SystemExit):
        lockstep.main(["--device", "cpu", "--max-new", "1"])
