"""PyTorch port, dense LM with CiM attention: qwen3-1.7b-smoke on the
``build_tiers(mode="hardware", attn=True)`` ladder against the JAX LM,
with the tolerances and the top-2 gap rule of tests/test_torch_lm.py
(the comparison itself lives there; this file keeps each file's run
under a minute)."""

import pytest

from test_torch_lm import _compare_with_reference, models  # noqa: F401


@pytest.mark.parametrize("tier", ["exact", "balanced", "economy"])
def test_lm_with_cim_attention_matches_reference(models, tier,
                                                 record_property,
                                                 monkeypatch):
    """The attn=True ladder: the approximate tiers run self-attention
    through the CiM attention path (prefill and every decode step, no
    float fallback), the exact tier keeps the float path; logits and
    greedy tokens held to the JAX LM as on the attn=False ladder."""
    from repro_torch.core import approx_gemm as ag
    from repro_torch.models import attention as tattn

    calls = []
    real = ag.cim_attention
    monkeypatch.setattr(ag, "cim_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    n0 = tattn.cim_attn_fallbacks()
    # four prompts: this random model's logits are nearly flat, and at two
    # rows no top-2 gap on the balanced tier clears the tolerance
    record_property("positions_under_gap_rule",
                    _compare_with_reference(models, tier, attn=True, b=4))
    assert tattn.cim_attn_fallbacks() == n0
    n_layers = models[1].n_layers
    if tier == "exact":
        assert not calls
    else:                                   # prefill + 3 decode steps
        assert len(calls) == 4 * n_layers
