"""Hybrid / recurrent configs of the port: xlstm-125m (the JAX
package's ``configs/hybrid_archs.py`` entries, field for field; its other
hybrid archs are later slices)."""

from repro_torch.models.config import (MLSTM, SLSTM, ModelConfig,
                                       RecurrentConfig)

from .base import register


def xlstm_125m() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
        tie_embeddings=True,
        rnn=RecurrentConfig(mlstm_chunk=64, slstm_heads=4),
        period=(MLSTM, MLSTM, SLSTM), n_periods=4,
        supports_long_context=True, grad_accum=2)


def xlstm_125m_smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-smoke", family="ssm", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab=512, tie_embeddings=True,
        rnn=RecurrentConfig(mlstm_chunk=16, slstm_heads=4),
        period=(MLSTM, MLSTM, SLSTM), n_periods=1,
        supports_long_context=True)


register("xlstm-125m", xlstm_125m, xlstm_125m_smoke)
