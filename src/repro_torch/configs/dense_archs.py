"""Dense GQA transformer configs: qwen2.5-32b, chatglm3-6b, qwen3-1.7b,
stablelm-1.6b.  Exact dimensions from the assignment table."""

from repro_torch.models.config import ATTN, ModelConfig

from .base import register


def qwen25_32b() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=27648, vocab=152064,
        qkv_bias=True, rope_theta=1e6,
        period=(ATTN,), n_periods=64, grad_accum=8)


def qwen25_32b_smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=160, vocab=512,
        qkv_bias=True, rope_theta=1e6,
        period=(ATTN,), n_periods=2, attn_q_chunk=32, attn_kv_chunk=32)


def chatglm3_6b() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense", n_layers=28, d_model=4096,
        n_heads=32, n_kv_heads=2, d_ff=13696, vocab=65024,
        rope_fraction=0.5,                    # GLM 2d-RoPE: half the dims
        period=(ATTN,), n_periods=28, grad_accum=4)


def chatglm3_6b_smoke() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=160, vocab=512, rope_fraction=0.5,
        period=(ATTN,), n_periods=2, attn_q_chunk=32, attn_kv_chunk=32)


def qwen3_17b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048,
        n_heads=16, n_kv_heads=8, head_dim=128, d_ff=6144, vocab=151936,
        qk_norm=True, rope_theta=1e6,
        period=(ATTN,), n_periods=28, grad_accum=4)


def qwen3_17b_smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160, vocab=512,
        qk_norm=True, period=(ATTN,), n_periods=2,
        attn_q_chunk=32, attn_kv_chunk=32)


def stablelm_16b() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense", n_layers=24, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=5632, vocab=100352,
        norm="layernorm", rope_fraction=0.25,
        period=(ATTN,), n_periods=24, grad_accum=4)


def stablelm_16b_smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=160, vocab=512,
        norm="layernorm", rope_fraction=0.25,
        period=(ATTN,), n_periods=2, attn_q_chunk=32, attn_kv_chunk=32)


register("qwen2.5-32b", qwen25_32b, qwen25_32b_smoke)
register("chatglm3-6b", chatglm3_6b, chatglm3_6b_smoke)
register("qwen3-1.7b", qwen3_17b, qwen3_17b_smoke)
register("stablelm-1.6b", stablelm_16b, stablelm_16b_smoke)
