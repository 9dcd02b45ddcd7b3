"""Unified architecture configuration (the JAX package's, copied).

A `ModelConfig` fully determines parameters, layer pattern and the CiM
execution mode.  Layer stacking is ``prefix_layers`` followed by
``n_periods`` repetitions of ``period``; the port runs the dense
``period=(ATTN,)`` stacks and the xLSTM (MLSTM, SLSTM) stacks, and
the other sub-configs are kept as fields so the configs read the same
as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.compiler import CiMConfig

# layer kinds
ATTN = "attn"          # global causal self-attention
LOCAL = "local"        # sliding-window causal self-attention
CROSS = "cross"        # cross-attention to auxiliary states (vision/audio)
RGLRU = "rglru"        # RecurrentGemma RG-LRU block
SLSTM = "slstm"        # xLSTM scalar-memory block
MLSTM = "mlstm"        # xLSTM matrix-memory block
ENC_ATTN = "enc_attn"  # bidirectional encoder self-attention


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    router: str = "softmax"        # softmax | sigmoid (deepseek-v3)
    capacity_factor: float = 1.25
    aux_loss_coef: float = 1e-3
    route_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None      # None: no q compression (v2-lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    width: int = 0                 # rnn width (0 -> d_model)
    conv_width: int = 4            # temporal conv for RG-LRU
    mlstm_chunk: int = 64          # chunk length for chunkwise mLSTM
    slstm_heads: int = 4


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder; the conv/mel frontend is a stub — inputs are
    precomputed frame embeddings (B, n_frames, d_model)."""

    n_layers: int = 24
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Llama-3.2-Vision-style stub: precomputed patch embeddings
    (B, n_tokens, d_vision) projected in-model and consumed by the
    cross-attention layers."""

    n_tokens: int = 1601
    d_vision: int = 1280


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "swiglu"            # swiglu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0     # stablelm 0.25; chatglm "2d" = 0.5
    tie_embeddings: bool = False
    window: int = 2048             # for LOCAL layers
    # stacking: n_layers == len(prefix_layers) + n_periods * len(period)
    prefix_layers: Tuple[str, ...] = ()
    period: Tuple[str, ...] = (ATTN,)
    n_periods: int = 0
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rnn: Optional[RecurrentConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    mtp_depth: int = 0             # deepseek-v3 multi-token prediction
    # execution
    cim: Optional[CiMConfig] = None
    dtype: str = "bfloat16"
    remat: bool = True
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    grad_accum: int = 1
    # which layer kinds support O(1)/O(window) decode state (long-context)
    supports_long_context: bool = False

    def __post_init__(self):
        total = len(self.prefix_layers) + self.n_periods * len(self.period)
        if total != self.n_layers:
            raise ValueError(
                f"{self.name}: prefix({len(self.prefix_layers)}) + "
                f"{self.n_periods}*period({len(self.period)}) != n_layers"
                f" {self.n_layers}")
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def layer_pattern(self) -> Tuple[str, ...]:
        return self.prefix_layers + self.period * self.n_periods

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder is not None

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        from repro_torch.models.transformer import count_params  # lazy, avoids cycle

        return count_params(self)
