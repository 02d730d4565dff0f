"""Model configuration (a copy of ``repro/models/config.py``'s ``ModelConfig``).

A model is a stack of *periods*: ``block_pattern`` lists the layer kinds of one
period (``"<mixer>+<mlp>"``), repeated ``n_periods`` times.  Parameters and
caches carry a leading ``n_periods`` axis.  The port runs the kinds of
``models.model.PORTED_KINDS`` (attention, Mamba and xLSTM mixers, the audio
decoder's self- plus cross-attention ``dec`` and the VLM's gated
cross-attention ``xattn``; dense MLP or MoE); the other fields are kept so
that configurations read the same in both packages.  ``ShardConfig`` is the
port's own: a tensor-parallel shard's config, whose Mamba and xLSTM widths
are its parts of ``ssm_expand * d_model`` and ``xlstm_expand * d_model``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                       # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    block_pattern: Tuple[str, ...]       # one period of layer kinds
    n_periods: int
    head_dim: int = 0                    # 0 -> d_model // n_heads
    activation: str = "swiglu"           # swiglu | relu2 | gelu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    tie_embeddings: bool = False

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0
    dense_residual_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM / xLSTM ---------------------------------------------------------
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0
    xlstm_expand: int = 2

    # --- encoder-decoder (audio) / VLM ---------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0
    image_seq: int = 0

    # --- attention variant ----------------------------------------------------
    sliding_window: int = 0              # 0 = full attention

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------ derived
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        """Mamba's inner width."""
        return self.ssm_expand * self.d_model

    @property
    def mlstm_inner(self) -> int:
        """The mLSTM's inner width: its heads' q/k/v columns side by side."""
        return self.xlstm_expand * self.d_model

    @property
    def slstm_inner(self) -> int:
        """The sLSTM's width: its heads' cells side by side."""
        return self.d_model

    @property
    def n_layers(self) -> int:
        return len(self.block_pattern) * self.n_periods

    @property
    def q_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    def layer_kinds(self) -> list[str]:
        """Each layer's ``mixer[+mlp]`` kind, in order."""
        return list(self.block_pattern) * self.n_periods

    def has_kv_cache(self) -> bool:
        """Whether any layer's mixer (``attn`` or ``dec``) keeps a KV cache."""
        return any(k.partition("+")[0] in ("attn", "dec") for k in self.block_pattern)

    def is_subquadratic(self) -> bool:
        """Whether the config decodes with O(1) state a token at any context:
        no attention mixer, or a sliding window on every one."""
        return not self.has_kv_cache() or self.sliding_window > 0

    def with_sliding_window(self, window: int) -> "ModelConfig":
        return replace(self, sliding_window=window)

    def reduced(self, n_periods: int | None = None, **kw) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (<=2 layers, d<=512, <=4 experts)."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        heads = (heads // kv) * kv or kv
        defaults = dict(
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_periods=n_periods if n_periods is not None else 1,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            shared_d_ff=min(self.shared_d_ff, 128) if self.shared_d_ff else 0,
            dense_residual_ff=min(self.dense_residual_ff, 128) if self.dense_residual_ff else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            image_seq=min(self.image_seq, 32) if self.image_seq else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            dtype="float32",
        )
        defaults.update(kw)
        return replace(self, **defaults)


@dataclass(frozen=True)
class ShardConfig(ModelConfig):
    """The config one shard of a tensor-parallel worker computes with
    (``distributed.sharding.shard_config``): its heads and widths, and the
    widths that ``d_model`` no longer gives: ``ssm_inner``, its part of
    Mamba's inner width, and ``xlstm_inner``, its part of the mLSTM's (the
    sLSTM's heads are cut with the same degree, so its width follows)."""

    ssm_inner: int = 0
    xlstm_inner: int = 0

    @property
    def d_inner(self) -> int:
        return self.ssm_inner

    @property
    def mlstm_inner(self) -> int:
        return self.xlstm_inner

    @property
    def slstm_inner(self) -> int:
        return self.xlstm_inner // self.xlstm_expand


@dataclass(frozen=True)
class InputShape:
    """One of the assigned input shapes of the dry run: a step of ``mode``
    (train, prefill or decode) over ``global_batch`` sequences of
    ``seq_len`` tokens (a decode step's context)."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                            # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# Sliding window the full-attention configs take for long-context decode
# (the JAX package's long_500k variant).
LONG_CONTEXT_WINDOW = 8_192
