"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family] — dense, qk-norm, GQA.

28L, d_model=2048, 16 heads (GQA kv=8, head_dim=128), d_ff=6144, vocab=151936.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", arch_type="dense",
    d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, vocab=151936,
    block_pattern=("attn+mlp",), n_periods=28,
    activation="swiglu", qk_norm=True, tie_embeddings=True,
    rope_theta=1_000_000.0,
)
