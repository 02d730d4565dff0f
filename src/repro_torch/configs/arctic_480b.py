"""Snowflake Arctic-480B [hf:Snowflake/snowflake-arctic-base] — 128 experts top-2 +
parallel dense residual MLP.

35L, d_model=7168, 56 heads (GQA kv=8, head_dim=128), per-expert d_ff=4864, vocab=32000.
Every layer: MoE (128e, top-2) in parallel with a dense residual SwiGLU MLP.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", arch_type="moe",
    d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab=32000,
    block_pattern=("attn+moe_dr",), n_periods=35,
    activation="swiglu",
    n_experts=128, top_k=2, moe_d_ff=4864, dense_residual_ff=4864,
)
