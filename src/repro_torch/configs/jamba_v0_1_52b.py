"""Jamba-v0.1-52B [arXiv:2403.19887] — hybrid Mamba+attention 1:7 interleave, MoE.

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=65536; MoE 16 experts top-2 on
every other layer.  Period of 8 = {7 mamba, 1 attn}, MoE at odd positions (16 MoE layers).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", arch_type="hybrid",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65536,
    block_pattern=(
        "mamba+mlp", "mamba+moe", "mamba+mlp", "attn+moe",
        "mamba+mlp", "mamba+moe", "mamba+mlp", "mamba+moe",
    ),
    n_periods=4,
    activation="swiglu",
    n_experts=16, top_k=2, moe_d_ff=14336,
    ssm_state_dim=16, ssm_conv_width=4, ssm_expand=2,
)
