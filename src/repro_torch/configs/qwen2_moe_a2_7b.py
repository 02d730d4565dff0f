"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60 routed experts top-4 + 4 shared.

24L, d_model=2048, 16 heads (kv=16, MHA), per-expert d_ff=1408, vocab=151936.  The 4
shared experts are fused into one 5632-wide MLP with a sigmoid gate (as in the HF impl).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", arch_type="moe",
    d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=151936,
    block_pattern=("attn+moe",), n_periods=24,
    activation="swiglu",
    n_experts=60, top_k=4, moe_d_ff=1408, shared_d_ff=5632,
)
