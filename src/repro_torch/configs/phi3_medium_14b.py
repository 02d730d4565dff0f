"""Phi-3-medium-14B [arXiv:2404.14219] — dense, RoPE + SwiGLU + GQA.

40L, d_model=5120, 40 heads (GQA kv=10, head_dim=128), d_ff=17920, vocab=100352.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", arch_type="dense",
    d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab=100352,
    block_pattern=("attn+mlp",), n_periods=40,
    activation="swiglu",
)
