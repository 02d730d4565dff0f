"""Nemotron-4-15B [arXiv:2402.16819] — dense, GQA, squared-ReLU MLP (non-gated).

32L, d_model=6144, 48 heads (GQA kv=8, head_dim=128), d_ff=24576, vocab=256000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", arch_type="dense",
    d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=256000,
    block_pattern=("attn+mlp",), n_periods=32,
    activation="relu2",
)
