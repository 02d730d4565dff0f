"""Paper-faithful Qwen3 rollout configs (8B/14B/32B) used by §7 benchmarks [arXiv:2505.09388]."""
from repro_torch.models.config import ModelConfig


def _qwen3(name, layers, d, heads, kv, ff):
    return ModelConfig(
        name=name, arch_type="dense",
        d_model=d, n_heads=heads, n_kv_heads=kv, head_dim=128,
        d_ff=ff, vocab=151936,
        block_pattern=("attn+mlp",), n_periods=layers,
        activation="swiglu", qk_norm=True, rope_theta=1_000_000.0,
    )


QWEN3_8B = _qwen3("qwen3-8b", 36, 4096, 32, 8, 12288)
QWEN3_14B = _qwen3("qwen3-14b", 40, 5120, 40, 8, 17408)
QWEN3_32B = _qwen3("qwen3-32b", 64, 5120, 64, 8, 25600)
