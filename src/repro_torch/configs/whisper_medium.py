"""Whisper-medium [arXiv:2212.04356] — encoder-decoder audio backbone.

24+24L, d_model=1024, 16 heads (MHA), d_ff=4096, vocab=51865, GELU, sinusoidal positions.
The mel-spectrogram + conv frontend is stubbed: the model takes precomputed
(B, 1500, d_model) frame embeddings (``batch["encoder_embeds"]``).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", arch_type="audio",
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51865,
    block_pattern=("dec+mlp",), n_periods=24,
    encoder_layers=24, encoder_seq=1500,
    activation="gelu", norm="layernorm",
)
