"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision] — cross-attn image layers.

40L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=128256; every 5th layer is a
gated image cross-attention layer (8 total).  The ViT vision encoder is stubbed: the
model takes precomputed (B, 1600, d_model) patch embeddings (``batch["image_embeds"]``)
fed through a learned projector.  (The JAX config also sets ``sequence_parallel``, a
sharding choice of its TPU mesh with no counterpart on one card.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", arch_type="vlm",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256,
    block_pattern=("attn+mlp", "attn+mlp", "attn+mlp", "attn+mlp", "xattn+mlp"),
    n_periods=8,
    activation="swiglu",
    image_seq=1600,
)
