"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small dense.

30L, d_model=576, 9 heads (GQA kv=3, head_dim=64), d_ff=1536, vocab=49152, SwiGLU, tied
embeddings, no qk-norm.  Reduced to one period, it is the model the decision-trace
parity tests run.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", arch_type="dense",
    d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab=49152,
    block_pattern=("attn+mlp",), n_periods=30,
    activation="swiglu", tie_embeddings=True,
)
