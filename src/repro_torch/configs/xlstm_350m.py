"""xLSTM-350M [arXiv:2405.04517] — sLSTM + mLSTM blocks, no separate MLP (d_ff=0).

24L, d_model=1024, 4 heads, vocab=50304.  Period of 6 = {5 mLSTM, 1 sLSTM}.  Matrix /
scalar recurrent memories -> O(1) decode state.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", arch_type="ssm",
    d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
    n_periods=4,
    xlstm_expand=2,
)
