"""xlstm-350m — mLSTM + sLSTM blocks (7:1).  [arXiv:2405.04517; unverified]
d_ff=0: all capacity lives in the recurrent blocks' projections."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    ssm_state=0, ssm_head_dim=512, ssm_expand=2,  # 4 heads of 512 in d_inner
    long_context_ok=True,          # recurrent O(1) state
    source="arXiv:2405.04517; unverified",
)
