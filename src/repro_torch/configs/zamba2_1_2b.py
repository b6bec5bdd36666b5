"""zamba2-1.2b — Mamba2 backbone + shared attention block every 6th
position (shared weights).  [arXiv:2411.15242; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    block_pattern=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2",
                   "shared_attn"),
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    long_context_ok=True,          # Mamba2 O(1) state
    long_context_window=4096,      # shared attn windowed in long shapes
    source="arXiv:2411.15242; hf",
)
