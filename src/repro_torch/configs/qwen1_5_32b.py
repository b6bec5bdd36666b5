"""qwen1.5-32b — MHA with QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab_size=152064, head_dim=128,
    qkv_bias=True,
    act="silu", ffn_gated=True,
    long_context_ok=False,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
