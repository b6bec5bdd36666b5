"""granite-34b — deep/narrow MQA code model (gpt-bigcode style MLP).
[arXiv:2405.04324; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    act="gelu", ffn_gated=False,
    long_context_ok=False,
    source="arXiv:2405.04324; hf",
)
