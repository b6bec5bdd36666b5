"""qwen3-0.6b — qk-norm, GQA, 151936 vocab, tied embeddings.
[hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab_size=151936, head_dim=128,
    qk_norm=True, tie_embeddings=True,
    act="silu", ffn_gated=True,
    long_context_ok=False,
    source="hf:Qwen/Qwen3-8B; hf",
)
