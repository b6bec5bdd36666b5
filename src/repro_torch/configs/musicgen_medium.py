"""musicgen-medium — decoder-only transformer over EnCodec tokens
(the EnCodec frontend is the stub: token ids are the input).
[arXiv:2306.05284; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    frontend="audio",
    act="gelu", ffn_gated=False,
    long_context_ok=False,
    source="arXiv:2306.05284; hf",
)
