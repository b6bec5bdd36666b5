"""llama-3.2-vision-11b — decoder with image cross-attention every 5th
layer; vision frontend is a stub (input_specs provides patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    block_pattern=("attn", "attn", "attn", "cross_attn", "attn"),
    frontend="vision", num_frontend_tokens=1601,
    act="silu", ffn_gated=True,
    long_context_ok=False,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
