"""mixtral-8x22b — MoE 8e top-2, GQA kv=8, SWA.  [arXiv:2401.04088; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    n_experts=8, experts_per_token=2,
    attn_window=4096,            # SWA bounds the KV state
    act="silu", ffn_gated=True,
    long_context_ok=True,        # window-bounded KV
    source="arXiv:2401.04088; hf",
)
