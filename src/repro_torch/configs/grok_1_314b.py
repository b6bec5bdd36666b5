"""grok-1-314b — MoE 8e top-2, GQA kv=8.  [hf:xai-org/grok-1; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab_size=131072, head_dim=128,
    n_experts=8, experts_per_token=2,
    act="gelu", ffn_gated=True,
    long_context_ok=False,  # full attention: 512K KV unbounded
    source="hf:xai-org/grok-1; unverified",
)
