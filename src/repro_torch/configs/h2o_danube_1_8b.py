"""h2o-danube-1.8b — llama+mistral mix with SWA.  [arXiv:2401.16818; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab_size=32000, head_dim=80,
    attn_window=4096,
    act="silu", ffn_gated=True,
    long_context_ok=True,          # SWA-bounded KV
    source="arXiv:2401.16818; hf",
)
