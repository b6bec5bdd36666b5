"""Model layer of the port: dense and MoE attention, hybrid Mamba2, xLSTM
and cross-attention (vision), the JAX package's ten architectures."""
from . import attention, common, ffn, gla, lm, mamba2, moe, xlstm
from .lm import forward, forward_cached, init_caches, init_params, loss_fn

__all__ = [
    "attention", "common", "ffn", "gla", "lm", "mamba2", "moe", "xlstm",
    "init_params", "forward", "forward_cached", "init_caches", "loss_fn",
]
