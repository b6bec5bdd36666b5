"""Model layer of the port: attention (dense, MoE) and hybrid Mamba2."""
from .lm import forward_cached, init_caches, init_params

__all__ = ["forward_cached", "init_caches", "init_params"]
