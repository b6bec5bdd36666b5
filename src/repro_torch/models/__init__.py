"""Model layer of the port: the dense attention serve path."""
from .lm import forward_cached, init_caches, init_params

__all__ = ["forward_cached", "init_caches", "init_params"]
