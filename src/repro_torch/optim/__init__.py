from .adamw import AdamWConfig, global_norm, init_state, update
from .schedule import constant, warmup_cosine

__all__ = ["AdamWConfig", "init_state", "update", "global_norm",
           "warmup_cosine", "constant"]
