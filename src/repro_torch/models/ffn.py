"""Feed-forward blocks: gated GLU (llama-style) or plain MLP."""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from . import common as cm


def apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    cd = getattr(torch, cfg.compute_dtype)
    act = cm.act_fn(cfg.act)
    up = cm.linear(p["w_up"], x, cd)
    if cfg.ffn_gated:
        up = act(cm.linear(p["w_gate"], x, cd)) * up
    else:
        up = act(up)
    return cm.linear(p["w_down"], up, cd)
