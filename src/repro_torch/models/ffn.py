"""Feed-forward blocks: gated GLU (llama-style) or plain MLP.  Under a
tensor-parallel context (``flags.TP``) the weights are this rank's
hidden columns, the input goes through *f* and ``w_down`` ends in the
model group's all_reduce (*g*); under sequence parallelism the input's
rows are gathered and ``w_down`` ends in a reduce-scatter to this
rank's rows (``common.block_input``, ``common.linear_rows``)."""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from . import common as cm
from . import flags


def apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    cd = getattr(torch, cfg.compute_dtype)
    act = cm.act_fn(cfg.act)
    tp = flags.TP
    split = tp is not None and tp.ffn
    x = cm.block_input(x, split)
    up = cm.linear(p["w_up"], x, cd)
    if cfg.ffn_gated:
        up = act(cm.linear(p["w_gate"], x, cd)) * up
    else:
        up = act(up)
    return cm.linear_rows(p["w_down"], up, cd, split=split)
