"""Collectives shared by the port's layers (models, serving, training,
the algorithms), below ``launch``, which builds the meshes whose process
groups they run over."""
from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """Every rank's ``t`` of ``group`` into ``out``, concatenated along
    dim 0 in rank order: ``dist.all_gather_single`` where this PyTorch
    has it, else its older name ``all_gather_into_tensor``."""
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, t, group=group)
