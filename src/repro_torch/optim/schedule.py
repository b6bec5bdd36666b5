"""LR schedules (functions of the step; the counterpart of
``repro.optim.schedule``).  The step may be a device tensor: the result
stays on its device, so a train step reads no number back."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * s / max(warmup_steps, 1)
    t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    s = torch.as_tensor(step)
    return torch.full_like(s, peak_lr, dtype=torch.float32)
