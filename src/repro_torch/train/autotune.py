"""Per-token workload profiles for the serve scheduler.

The JAX package's module also holds the training planner and the kernel
tuner factory; only the two profiles the serve path reads are ported
here (training is a later slice, ROADMAP.md).
"""
from __future__ import annotations

from ..configs.base import ArchConfig
from ..core.cost_model import WorkloadProfile


def token_profile(cfg: ArchConfig, *, training: bool = True) -> WorkloadProfile:
    """Per-token cost of one step (per-device view is handled by acc)."""
    n_active = cfg.active_param_count()
    flops = (6.0 if training else 2.0) * n_active
    # weight traffic dominates memory per step at large batch; activations
    # are roughly d_model * n_layers * ~20 bytes/token
    bytes_ = 20.0 * cfg.d_model * cfg.n_layers
    return WorkloadProfile(flops_per_elem=flops, bytes_per_elem=bytes_,
                           name=f"{cfg.name}-{'train' if training else 'serve'}")


def serve_profiles(cfg: ArchConfig) -> tuple[WorkloadProfile, WorkloadProfile]:
    """(prefill, decode) per-token profiles for the serving scheduler.

    Prefill reuses the training-loop profile at forward-only FLOPs (the
    workload element is a prompt token).  Decode is the memory-bound
    regime: each generated token re-reads the active weights, so the
    bytes term is the full 2-byte-per-param weight stream rather than the
    amortised activation traffic.
    """
    prefill = token_profile(cfg, training=False)
    n_active = cfg.active_param_count()
    decode = WorkloadProfile(flops_per_elem=2.0 * n_active,
                             bytes_per_elem=2.0 * n_active,
                             name=f"{cfg.name}-decode")
    return prefill, decode
