"""Analytic cost model: the mesh-side ``measure_iteration``.

On the production mesh we cannot (and should not) wall-clock a sample chunk
per workload — instead the per-element time is derived from the workload's
arithmetic intensity through the hardware roofline, and ``T0`` from the
collective path.  The outputs feed the *same* Overhead-Law solver as the
measured host numbers, which is the point: one model, two measurement
backends.
"""
from __future__ import annotations

import dataclasses

from .hardware import HardwareSpec


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """Per-element cost of one loop body."""

    flops_per_elem: float
    bytes_per_elem: float
    name: str = "workload"

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops_per_elem / max(self.bytes_per_elem, 1e-30)


# The paper's two benchmark bodies -----------------------------------------
# adjacent_difference: out[i] = in[i] - in[i-1]  -> 1 flop, 2 loads + 1 store
ADJACENT_DIFFERENCE = WorkloadProfile(
    flops_per_elem=1.0, bytes_per_elem=3 * 8, name="adjacent_difference")
# artificial work: K fused multiply-adds per element, negligible traffic
def artificial_work(k: int = 256) -> WorkloadProfile:
    return WorkloadProfile(
        flops_per_elem=2.0 * k, bytes_per_elem=2 * 8,
        name=f"artificial_work_{k}")


def t_iter_analytic(profile: WorkloadProfile, hw: HardwareSpec) -> float:
    """Roofline per-element time: max(compute term, memory term)."""
    return max(profile.flops_per_elem / hw.peak_flops,
               profile.bytes_per_elem / hw.mem_bw)


def t0_analytic(hw: HardwareSpec, n_units: int | None = None,
                sync_bytes: float = 0.0) -> float:
    """Overhead of opening a parallel region across ``n_units``:
    launch + collective latency + bandwidth term for any synchronised
    payload (e.g. a psum of ``sync_bytes``)."""
    t = hw.t0_parallel(n_units)
    if sync_bytes > 0:
        t += sync_bytes / hw.link_bw
    return t


# --- Roofline terms for compiled computations (used by analysis/) ---------

def time_compute(flops: float, hw: HardwareSpec, chips: int = 1) -> float:
    return flops / (chips * hw.peak_flops)


def time_memory(bytes_accessed: float, hw: HardwareSpec, chips: int = 1) -> float:
    return bytes_accessed / (chips * hw.mem_bw)


def time_collective(collective_bytes: float, hw: HardwareSpec,
                    chips: int = 1) -> float:
    return collective_bytes / (chips * hw.link_bw)


def model_flops_dense(n_params: float, tokens: float, training: bool = True) -> float:
    """6·N·D for training; 2·N·D for a forward/serve step."""
    return (6.0 if training else 2.0) * n_params * tokens


def model_flops_moe(n_active_params: float, tokens: float,
                    training: bool = True) -> float:
    return (6.0 if training else 2.0) * n_active_params * tokens
