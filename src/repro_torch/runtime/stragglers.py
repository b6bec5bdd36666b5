"""Straggler mitigation analysis: why C = 8 chunks per core (a copy of
``repro.runtime.stragglers``; numpy only).

With one program per device there is no cross-device work stealing, so
over-decomposition is the available lever: with each device's step split
into C chunks (grad-accum microbatches), a straggling chunk delays the
step by ~(slowdown-1)/C of a device-step instead of (slowdown-1).
``straggler_step_time`` quantifies this with a static assignment of
chunks to devices.
"""
from __future__ import annotations

import numpy as np


def straggler_step_time(*, n_devices: int, chunks_per_device: int,
                        slowdown: float, straggler_fraction: float = 0.02,
                        seed: int = 0) -> float:
    """Relative step time (1.0 = no stragglers) when a fraction of chunk
    executions run ``slowdown``× slower, with C-deep over-decomposition."""
    rng = np.random.RandomState(seed)
    n_chunks = n_devices * chunks_per_device
    base = 1.0 / chunks_per_device  # chunk duration in device-step units
    durations = np.full(n_chunks, base)
    slow = rng.rand(n_chunks) < straggler_fraction
    durations[slow] *= slowdown
    # static assignment: chunk i -> device i % n_devices (no stealing)
    per_dev = np.zeros(n_devices)
    for i, d in enumerate(durations):
        per_dev[i % n_devices] += d
    return float(per_dev.max())


def mitigation_table(slowdown: float = 5.0, n_devices: int = 256,
                     cs=(1, 2, 4, 8, 16, 32)) -> dict[int, float]:
    return {c: straggler_step_time(n_devices=n_devices,
                                   chunks_per_device=c,
                                   slowdown=slowdown)
            for c in cs}
