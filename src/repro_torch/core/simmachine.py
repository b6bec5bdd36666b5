"""Calibrated machine model for reproducing the paper's figures (a copy
of ``repro.core.simmachine``; numpy only).

The paper's evaluation machines (40-core Skylake, 48-core EPYC) are not
at hand, so the wall-clock experiments of Figures 1-4 are reproduced
against this discrete-event model:

* a parallel region costs ``t0`` once (the Overhead Law's constant),
* each scheduled chunk costs ``t_task`` (per-task scheduling overhead —
  this is what makes *excessive* chunking lose, paper Section 5),
* each element costs ``t_iter`` (memory- or compute-bound, calibrated),
* each chunk's runtime gets deterministic multiplicative jitter (system
  noise / cache effects; what makes over-decomposition *win*),
* chunks are placed by greedy earliest-finish list scheduling, which is
  the standard model of HPX's work stealing.

The model is deliberately simple — it contains the Overhead Law as its
noise-free, zero-task-cost limit, so tests can check both the closed-form
equations and the richer figure shapes against one artefact.
"""
from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np

from .executor import make_chunks
from .overhead_law import AccDecision


@dataclasses.dataclass(frozen=True)
class SimMachine:
    name: str
    cores: int
    t0: float            # parallel-region overhead, base (s)
    t_task: float        # per-scheduled-chunk overhead (s)
    jitter: float        # std-dev of multiplicative chunk noise (0 = exact)
    t0_percore: float = 0.4e-6   # region overhead grows with woken cores
    seed: int = 0

    def t0_for(self, n_cores: int) -> float:
        """Region overhead when opening a region across n cores — this is
        what the empty-task benchmark measures (at full width)."""
        return self.t0 + self.t0_percore * max(n_cores, 1)

    def run(self, *, t_iter: float, count: int, n_cores: int,
            chunk_elems: int, saturation_cores: int | None = None) -> float:
        """Simulated wall-clock seconds for one parallel-for invocation.

        ``saturation_cores``: for memory-bound bodies, the core count at
        which the socket bandwidth saturates — beyond it, per-element time
        inflates by n/saturation (total throughput capped).  This is what
        limits the paper's adjacent-difference to ~10× on 40 cores."""
        if n_cores <= 1:
            return t_iter * count
        if saturation_cores is not None and n_cores > saturation_cores:
            t_iter = t_iter * (n_cores / saturation_cores)
        chunks = make_chunks(count, chunk_elems)
        rng = np.random.RandomState(
            (self.seed * 1000003 + count * 131 + n_cores * 17
             + chunk_elems) % (2**31 - 1))
        noise = (1.0 + self.jitter * np.abs(rng.standard_normal(len(chunks)))
                 if self.jitter > 0 else np.ones(len(chunks)))
        durations = [self.t_task + c.size * t_iter * float(n)
                     for c, n in zip(chunks, noise, strict=True)]
        # Greedy earliest-finish placement (work-stealing model).
        heap = [0.0] * min(n_cores, len(chunks))
        heapq.heapify(heap)
        for d in durations:
            t = heapq.heappop(heap)
            heapq.heappush(heap, t + d)
        return self.t0_for(n_cores) + max(heap)

    def speedup(self, *, t_iter: float, count: int, n_cores: int,
                chunks_per_core: int,
                saturation_cores: int | None = None) -> float:
        t1 = t_iter * count
        chunk = max(math.ceil(count / max(n_cores * chunks_per_core, 1)), 1)
        tn = self.run(t_iter=t_iter, count=count, n_cores=n_cores,
                      chunk_elems=chunk, saturation_cores=saturation_cores)
        return t1 / tn if tn > 0 else 1.0

    def run_decision(self, d: AccDecision,
                     saturation_cores: int | None = None) -> float:
        return self.run(t_iter=d.t_iter, count=d.n_elements,
                        n_cores=d.n_cores, chunk_elems=d.chunk_elems,
                        saturation_cores=saturation_cores)


# The paper's machines, with overheads of the order HPX reports
# (lightweight user-level tasks: microsecond-scale region costs).
SKYLAKE_40 = SimMachine(name="intel-skylake-40c", cores=40,
                        t0=2e-6, t_task=0.3e-6, jitter=0.05,
                        t0_percore=0.4e-6)
EPYC_48 = SimMachine(name="amd-epyc-48c", cores=48,
                     t0=2.5e-6, t_task=0.35e-6, jitter=0.05,
                     t0_percore=0.4e-6)
