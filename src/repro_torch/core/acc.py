"""``adaptive_core_chunk_size`` (acc) — the paper's contribution.

An execution-parameters object that overloads the three customization
points (it simply defines methods with the tag names; see
core/customization.py for the dispatch rule):

* ``measure_iteration``       — wall-clock a sample chunk (host), time its
  work on the card between CUDA events (``calibration.DeviceBody``), or
  evaluate the analytic roofline (mesh / WorkloadProfile), cached per
  workload key;
* ``processing_units_count``  — Eq. 7, clamped to the executor's units;
* ``get_chunk_size``          — Eq. 10 with the T_m floor.

``decide`` exposes the full decision record for the training loop, the
serving engine, and the Pallas tuner, which need more than the three
scalar answers.

Since the ExecutionModel unification (core/model.py) this object is a
*front-end*: it gathers the runtime metrics (T0, t_iter) and asks the
engine bound to its calibration cache for the decision, so every
core/chunk choice lands in one explainable trace with provenance.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Hashable

from . import calibration, overhead_law
from .cost_model import WorkloadProfile, t0_analytic, t_iter_analytic
from .executor import Executor, mesh_executor_of
from .hardware import H100_SXM, HardwareSpec
from .model import DecisionKey, ExecutionModel


@dataclasses.dataclass
class AdaptiveCoreChunk:
    """Execution-parameters object implementing the paper's acc policy."""

    efficiency: float = overhead_law.DEFAULT_EFFICIENCY
    chunks_per_core: int = overhead_law.DEFAULT_CHUNKS_PER_CORE
    hardware: HardwareSpec = H100_SXM     # used for analytic backends
    t0_override: float | None = None      # tests / reproducibility
    cache: calibration.CalibrationCache = dataclasses.field(
        default_factory=calibration.CalibrationCache)
    # The workload key most recently passed to measure_iteration: the
    # paper's call sequence (measure → units → chunk) runs the three
    # customization points back-to-back with fixed signatures, so the
    # key seen at measurement time is stashed here to label the decision
    # in the engine trace.  Single decision loop per acc object by
    # construction (scheduler tick / plan() call); not a concurrency
    # hazard in practice, and only trace labels ride on it.
    _last_workload_key: Hashable | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def model(self) -> ExecutionModel:
        """The decision engine bound to this object's calibration cache
        (shared with the feedback layer and the kernel tuner)."""
        return ExecutionModel.of(self.cache)

    # -- T0 ---------------------------------------------------------------
    def calibrate_t0(self, executor: Executor) -> float:
        if self.t0_override is not None:
            return self.t0_override
        if mesh_executor_of(executor) is not None:
            return t0_analytic(self.hardware, executor.num_units())
        # Key by backend type + width, not object identity: identical
        # executors share one calibration and the entry survives process
        # restarts through CalibrationCache persistence.
        from .executor import unwrap_executor

        inner = unwrap_executor(executor)
        key = ("t0", type(inner).__name__, max(executor.num_units(), 1))
        return self.model.t0(
            key, lambda: calibration.measure_t0_empty_task(executor))

    # -- customization point: measure_iteration ----------------------------
    def measure_iteration(self, executor: Executor, body: Any,
                          count: int, key: Hashable | None = None) -> float:
        """Seconds per element for ``body``.

        ``body`` is either a ``WorkloadProfile`` (analytic path) or a
        callable ``body(start, size)`` chunk thunk (measured path).
        Measured once per workload key, then cached (paper Section 4.2).
        """
        self._last_workload_key = key
        if isinstance(body, WorkloadProfile):
            # Analytic seed, but online feedback wins once present: a keyed
            # profile workload whose chunks have been timed (core/feedback)
            # reads the smoothed observation instead of the roofline guess.
            if key is not None:
                smoothed = self.model.smoothed_t_iter(key)
                if smoothed is not None:
                    return smoothed
            return t_iter_analytic(body, self.hardware)
        k = key if key is not None else ("t_iter", getattr(body, "__name__", id(body)))
        self._last_workload_key = k
        measure = (calibration.measure_iteration_device
                   if isinstance(body, calibration.DeviceBody)
                   else calibration.measure_iteration_wallclock)
        return self.model.measured_t_iter(k, lambda: measure(body, count))

    # -- customization point: processing_units_count ------------------------
    def processing_units_count(self, executor: Executor, t_iter: float,
                               count: int) -> int:
        d = self.decide(executor, t_iter, count)
        return d.n_cores

    # -- customization point: get_chunk_size --------------------------------
    def get_chunk_size(self, executor: Executor, t_iter: float,
                       cores: int, count: int) -> int:
        if cores <= 1:
            return count
        t0 = self.calibrate_t0(executor)
        chunk = overhead_law.chunk_size(count, cores, self.chunks_per_core)
        if t_iter > 0:
            t_m = overhead_law.t_opt(t0, self.efficiency) / self.chunks_per_core
            chunk = max(chunk, min(math.ceil(t_m / t_iter), count))
        return chunk

    # -- full decision -------------------------------------------------------
    def decide(self, executor: Executor, t_iter: float, count: int,
               key: Hashable | None = None,
               evidence: tuple = ()) -> overhead_law.AccDecision:
        """The full Overhead-Law decision, made by the ExecutionModel
        engine (one trace entry per call).  ``key`` labels the trace
        entry; without one, the key stashed by the most recent
        ``measure_iteration`` call — the paper's call sequence — or a
        generic algorithm key is used.  ``evidence`` lists extra
        workload keys whose calibrations fed ``t_iter``."""
        t0 = self.calibrate_t0(executor)
        max_cores = max(executor.num_units(), 1)
        mexec = mesh_executor_of(executor)
        if key is None:
            key = self._last_workload_key
        dkey = (DecisionKey.wrap(key) if key is not None
                else DecisionKey("algorithm", (count,)))
        decision = self.model.cores_chunk(
            dkey, t_iter=t_iter, count=count, t0=t0, max_cores=max_cores,
            eff=self.efficiency, chunks_per_core=self.chunks_per_core,
            # Mesh shardings need a divisor of the data extent.
            snap_cores=mexec.submesh_size if mexec is not None else None,
            evidence=evidence)
        return decision.acc

    def decide_for_profile(self, executor: Executor, profile: WorkloadProfile,
                           count: int, key: Hashable | None = None
                           ) -> overhead_law.AccDecision:
        """Decision from an analytic profile; with a ``key``, smoothed
        online-feedback timings (if any) override the roofline estimate."""
        return self.decide(
            executor, self.measure_iteration(executor, profile, count,
                                             key=key), count, key=key)


@dataclasses.dataclass
class StaticCoreChunk:
    """The baseline: fixed core count and chunks-per-core (OpenMP-static /
    HPX-default semantics).  Used by benchmarks as the non-adaptive
    comparison lines in the paper's figures."""

    cores: int
    chunks_per_core: int = 1

    def measure_iteration(self, executor, body, count, key=None) -> float:
        return 0.0  # static: no measurement needed

    def processing_units_count(self, executor, t_iter: float, count: int) -> int:
        return min(self.cores, max(executor.num_units(), 1))

    def get_chunk_size(self, executor, t_iter: float, cores: int,
                       count: int) -> int:
        return max(math.ceil(count / max(cores * self.chunks_per_core, 1)), 1)


# Convenience instance mirroring the paper's default configuration.
acc = AdaptiveCoreChunk
