"""The paper's "Overhead Law" (Section 3) as pure functions.

Model: a loop that takes ``T1`` seconds sequentially runs in

    T_N = T1 / N + T0                                        (Eq. 1)

on ``N > 1`` units, where ``T0`` is a *fixed* serial overhead paid only
when parallelism is attempted (distinct from Amdahl: the serial part is
not a fraction of the work; distinct from Gustafson: it does not grow
with the work).

Derived quantities:

    S(N)  = T1 / (T1/N + T0)                                 (Eq. 3)
    E(N)  = S / N                                            (Eq. 5)
    N     = (1-E)/E * T1/T0                                  (Eq. 7)
    T_opt = E/(1-E) * T0        (= 19*T0 at E=0.95)
    N_C   = T1 / T_opt                                       (Eq. 8)
    T_m   = T1 / (N_C * C)                                   (Eq. 9)
    N_CH  = N_E / (N_C * C)                                  (Eq. 10)

All functions are scalar, side-effect free, and unit-agnostic (seconds in,
seconds out).  ``AccDecision`` bundles the full adaptive decision used by
the acc execution-parameters object (core/acc.py).
"""
from __future__ import annotations

import dataclasses
import math

DEFAULT_EFFICIENCY = 0.95
DEFAULT_CHUNKS_PER_CORE = 8  # C in Eq. 9/10, from the paper's experiments


def predicted_time(t1: float, n: int, t0: float) -> float:
    """Eq. 1.  For n == 1 the overhead is *not* paid (sequential path)."""
    if n <= 1:
        return t1
    return t1 / n + t0


def speedup(t1: float, n: int, t0: float) -> float:
    """Eq. 3 (valid for n > 1; returns 1.0 at n == 1 by construction)."""
    tn = predicted_time(t1, n, t0)
    return t1 / tn if tn > 0 else float("inf")


def efficiency(t1: float, n: int, t0: float) -> float:
    """Eq. 5: E = S / N."""
    return speedup(t1, n, t0) / max(n, 1)


def parallel_fraction(t1: float, t0: float) -> float:
    """The Amdahl-comparable fraction p = T1 / (T0 + T1) (paper Eq. 4)."""
    return t1 / (t0 + t1) if (t0 + t1) > 0 else 1.0


def t_opt(t0: float, eff: float = DEFAULT_EFFICIENCY) -> float:
    """Work per core that sustains efficiency ``eff``:  T_opt = E/(1-E)*T0.

    At the paper's E = 0.95 this is exactly 19 * T0.
    """
    if not (0.0 < eff < 1.0):
        raise ValueError(f"efficiency must be in (0, 1), got {eff}")
    return eff / (1.0 - eff) * t0


def optimal_cores(t1: float, t0: float, eff: float = DEFAULT_EFFICIENCY) -> float:
    """Eq. 7:  N = (1-E)/E * T1/T0  (== T1 / T_opt).  Unclamped, real-valued."""
    if t0 <= 0:
        return float("inf")
    return (1.0 - eff) / eff * (t1 / t0)


def chunk_size(
    n_elements: int,
    n_cores: int,
    chunks_per_core: int = DEFAULT_CHUNKS_PER_CORE,
) -> int:
    """Eq. 10:  N_CH = N_E / (N_C * C), rounded up, at least 1."""
    denom = max(n_cores * chunks_per_core, 1)
    return max(math.ceil(n_elements / denom), 1)


@dataclasses.dataclass(frozen=True)
class AccDecision:
    """The full adaptive decision for one workload.

    Produced by ``decide``; consumed by executors, the training loop
    (microbatching), serving, and the Pallas block-size tuner.
    """

    n_elements: int
    t_iter: float            # measured/estimated seconds per element
    t1: float                # sequential time for the whole workload
    t0: float                # calibrated parallelisation overhead
    n_cores: int             # processing units to use (clamped)
    n_cores_unclamped: float  # raw Eq. 7 value, before clamping
    chunk_elems: int         # elements per task (Eq. 10, floored at T_m)
    n_chunks: int            # resulting task count
    predicted_time: float    # Eq. 1 at the decision point
    predicted_speedup: float
    predicted_efficiency: float
    efficiency_target: float
    chunks_per_core: int

    @property
    def parallel(self) -> bool:
        return self.n_cores > 1


def decide(
    *,
    t_iter: float,
    n_elements: int,
    t0: float,
    max_cores: int,
    eff: float = DEFAULT_EFFICIENCY,
    chunks_per_core: int = DEFAULT_CHUNKS_PER_CORE,
) -> AccDecision:
    """The complete acc policy (paper Section 3 + Section 5).

    1. ``T1 = t_iter * n_elements``.
    2. ``N_C`` from Eq. 7, clamped to ``[1, max_cores]`` ("unless it is
       more than the maximum available cores, in which case the maximum
       available cores are used").  If even 2 cores cannot reach the
       efficiency target the workload runs sequentially (Eq. 1 is only
       defined for N > 1).
    3. Chunk size from Eq. 10, floored so each chunk carries at least
       ``T_m = T_opt / C`` worth of work.
    """
    if n_elements <= 0:
        raise ValueError("n_elements must be positive")
    if t_iter < 0 or t0 < 0:
        raise ValueError("times must be non-negative")

    t1 = t_iter * n_elements
    raw = optimal_cores(t1, t0, eff) if t0 > 0 else float(max_cores)
    cores = int(min(max(math.floor(raw), 1), max_cores))
    if cores < 2:
        cores = 1

    if cores == 1:
        chunk = n_elements
        n_chunks = 1
    else:
        chunk = chunk_size(n_elements, cores, chunks_per_core)
        # Floor: a chunk must carry at least T_m = T_opt / C of work.
        if t_iter > 0:
            min_elems = math.ceil(t_opt(t0, eff) / chunks_per_core / t_iter)
            chunk = max(chunk, min(min_elems, n_elements))
        n_chunks = math.ceil(n_elements / chunk)
        cores = min(cores, n_chunks)  # never more units than tasks

    t_pred = predicted_time(t1, cores, t0)
    return AccDecision(
        n_elements=n_elements,
        t_iter=t_iter,
        t1=t1,
        t0=t0,
        n_cores=cores,
        n_cores_unclamped=raw,
        chunk_elems=chunk,
        n_chunks=n_chunks,
        predicted_time=t_pred,
        predicted_speedup=t1 / t_pred if t_pred > 0 else 1.0,
        predicted_efficiency=(t1 / t_pred / cores) if t_pred > 0 else 1.0,
        efficiency_target=eff,
        chunks_per_core=chunks_per_core,
    )
