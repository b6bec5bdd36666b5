"""Measured block autotuner for the 1-d kernels — the paper's feedback
loop reaching the kernel grid.

``tuning.plan_1d`` maps the paper's quantities onto the card's grid
analytically (chunk → one thread block, T_m floor → one tile).  That is
the static Overhead-Law *prior*; this module measures instead:

* **candidate generation** — a small neighbourhood around the analytic
  prior (quartered, halved, doubled and quadrupled blocks, one tile, the
  whole input), every candidate a whole number of tiles and no wider
  than the input rounded up to a tile;
* **measurement harness** — each candidate is wall-clocked through the
  ``ExecutionModel`` engine's measured-search policy (core/model.py),
  which synchronises the card around every probe: one untimed call, then
  best-of-``repeats``;
* **persistence** — the winner is stored through ``CalibrationCache``
  under a ``(kernel, shape-bucket, dtype, hardware)`` ``DecisionKey``,
  so a later process skips the search and another card keys apart.

Shapes are bucketed to powers of two.  1-d kernels only: attention's
``(block_q, block_kv)`` search waits for the flash kernel's ``tuner=``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable

from ..core.calibration import CalibrationCache
from ..core.model import DecisionKey, ExecutionModel, hardware_key
from . import tuning
from .tuning import BlockPlan

KEY_NAMESPACE = "kernel_block"

__all__ = ["KernelTuner", "TuneReport", "KEY_NAMESPACE", "shape_bucket",
           "candidates_1d"]


def shape_bucket(n: int) -> int:
    """Smallest power of two >= n (>= 1) — the shape-key granularity."""
    return 1 << max(int(n) - 1, 0).bit_length()


def candidates_1d(n: int, *, num_sms: int,
                  bytes_per_elem: int = 4) -> list[int]:
    """Candidate block sizes for a 1-d kernel, analytic prior first.

    Every candidate is a whole number of tiles, at least one tile and at
    most ``n`` rounded up to a tile."""
    n = max(int(n), 1)
    tile = tuning.tile_elems(bytes_per_elem)
    cap = tuning.round_up(n, tile)
    prior = tuning.plan_1d(n, num_sms=num_sms,
                           bytes_per_elem=bytes_per_elem).block

    def snap(b: int) -> int:
        return min(max((int(b) // tile) * tile, tile), cap)

    prior = snap(prior)
    out = [prior]
    for b in (prior // 4, prior // 2, prior * 2, prior * 4, tile, cap):
        b = snap(b)
        if b not in out:
            out.append(b)
    return out


@dataclasses.dataclass(frozen=True)
class TuneReport:
    """One resolved lookup: where the block came from and what each
    candidate cost (empty timings when the store already had a winner)."""

    key: tuple
    winner: tuple
    prior: tuple
    measured: bool
    timings: tuple[tuple[tuple, float], ...] = ()


class KernelTuner:
    """Per-(kernel, shape-bucket, dtype, hardware) measured block store.

    ``run(block)`` passed to ``plan_1d`` executes the real kernel once
    with that block on synthetic data of the right shape; the engine's
    probe synchronises the card around it.
    """

    def __init__(self, cache: CalibrationCache | None = None, *,
                 repeats: int = 3, hardware: str | None = None):
        self.cache = cache if cache is not None else CalibrationCache()
        self.model = ExecutionModel.of(self.cache)
        self.repeats = max(int(repeats), 1)
        self.hardware = hardware if hardware is not None else hardware_key()
        self.searches = 0      # measured searches (cache misses)
        self.cache_hits = 0    # lookups answered from the store
        self.reports: collections.deque[TuneReport] = \
            collections.deque(maxlen=256)

    def plan_1d(self, kernel: str, n: int, run: Callable[[int], None], *,
                num_sms: int, dtype: str = "torch.float32",
                bytes_per_elem: int = 4) -> BlockPlan:
        """Measured ``BlockPlan`` for a 1-d kernel over ``n`` elements:
        from the store when present, else the measured search over
        ``candidates_1d``, persisted."""
        n = max(int(n), 1)
        cands = [(c,) for c in candidates_1d(n, num_sms=num_sms,
                                             bytes_per_elem=bytes_per_elem)]
        key = DecisionKey(kind=KEY_NAMESPACE,
                          shape=(kernel, shape_bucket(n)),
                          dtype=str(dtype), hardware=self.hardware)
        decision = self.model.tuned_blocks(
            key, cands, lambda b: run(int(b)), ("block",),
            repeats=self.repeats)
        measured = bool(decision.input("measured"))
        if measured:
            self.searches += 1
        else:
            self.cache_hits += 1
        self.reports.append(TuneReport(
            key=key.cache_key(), winner=decision.block_plan,
            prior=cands[0], measured=measured,
            timings=tuple(decision.input("timings", ()))))
        # A bucket-mate's winner may be wider than this (smaller) input.
        block = min(decision.block_plan[0], tuning.round_up(
            n, tuning.tile_elems(bytes_per_elem)))
        return BlockPlan(block=block, grid=math.ceil(n / block))
