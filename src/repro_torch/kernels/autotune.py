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

Shapes are bucketed to powers of two.

Kernels 1-3 take measured plans as well (``plan_rows``: kernel 1's
forward warps per block; ``plan_attention``: the split path's keys per
split or the tile path's schedule, ``tuning.candidates_attention``).
Their lookups sit on the model's hot path, so each call's answer is
kept in memory by the call's own arguments (``_plans``, the counterpart
of the reference's jit cache: a plan is resolved once per process and
call, then read back for free; a bucket-mate's winner read from the
store is capped to the call by ``_capped``).  Their probes run the call
itself with each candidate: the served lanes' own K/V and lengths, not
a synthetic workload (``kernels/ops.py``).  The attention key names no
kernel: kernels 2 and 3 take one plan for the same call, so the paged
kernel keeps giving the contiguous kernel's bits (a divergence from the
reference, which keys by ``"flash_attention"``).  A lookup that misses
while a CUDA graph is being captured raises: a search synchronises,
which would break the capture; the graphs resolve every plan in the
eager step before it (``serve/graphs.py``).  Probes run under
``strict.allow_sync()``, time the card with CUDA events
(``device_seconds``) and are not counted as launches of the path.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math
from typing import Callable

import torch

from ..core import strict
from ..core.calibration import CalibrationCache
from ..core.model import DecisionKey, ExecutionModel, hardware_key
from . import build
from . import flash_attention as kfa
from . import rmsnorm as krms
from . import tuning
from .tuning import BlockPlan, candidates_attention

KEY_NAMESPACE = "kernel_block"

__all__ = ["KernelTuner", "TuneReport", "KEY_NAMESPACE", "shape_bucket",
           "candidates_1d", "candidates_attention", "device_seconds"]


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


_flush: dict = {}


def device_seconds(call: Callable[[], object],
                   device: torch.device) -> float | None:
    """Mean device time of ``call`` on the card, in seconds: CUDA events
    around each call, L2 flushed before each (outside the span), the
    stream held by a spin while the launches queue so that the span holds
    device time and not the host's launch cost.  None off the card (the
    search then takes the wall clock)."""
    if device.type != "cuda":
        return None
    buf = _flush.get(device.index)
    if buf is None:
        buf = _flush[device.index] = torch.empty(
            64 * 2 ** 20, dtype=torch.uint8, device=device)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(5)]
    torch.cuda._sleep(2_000_000)
    for start, end in events:
        buf.zero_()
        start.record()
        call()
        end.record()
    events[-1][1].synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / len(events) / 1e3


@functools.cache
def _hardware_of(device: str) -> str:
    return hardware_key(device)


def _value(plan: kfa.AttentionPlan) -> int:
    """A plan's tunable: keys per split, or the tile path's block rows."""
    return plan.chunk if plan.path == "split" else plan.block_rows


@functools.lru_cache(maxsize=1024)
def _capped(b: int, hq: int, hkv: int, sq: int, dtype, value: int,
            skv: int) -> kfa.AttentionPlan:
    """The prior of the call with its tunable set to ``value``, capped to
    the kv extent ``skv`` (cached: the hot path reads it per call)."""
    return tuning.cap_attention(
        kfa.with_value(kfa.attention_plan(b, hq, hkv, sq, dtype), value),
        skv)


@dataclasses.dataclass(frozen=True)
class TuneReport:
    """One resolved lookup: where the block came from and what each
    candidate cost (empty timings when the store already had a winner)."""

    key: tuple
    winner: tuple
    prior: tuple
    measured: bool
    timings: tuple[tuple[tuple, float], ...] = ()

    @property
    def prior_seconds(self) -> float | None:
        for cand, sec in self.timings:
            if cand == self.prior:
                return sec
        return None

    @property
    def winner_seconds(self) -> float | None:
        for cand, sec in self.timings:
            if cand == self.winner:
                return sec
        return None


class KernelTuner:
    """Per-(kernel, shape-bucket, dtype, hardware) measured block store.

    ``run`` callables passed to the ``plan_*`` methods execute the real
    kernel once for a candidate on synthetic data of the right shape
    (the plain version for a CPU tensor); the engine's probe synchronises
    the card around each.  ``hardware`` pins the hardware key; by default
    the 1-d plans key by ``hardware_key()`` and kernels 1-3 by the
    device of the call, so CPU winners and the card's key apart.
    """

    def __init__(self, cache: CalibrationCache | None = None, *,
                 repeats: int = 3, hardware: str | None = None):
        self.cache = cache if cache is not None else CalibrationCache()
        self.model = ExecutionModel.of(self.cache)
        self.repeats = max(int(repeats), 1)
        self._hardware = hardware
        self.hardware = hardware if hardware is not None else hardware_key()
        self.searches = 0      # measured searches (cache misses)
        self.cache_hits = 0    # lookups answered from the store
        self.reports: collections.deque[TuneReport] = \
            collections.deque(maxlen=256)
        # Kernels 1-3: each call's answer in this process, by the call's
        # own arguments (the hot path's hit).
        self._plans: dict = {}
        self._recording: list[dict] = []

    @classmethod
    def persistent(cls, cache_dir: str | None = None, **kw) -> KernelTuner:
        """A tuner over the same persistent store the acc calibrations
        use: training and serving processes share winners through it."""
        return cls(CalibrationCache.persistent(cache_dir), **kw)

    def _hw(self, device) -> str:
        if self._hardware is not None:
            return self._hardware
        return _hardware_of(str(torch.device(device)))

    def _resolve(self, key: DecisionKey, candidates: list[tuple],
                 run: Callable[..., object], fields: tuple[str, ...],
                 legal: Callable[[tuple], bool] | None = None) -> tuple:
        """Winner for ``key`` (which includes the hardware id), resolved
        by the ExecutionModel: from the store when a legal record is
        there, else the measured search over ``candidates``, persisted.
        The probes' launches are taken back from the launch counters."""
        before = build.snapshot()
        with strict.allow_sync():
            decision = self.model.tuned_blocks(key, candidates, run, fields,
                                               repeats=self.repeats,
                                               legal=legal)
        build.restore(before)
        measured = bool(decision.input("measured"))
        if measured:
            self.searches += 1
        else:
            self.cache_hits += 1
        self.reports.append(TuneReport(
            key=key.cache_key(), winner=decision.block_plan,
            prior=tuple(candidates[0]), measured=measured,
            timings=tuple(decision.input("timings", ()))))
        return decision.block_plan

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
        (block,) = self._resolve(key, cands, lambda b: run(int(b)),
                                 ("block",))
        # A bucket-mate's winner may be wider than this (smaller) input.
        block = min(block, tuning.round_up(
            n, tuning.tile_elems(bytes_per_elem)))
        return BlockPlan(block=block, grid=math.ceil(n / block))

    # -- kernels 1-3 ---------------------------------------------------------
    def _lookup(self, call: tuple, resolve: Callable[[], tuple]) -> tuple:
        """The answer kept for ``call`` (the call's own arguments: a hit
        costs a dict lookup), else resolved (``resolve()`` searches or
        reads the store, capped to the call) and kept.  A miss during a
        graph capture raises."""
        winner = self._plans.get(call)
        if winner is None:
            if build.capturing():
                raise RuntimeError(
                    f"kernel tuner: no plan for {call} while a CUDA graph "
                    f"is captured; a search would synchronise inside the "
                    f"capture (resolve every plan in the step before it)")
            winner = self._plans[call] = resolve()
        for rec in self._recording:
            rec[call] = winner
        return winner

    def rows_key(self, entry: str, rows: int, d: int, *, dtype,
                 device="cpu") -> DecisionKey:
        """Kernel 1's key: (entry, d, row bucket), dtype, hardware."""
        return DecisionKey(kind=KEY_NAMESPACE,
                           shape=(entry, int(d), shape_bucket(rows)),
                           dtype=str(dtype), hardware=self._hw(device))

    def attention_key(self, b: int, hq: int, hkv: int, sq: int, skv: int,
                      d: int, *, dtype, causal: bool = True,
                      window: int | None = None,
                      device="cpu") -> DecisionKey:
        """The attention key: (path, packed rows, Hkv, B, D, capacity
        bucket, causal, window), dtype, hardware; no kernel name."""
        prior = kfa.attention_plan(b, hq, hkv, sq, dtype)
        return DecisionKey(
            kind=KEY_NAMESPACE,
            shape=("attention", prior.path, prior.rows, int(hkv), int(b),
                   int(d), shape_bucket(skv), bool(causal),
                   0 if window is None else int(window)),
            dtype=str(dtype), hardware=self._hw(device))

    def plan_rows(self, entry: str, rows: int, d: int,
                  run: Callable[[int], object], *, dtype,
                  device="cpu") -> int:
        """Measured warps per block for kernel 1's forward ``entry``
        (``rmsnorm`` or ``add_rmsnorm``) over ``rows`` rows of ``d``;
        ``run(warps)`` executes it once."""
        def resolve():
            return self._resolve(
                self.rows_key(entry, rows, d, dtype=dtype, device=device),
                [(w,) for w in krms.WARPS], lambda w: run(int(w)),
                ("warps",), lambda w: w[0] in krms.WARPS)

        (warps,) = self._lookup(("rows", entry, rows, d, dtype, device),
                                resolve)
        return warps

    def plan_attention(self, b: int, hq: int, hkv: int, sq: int, skv: int,
                       d: int, run: Callable[[kfa.AttentionPlan], object],
                       *, dtype, causal: bool = True,
                       window: int | None = None,
                       device="cpu") -> kfa.AttentionPlan:
        """Measured plan of one attention call (kernel 2 or 3: the key
        names neither) over a kv extent ``skv``; ``run(plan)`` executes
        the call once with that plan.  Keyed by (path, packed rows, Hkv,
        B, D, capacity bucket, causal, window), dtype and hardware; a
        bucket-mate's winner is capped to this call."""
        def resolve():
            split = kfa.attention_plan(b, hq, hkv, sq, dtype).path == "split"
            values = [(_value(p),) for p in candidates_attention(
                b, hq, hkv, sq, skv, dtype)]
            (value,) = self._resolve(
                self.attention_key(b, hq, hkv, sq, skv, d, dtype=dtype,
                                   causal=causal, window=window,
                                   device=device),
                values,
                lambda v: run(_capped(b, hq, hkv, sq, dtype, v, skv)),
                ("chunk" if split else "block_rows",),
                lambda w: (_value(_capped(b, hq, hkv, sq, dtype, w[0],
                                          skv)),) in values)
            return (_value(_capped(b, hq, hkv, sq, dtype, value, skv)),)

        (value,) = self._lookup(("attention", b, hq, hkv, sq, skv, d, dtype,
                                 causal, window, device), resolve)
        return _capped(b, hq, hkv, sq, dtype, value, skv)

    def winner(self, call) -> tuple | None:
        """The answer this process holds for ``call`` (a key
        ``recording`` collected; None: not resolved, or forgotten)."""
        return self._plans.get(call)

    def forget(self) -> None:
        """Drop the answers held in memory: the next lookup of each call
        reads the store again (graphs that baked one capture anew)."""
        self._plans.clear()

    @contextlib.contextmanager
    def recording(self):
        """Collect ``{call: answer}`` of every kernel 1-3 lookup made
        inside the block (what a captured graph bakes in)."""
        rec: dict = {}
        self._recording.append(rec)
        try:
            yield rec
        finally:
            self._recording.remove(rec)
