"""Runtime calibration of T0 and per-iteration time (paper Section 5).

The paper: "The time (T_i) will be calculated once for each workload, and
then will be used to find T1 ... HPX runs a benchmark on an empty thread to
calculate overhead which is T0."

Host backend: both are measured here, once, and cached: T0 on the
wall-clock; t_iter on the wall-clock for a body that runs on the host,
and between CUDA events for one whose work runs on the card
(``DeviceBody``).
Mesh backend: wall-clock is meaningless on the dry-run container, so the
analytic path (core/cost_model.py) derives the same quantities from
compiled FLOPs/bytes and the hardware constants.  Both paths produce plain
floats consumed by the same Overhead-Law solver.

Two additions beyond the paper's one-shot scheme:

* **Online smoothing** (``smooth_t_iter``): observed per-chunk wall-clock
  from the executors (core/feedback.py) is folded back into the cached
  t_iter with an exponential moving average, so acc decisions track drift
  (thermal throttling, co-tenants, data-dependent cost) instead of
  trusting one calibration forever.
* **Disk persistence** (``save``/``load``/``persistent``): calibrations
  survive process restarts as JSON under a cache directory, with a
  versioned key schema (``SCHEMA_VERSION``) so stale formats are ignored
  rather than misread.
* **Tuned-winner records** (``tuned``/``set_tuned``): the kernel block
  autotuner (kernels/autotune.py) persists its measured winners — small
  JSON dicts, not scalars — through the same store, so kernel tuning,
  T0 and t_iter share one file, one schema version and one atomic
  writer.  Schema v2 added this table.

Schema v3 (current) unifies the three key conventions into **one
entries table**: each persisted key maps to a typed record carrying
whichever quantities exist for it (``t0`` / ``t_iter`` / ``tuned``)
plus its *provenance* level (``measured`` / ``online`` — the
ExecutionModel's evidence ladder; see core/model.py).  v1 and v2 files
still load — their per-table entries migrate into the unified form on
the first save — and files are always written as v3.

This module stays policy-free: it stores and round-trips what the
``ExecutionModel`` engine decides.  ``smooth_t_iter`` is the EMA
primitive the engine's online-refinement policy calls — consumers go
through ``ExecutionModel.observe``, not this method.
"""
from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
import weakref
from typing import Any, Callable, Hashable

from .executor import Chunk, Executor, make_chunks
from .future import when_all

SCHEMA_VERSION = 3

# Provenance upgrade order (mirrors core/model.py, which owns the
# semantics; duplicated as data here to keep this module import-light).
_PROVENANCE_ORDER = ("analytic", "measured", "online")

# Smoothing factor for online t_iter feedback: high enough to converge on
# a drifted workload within a few dozen observations, low enough that one
# noisy chunk cannot swing the next decision.
DEFAULT_SMOOTHING = 0.25


def _key_str(key: Hashable) -> str:
    """Stable textual form of a calibration key.

    Keys are small hashables (strings / tuples of strings and ints); their
    ``repr`` round-trips identically within and across processes, which is
    all persistence needs (the JSON file maps key-strings to floats; we
    never parse the string back into a tuple).  A key that holds a
    ``FunctionKey`` means something in this process only and is never
    written to disk.
    """
    return repr(key)


class FunctionKey:
    """The identity of a user's function inside a calibration key.

    One per live function object (``function_key``): the same object
    gets the same key on every call, two live objects get two keys, and
    serials are never reused, so a function allocated where a collected
    one lived (the same ``id()``) starts with a key of its own.  It names
    an object of this process, so a cache does not persist it."""

    __slots__ = ("serial", "name")

    def __init__(self, serial: int, name: str):
        self.serial = serial
        self.name = name

    def __eq__(self, other) -> bool:
        return isinstance(other, FunctionKey) and other.serial == self.serial

    def __hash__(self) -> int:
        return hash(("FunctionKey", self.serial))

    def __repr__(self) -> str:
        return f"FunctionKey({self.name!r}, {self.serial})"


_fn_keys: "weakref.WeakKeyDictionary[Any, FunctionKey]" = \
    weakref.WeakKeyDictionary()
_pinned: dict[int, tuple[Any, FunctionKey]] = {}
_serials = itertools.count(1)
_fn_lock = threading.Lock()


def function_key(fn: Callable) -> FunctionKey:
    """The ``FunctionKey`` of ``fn``.  Held weakly: the entry goes with
    the function.  A callable that takes no weak reference is pinned
    instead (kept alive, so its ``id()`` is never reused)."""
    name = (f"{getattr(fn, '__module__', None)}."
            f"{getattr(fn, '__qualname__', type(fn).__qualname__)}")
    with _fn_lock:
        try:
            key = _fn_keys.get(fn)
            if key is None:
                key = _fn_keys[fn] = FunctionKey(next(_serials), name)
            return key
        except TypeError:            # no weak reference, or unhashable
            pinned = _pinned.get(id(fn))
            if pinned is None:
                pinned = _pinned[id(fn)] = (fn, FunctionKey(next(_serials),
                                                            name))
            return pinned[1]


def _process_local(key: Any) -> bool:
    if isinstance(key, FunctionKey):
        return True
    return isinstance(key, tuple) and any(_process_local(k) for k in key)


class CalibrationCache:
    """Per-workload memo: first invocation measures, later ones reuse.

    Internally keyed by ``_key_str(key)`` so in-memory lookups and
    persisted entries share one namespace.  All mutation is lock-guarded:
    the feedback layer records observations from executor pool threads.
    """

    def __init__(self, path: str | None = None):
        self._t_iter: dict[str, float] = {}
        self._t0: dict[str, float] = {}
        self._tuned: dict[str, dict] = {}
        self._provenance: dict[str, str] = {}
        self._local: set[str] = set()      # keys naming a FunctionKey
        self._lock = threading.Lock()
        self._last_smooth_save = 0.0
        self.path = path
        if path:
            self.load(path)

    def _k(self, key: Hashable) -> str:
        """``_key_str(key)`` of a key about to be stored, noted as
        process-local when it holds a ``FunctionKey``."""
        k = _key_str(key)
        if _process_local(key):
            with self._lock:
                self._local.add(k)
        return k

    # -- memoised measurement ------------------------------------------------
    def t_iter(self, key: Hashable, measure: Callable[[], float]) -> float:
        k = self._k(key)
        if k not in self._t_iter:
            value = measure()
            with self._lock:
                self._t_iter.setdefault(k, value)
            self._autosave()
        return self._t_iter[k]

    def t0(self, key: Hashable, measure: Callable[[], float]) -> float:
        k = self._k(key)
        if k not in self._t0:
            value = measure()
            with self._lock:
                self._t0.setdefault(k, value)
            self._autosave()
        return self._t0[k]

    # -- online feedback -----------------------------------------------------
    def peek_t_iter(self, key: Hashable) -> float | None:
        """Current t_iter for ``key`` without triggering a measurement."""
        return self._t_iter.get(_key_str(key))

    def smooth_t_iter(self, key: Hashable, observed: float,
                      alpha: float = DEFAULT_SMOOTHING) -> float:
        """Fold an observed per-element time into the cache (EMA).

        First observation seeds the entry; later ones move it by
        ``alpha``:  new = alpha * observed + (1 - alpha) * old.
        Returns the smoothed value now backing decisions for ``key``.

        Persistence is write-throttled two ways: the JSON file is
        rewritten only when the smoothed value actually moved (> 5%
        relative), and — for keys that keep moving, e.g. the serve
        loop's per-tick host-overhead observations, which jitter more
        than 5% forever — at most once per second.  A converged or
        merely noisy serving loop stops touching disk; observations
        arrive per chunk/tick, on the hot path.  The first observation
        for a key always persists immediately.
        """
        k = self._k(key)
        now = time.monotonic()
        with self._lock:
            old = self._t_iter.get(k)
            value = observed if old is None else (
                alpha * observed + (1.0 - alpha) * old)
            self._t_iter[k] = value
            moved = old is None or abs(value - old) > 0.05 * abs(old)
            due = old is None or now - self._last_smooth_save >= 1.0
            if moved and due:
                self._last_smooth_save = now
        if moved and due:
            self._autosave()
        return value

    # -- tuned-winner records (kernel block autotuner) -----------------------
    def tuned(self, key: Hashable) -> dict | None:
        """The persisted winner record for ``key``, or None.

        Records are small JSON-able dicts owned by the autotuner (block
        sizes, the measured seconds, the hardware key they were measured
        on) — this layer only stores and round-trips them.
        """
        rec = self._tuned.get(_key_str(key))
        return dict(rec) if rec is not None else None

    def set_tuned(self, key: Hashable, record: dict) -> None:
        """Persist a winner record (overwrites any previous one)."""
        k = self._k(key)
        with self._lock:
            self._tuned[k] = dict(record)
        self._autosave()

    # -- provenance ----------------------------------------------------------
    def provenance(self, key: Hashable) -> str | None:
        """The recorded evidence level for ``key`` (None: analytic-only)."""
        return self._provenance.get(_key_str(key))

    def note_provenance(self, key: Hashable, level: str) -> str:
        """Record ``level`` for ``key``, monotone: upgrades persist,
        downgrades are ignored (once a key has online observations it
        never reports weaker evidence again).  Returns the level now in
        effect."""
        if level not in _PROVENANCE_ORDER:
            raise ValueError(f"unknown provenance level {level!r}")
        k = self._k(key)
        changed = False
        with self._lock:
            old = self._provenance.get(k, _PROVENANCE_ORDER[0])
            if (_PROVENANCE_ORDER.index(level)
                    > _PROVENANCE_ORDER.index(old)):
                # "analytic" is the default and never stored explicitly.
                self._provenance[k] = level
                changed = True
            effective = self._provenance.get(k, _PROVENANCE_ORDER[0])
        if changed:
            self._autosave()
        return effective

    def clear(self) -> None:
        with self._lock:
            self._t_iter.clear()
            self._t0.clear()
            self._tuned.clear()
            self._provenance.clear()
            self._local.clear()

    def __len__(self) -> int:
        return len(self._t_iter) + len(self._t0) + len(self._tuned)

    # -- persistence ---------------------------------------------------------
    @classmethod
    def persistent(cls, cache_dir: str | None = None,
                   name: str = "calibration.json") -> "CalibrationCache":
        """A cache backed by ``cache_dir/name`` (created on first save).

        Default directory: ``$REPRO_CAL_CACHE_DIR`` or
        ``~/.cache/repro-torch-acc`` — a store of its own, apart from the
        JAX package's: the serve workload keys carry no hardware field,
        so timings from the two frameworks must never share one file.
        """
        cache_dir = cache_dir or os.environ.get(
            "REPRO_CAL_CACHE_DIR",
            os.path.join(os.path.expanduser("~"), ".cache",
                         "repro-torch-acc"))
        return cls(path=os.path.join(cache_dir, name))

    def save(self, path: str | None = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("no path bound to this cache and none given")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with self._lock:
            # v3: one unified table — each key's record carries whichever
            # quantities exist for it plus its provenance level.  Keys of
            # one process's function objects stay out of the file.
            entries: dict[str, dict] = {}
            for k, v in self._t0.items():
                entries.setdefault(k, {})["t0"] = v
            for k, v in self._t_iter.items():
                entries.setdefault(k, {})["t_iter"] = v
            for k, r in self._tuned.items():
                entries.setdefault(k, {})["tuned"] = dict(r)
            for k, p in self._provenance.items():
                if k in entries:
                    entries[k]["provenance"] = p
            for k in self._local:
                entries.pop(k, None)
            blob = {"version": SCHEMA_VERSION, "entries": entries}
        # Atomic replace so a crashed writer never leaves a torn file.
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(blob, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return path

    def load(self, path: str | None = None) -> bool:
        """Merge entries from ``path``; returns True if anything loaded.

        Accepts schema v1/v2 (three per-quantity tables) and v3 (one
        unified entries table) — older files migrate in place: loading
        a v1/v2 file and saving writes v3.  Missing files and unknown
        versions are treated as an empty cache (calibration re-measures;
        never an error)."""
        path = path or self.path
        if not path or not os.path.exists(path):
            return False
        try:
            with open(path) as f:
                blob = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        if not isinstance(blob, dict) or blob.get("version") not in (
                1, 2, SCHEMA_VERSION):
            return False
        with self._lock:
            if blob.get("version") == SCHEMA_VERSION:
                entries = blob.get("entries", {})
                if not isinstance(entries, dict):
                    return False
                for k, rec in entries.items():
                    if not isinstance(rec, dict):
                        continue
                    k = str(k)
                    if isinstance(rec.get("t0"), (int, float)):
                        self._t0[k] = float(rec["t0"])
                    if isinstance(rec.get("t_iter"), (int, float)):
                        self._t_iter[k] = float(rec["t_iter"])
                    if isinstance(rec.get("tuned"), dict):
                        self._tuned[k] = dict(rec["tuned"])
                    if rec.get("provenance") in _PROVENANCE_ORDER:
                        self._provenance[k] = rec["provenance"]
                return True
            # v1/v2 migration: per-table stores with no provenance —
            # everything persisted was measured at least once, so the
            # conservative level is "measured" (online upgrades re-earn
            # themselves from live observations).
            for name, store in (("t0", self._t0), ("t_iter", self._t_iter)):
                entries = blob.get(name, {})
                if isinstance(entries, dict):
                    for k, v in entries.items():
                        store[str(k)] = float(v)
                        self._provenance.setdefault(str(k), "measured")
            tuned = blob.get("tuned", {})
            if isinstance(tuned, dict):
                for k, v in tuned.items():
                    if isinstance(v, dict):
                        self._tuned[str(k)] = dict(v)
                        self._provenance.setdefault(str(k), "measured")
        return True

    def _autosave(self) -> None:
        if self.path:
            try:
                self.save(self.path)
            except OSError:  # pragma: no cover - e.g. read-only cache dir
                pass


GLOBAL_CACHE = CalibrationCache()


def measure_t0_empty_task(executor: Executor, repeats: int = 32) -> float:
    """Time dispatching an empty task through the executor ("empty thread"
    benchmark).  Returns seconds per parallel-region invocation."""

    def empty(_: Chunk) -> None:
        return None

    chunks = make_chunks(max(executor.num_units(), 2), 1)
    # Warm the pool (thread creation is a one-time cost, not T0).
    when_all(executor.bulk_async_execute(empty, chunks)).result()
    start = time.perf_counter()
    for _ in range(repeats):
        when_all(executor.bulk_async_execute(empty, chunks)).result()
    return (time.perf_counter() - start) / repeats


DEVICE_SAMPLE = 1 << 20       # elements: enough thread blocks to fill an H100
SPIN_CYCLES = 2_000_000       # ~1 ms of spin at ~2 GHz


class DeviceBody:
    """A chunk thunk ``body(start, size)`` whose work runs on a CUDA
    stream.  Calling it queues the work on ``stream`` and waits for it,
    as a host body returns once done; ``queue`` only queues it, so that
    ``measure_iteration_device`` can bracket it with CUDA events."""

    def __init__(self, queue: Callable[[int, int], Any], stream: Any):
        self.queue = queue
        self.stream = stream

    def __call__(self, start: int, size: int) -> Any:
        import torch

        with torch.cuda.stream(self.stream):
            out = self.queue(start, size)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        return out


def measure_iteration_device(body: DeviceBody, count: int,
                             sample: int | None = None,
                             repeats: int = 3) -> float:
    """Seconds per element of ``body``'s work on the card.

    The same basis as T0 needs: the launch and the wait for completion
    are per-task costs, so they stay out of the per-element time.  A spin
    holds the stream busy while the host queues the start event, the
    body's launches and the end event, so the span between the events is
    the card's time alone.  The sample (default: min(count, 2^20)) gives
    the kernel enough thread blocks to fill the card; best of
    ``repeats``, divided by the sample size.
    """
    import torch

    n = min(count, sample or DEVICE_SAMPLE)
    best = float("inf")
    with torch.cuda.stream(body.stream):
        body.queue(0, n)  # build the kernel, warm the allocator
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            body.queue(0, n)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3)
    return best / n


def measure_iteration_wallclock(
    body: Callable[[int, int], Any],
    count: int,
    sample: int | None = None,
    repeats: int = 3,
) -> float:
    """Seconds per element of ``body(start, size)`` (jit'd chunk thunk).

    Runs the body on a sample prefix (default: min(count, 64k)), takes the
    best of ``repeats`` to strip scheduler noise, divides by the sample
    size.  ``body`` must synchronise internally (block_until_ready).
    """
    n = min(count, sample or 65536)
    body(0, n)  # compile / warm caches
    best = float("inf")
    for _ in range(repeats):
        t = time.perf_counter()
        body(0, n)
        best = min(best, time.perf_counter() - t)
    return best / n
