"""Asyncio serving front end over ``ServeScheduler``: streaming,
cancellation, SLO enforcement, and bounded-queue backpressure (the
counterpart of ``repro.serve.frontend``).

The scheduler (serve/scheduler.py) is a synchronous tick loop: callers
submit, call ``tick()`` until idle, then read finished outputs.  That is
the right shape for deterministic tests and benchmarks, but a serving
process faces *concurrent* callers with per-request lifecycles: tokens
must stream out as they are produced, a disconnected client must release
its cache slot immediately, a request whose deadline already passed must
be shed before its prefill burns compute, and a burst of arrivals must
hit a bounded queue — not an unbounded one that converts overload into
unbounded latency for everyone.

``ServeFrontend`` is that layer:

* **Streaming** — ``submit()`` returns a ``TokenStream`` async iterator;
  after every scheduler tick the front end pumps freshly landed tokens
  (including tokens drained from fused dispatches, scheduler
  ``pending_out``) into each request's stream.
* **Cancellation** — ``cancel()`` (or ``TokenStream.cancel()``) releases
  the request's KV slot straight back to the pool mid-prefill or
  mid-fused-dispatch; tokens already dispatched to the device are
  drained but dropped, and the pool's ``allocations==1`` donation
  invariant holds (tests pin this).
* **SLO enforcement** — the per-request ``deadline`` that has been
  sitting on ``Request`` is enforced: expired WAITING requests are shed
  before prefill (``RequestState.SHED``), late completions are counted
  as deadline misses, and both feed the per-tick ``TickRecord``
  accounting and this module's per-request ledger (``RequestRecord``) —
  the numbers SLO-goodput is computed from.
* **Backpressure** — ``max_queue`` bounds the waiting queue;
  ``submit(wait=False)`` raises ``QueueFullError`` (shed-at-the-door),
  ``wait=True`` suspends the caller until a slot frees.
* **Adaptive admission** — run the scheduler with
  ``admission="adaptive"`` and every tick's admission width becomes a
  ``serve_admission`` ExecutionModel decision (queue depth + measured
  tick time in, online-refined, visible in ``--explain-decisions``) —
  the decide→execute→observe→refine loop applied at the request level,
  the outermost layer of the stack.

The serve loop runs on the event loop (scheduler ticks are milliseconds
on the fused path; a tick's device wait is the natural scheduling
quantum).  Typed errors (``PromptTooLongError``, ``QueueFullError``)
surface at the ``submit()`` call site — a bad request is the caller's
structured rejection, never a serve-loop crash.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import Any

from .scheduler import (TERMINAL_STATES, PromptTooLongError,  # noqa: F401
                        RequestState, ServeScheduler)

_DONE = object()    # stream-closed sentinel (never a token value)


class QueueFullError(RuntimeError):
    """The bounded admission queue is full (backpressure): the caller
    should retry later, degrade, or route elsewhere — queueing more
    would only convert overload into deadline misses for everyone."""

    def __init__(self, depth: int, max_queue: int):
        self.depth = depth
        self.max_queue = max_queue
        super().__init__(
            f"admission queue full ({depth} waiting, bound {max_queue})")


@dataclasses.dataclass
class RequestRecord:
    """Per-request outcome ledger (what the load harness aggregates).

    ``status``: ``pending`` → ``completed`` | ``cancelled`` | ``shed``
    | ``aborted`` (front end stopped mid-request).  ``missed`` is the
    SLO verdict: a shed request or a completion past its deadline."""

    rid: int
    submitted_at: float
    deadline: float | None
    status: str = "pending"
    tokens: int = 0
    first_token_at: float | None = None
    finished_at: float | None = None
    token_times: list = dataclasses.field(default_factory=list)
    missed: bool = False


class TokenStream:
    """Async iterator over one request's tokens.  Ends (without error)
    when the request completes, is cancelled, or is shed — inspect
    ``record.status`` to tell which."""

    def __init__(self, frontend: "ServeFrontend", rid: int):
        self.frontend = frontend
        self.rid = rid
        self._q: asyncio.Queue = asyncio.Queue()

    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        item = await self._q.get()
        if item is _DONE:
            raise StopAsyncIteration
        return item

    async def cancel(self) -> bool:
        """Withdraw this request (releases its cache slot); the stream
        ends after any already-pumped tokens are consumed."""
        return await self.frontend.cancel(self.rid)

    @property
    def record(self) -> RequestRecord:
        return self.frontend.records[self.rid]


class ServeFrontend:
    """Async request front end over a ``ServeScheduler``.

    Use as an async context manager (``async with ServeFrontend(sched)
    as fe:``) or call ``start()`` / ``stop()`` explicitly.  One serve
    task ticks the scheduler while work is pending and parks on an
    event when idle; ``submit()`` wakes it.
    """

    def __init__(self, sched: ServeScheduler, *, max_queue: int = 256,
                 enforce_deadlines: bool = True):
        self.sched = sched
        self.max_queue = max(int(max_queue), 1)
        if enforce_deadlines:
            # Deadline-aware shedding before prefill (scheduler-side);
            # late-completion accounting is always on.
            sched.shed_expired = True
        self.clock = sched.clock
        self.records: dict[int, RequestRecord] = {}
        self.rejected = 0           # backpressure rejections (no rid)
        self._streams: dict[int, TokenStream] = {}
        self._emitted: dict[int, int] = {}
        self._task: asyncio.Task | None = None
        self._wake: asyncio.Event | None = None
        self._space: asyncio.Event | None = None

    # -- lifecycle -----------------------------------------------------------
    async def __aenter__(self) -> "ServeFrontend":
        await self.start()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.stop()

    async def start(self) -> None:
        if self._task is not None:
            return
        self._wake = asyncio.Event()
        self._space = asyncio.Event()
        self._space.set()
        self._task = asyncio.create_task(self._serve(), name="serve-loop")

    async def stop(self) -> None:
        """Stop the serve loop; land in-flight tokens and close every
        stream (consumers never hang on a stopped front end)."""
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        self.sched.flush()
        self._pump()
        for rid in list(self._streams):
            self._close(rid, "aborted")

    # -- API -----------------------------------------------------------------
    def queue_depth(self) -> int:
        """Requests waiting for a cache slot (the bounded queue)."""
        return len(self.sched._waiting)

    async def submit(self, tokens, max_new_tokens: int = 16, *,
                     deadline: float | None = None,
                     wait: bool = False) -> TokenStream:
        """Enqueue a request and return its token stream.

        Raises ``PromptTooLongError`` (typed, per-request — the serve
        loop is unaffected) for prompts that cannot fit a slot, and
        ``QueueFullError`` when the bounded queue is full and
        ``wait=False``; with ``wait=True`` the caller suspends until
        space frees instead.
        """
        if self._task is None:
            raise RuntimeError("ServeFrontend not started "
                               "(use 'async with' or call start())")
        while self.queue_depth() >= self.max_queue:
            if not wait:
                self.rejected += 1
                raise QueueFullError(self.queue_depth(), self.max_queue)
            self._space.clear()
            await self._space.wait()
        rid = self.sched.submit(tokens, max_new_tokens, deadline=deadline)
        self.records[rid] = RequestRecord(
            rid=rid, submitted_at=self.clock(), deadline=deadline)
        stream = TokenStream(self, rid)
        self._streams[rid] = stream
        self._emitted[rid] = 0
        self._wake.set()
        return stream

    async def cancel(self, rid: int) -> bool:
        """Cancel ``rid`` mid-flight: its slot is released immediately;
        tokens it has in a not-yet-drained dispatch are dropped."""
        ok = self.sched.cancel(rid)
        if ok:
            self._pump()    # closes the stream via the sentinel
        return ok

    def stats(self) -> dict:
        """Aggregate outcome counters (SLO-goodput's raw material)."""
        recs = list(self.records.values())
        by = lambda s: sum(1 for r in recs if r.status == s)  # noqa: E731
        completed = [r for r in recs if r.status == "completed"]
        ok = [r for r in completed if not r.missed]
        return {
            "submitted": len(recs) + self.rejected,
            "completed": len(completed),
            "completed_in_slo": len(ok),
            "goodput_tokens": sum(r.tokens for r in ok),
            "cancelled": by("cancelled"),
            "shed": by("shed"),
            "rejected": self.rejected,
            "missed": sum(1 for r in recs if r.missed) + self.rejected,
            "deadline_misses": self.sched.deadline_misses,
        }

    # -- serve loop ----------------------------------------------------------
    async def _serve(self) -> None:
        while True:
            if self.sched.pending:
                self.sched.tick()
                self._pump()
                # One tick per loop turn: submitters and consumers run
                # in the gaps between device dispatches.
                await asyncio.sleep(0)
            else:
                self.sched.flush()   # land any straggler fused tokens
                self._pump()
                self._wake.clear()
                if self.sched.pending:      # raced with a submit
                    continue
                await self._wake.wait()

    def _pump(self) -> None:
        """Move freshly landed tokens into each stream; close streams
        whose requests went terminal."""
        now = self.clock()
        for rid in list(self._streams):
            req = self.sched.requests.get(rid)
            if req is None:     # cleared behind our back
                self._close(rid, "aborted")
                continue
            rec = self.records[rid]
            seen = self._emitted[rid]
            fresh = req.out[seen:]
            if fresh:
                if rec.first_token_at is None:
                    rec.first_token_at = req.first_token_at \
                        if req.first_token_at is not None else now
                stream = self._streams[rid]
                # Inter-token timestamps: a fused dispatch drains k
                # tokens in one burst, and stamping them all ``now``
                # would report 0ms gaps (the itl_p99 the load harness
                # aggregates).  The tokens were *produced* spread across
                # the dispatch interval, so spread their emission times
                # linearly from the request's previous stamp to now —
                # the stream consumer still receives them in order, and
                # the last token of a burst keeps the exact drain time.
                prev = rec.token_times[-1] if rec.token_times \
                    else rec.first_token_at
                span = max(now - prev, 0.0)
                k = len(fresh)
                for i, tok in enumerate(fresh, start=1):
                    rec.token_times.append(prev + span * i / k)
                    stream._q.put_nowait(tok)
                rec.tokens += k
                self._emitted[rid] = seen + k
            if req.state in TERMINAL_STATES and (
                    req.state is not RequestState.DONE
                    or req.pending_out <= 0):
                self._close(rid, req.state.value, req)

    def _close(self, rid: int, status: str, req=None) -> None:
        stream = self._streams.pop(rid, None)
        self._emitted.pop(rid, None)
        if stream is not None:
            stream._q.put_nowait(_DONE)
        rec = self.records.get(rid)
        if rec is not None:
            rec.status = "completed" if status == "done" else status
            if req is not None:
                rec.finished_at = req.finished_at
            if rec.status == "completed":
                rec.missed = rec.deadline is not None \
                    and rec.finished_at is not None \
                    and rec.finished_at > rec.deadline
            elif rec.status == "shed":
                rec.missed = True       # work the SLO already lost
            # cancelled/aborted: the caller withdrew — not an SLO miss
        if self._space is not None \
                and self.queue_depth() < self.max_queue:
            self._space.set()
