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

On a serving mesh (``ServeScheduler(mesh=...)``) every rank runs its own
front end and event loop, fed the same requests in the same order (the
same seeded trace), and their ticks must meet.  Arrivals land by wall
clock, so at a given tick the ranks' queues could differ: mesh rank 0
decides.  Its submissions (with their arrival stamps and deadlines),
rejections and cancellations since the last tick are broadcast before
each tick (``Mesh.agree``, as the scheduler's deadline sweep is), and
every other rank applies them in the same order, so the same ids land
in the same ticks everywhere.  Another rank's ``submit`` waits for rank
0's verdict on its request of the same ordinal (the id, or the same
``QueueFullError`` / ``PromptTooLongError``), and its ``cancel`` waits
for the request to end and says whether rank 0 cancelled it.  A rank
never admits a request rank 0 has not admitted, and every rank's
records hold the same tokens.  ``stop`` is the last agreement: rank 0
sends its close and the others agree until they have it, so every rank
must stop its front end.

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
        # On a mesh (module docstring): rank 0's outbox of events since
        # the last tick; another rank's verdicts by submission ordinal,
        # the submits waiting for one, and the streams it opened.
        mesh = sched.mesh
        self._mesh = mesh
        self._lead = mesh is None or mesh.rank == mesh.leader
        self._attempts = 0
        self._outbox: list[tuple] = []
        self._verdicts: dict[int, tuple] = {}
        self._owed: dict[int, asyncio.Future] = {}
        self._opened: dict[int, TokenStream] = {}
        self._agreed: asyncio.Event | None = None
        self._closed = mesh is None

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
        self._agreed = asyncio.Event()
        self._closed = self._mesh is None
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
        if self._mesh is not None:
            # The last agreement: rank 0's events since the last tick and
            # its close; another rank agrees until it has the close.
            if self._lead:
                self._tell(("close",))
                self._agree_arrivals()
            while not self._closed:
                self._agree_arrivals()
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
        idx = self._attempts
        self._attempts += 1
        if not self._lead:
            return await self._follow(idx)
        while self.queue_depth() >= self.max_queue:
            if not wait:
                self.rejected += 1
                self._tell(("reject", idx))
                raise QueueFullError(self.queue_depth(), self.max_queue)
            self._space.clear()
            await self._space.wait()
        try:
            rid = self.sched.submit(tokens, max_new_tokens,
                                    deadline=deadline)
        except PromptTooLongError as e:
            self._tell(("too_long", idx, e.prompt_len, e.max_len))
            raise
        req = self.sched.requests[rid]
        self._tell(("submit", idx, rid, req.tokens.tolist(),
                    req.max_new_tokens, deadline, req.arrival))
        stream = self._open(rid, req.arrival, deadline)
        self._wake.set()
        return stream

    def _open(self, rid: int, submitted_at: float,
              deadline: float | None) -> TokenStream:
        self.records[rid] = RequestRecord(
            rid=rid, submitted_at=submitted_at, deadline=deadline)
        stream = TokenStream(self, rid)
        self._streams[rid] = stream
        self._emitted[rid] = 0
        return stream

    def _tell(self, event: tuple) -> None:
        """Rank 0's event for the other ranks (nothing off a mesh).  It
        wakes the serve loop: a rank that owes this verdict waits in the
        agreement until rank 0 runs one."""
        if self._mesh is not None:
            self._outbox.append(event)
            self._wake.set()

    async def _follow(self, idx: int) -> TokenStream:
        """Another rank's ``submit``: rank 0's verdict on its submission
        of the same ordinal (module docstring)."""
        if idx not in self._verdicts:
            fut = asyncio.get_running_loop().create_future()
            self._owed[idx] = fut
            self._wake.set()
            await fut
        verdict = self._verdicts.pop(idx)
        if verdict[0] == "reject":
            raise QueueFullError(self.queue_depth(), self.max_queue)
        if verdict[0] == "too_long":
            raise PromptTooLongError(verdict[1], verdict[2])
        return self._opened.pop(verdict[1])

    def _agree_arrivals(self) -> None:
        """Before each tick on a mesh: rank 0's events since the last
        one, broadcast, and applied in order on every other rank."""
        def take():
            events, self._outbox = self._outbox, []
            return events

        events = self.sched._agree(take)
        if not self._lead:
            for ev in events:
                self._apply(ev)
        self._closed = self._closed or ("close",) in events
        self._agreed.set()
        self._agreed.clear()

    def _apply(self, ev: tuple) -> None:
        kind = ev[0]
        if kind == "close":
            return
        if kind == "cancel":
            self.sched.cancel(ev[1])
            self._pump()
            return
        idx = ev[1]
        if kind == "submit":
            _, _, rid, toks, new, deadline, arrival = ev
            got = self.sched.submit(toks, new, deadline=deadline,
                                    arrival=arrival)
            if got != rid:
                raise RuntimeError(f"rank 0 gave request id {rid}, this "
                                   f"rank's scheduler {got}: the ranks' "
                                   f"schedulers have diverged")
            self._opened[rid] = self._open(rid, arrival, deadline)
            self._verdicts[idx] = ("ok", rid)
        elif kind == "reject":
            self.rejected += 1
            self._verdicts[idx] = ("reject",)
        else:
            self._verdicts[idx] = ("too_long",) + tuple(ev[2:])
        fut = self._owed.pop(idx, None)
        if fut is not None:
            fut.set_result(None)

    async def cancel(self, rid: int) -> bool:
        """Cancel ``rid`` mid-flight: its slot is released immediately;
        tokens it has in a not-yet-drained dispatch are dropped."""
        if not self._lead:
            req = self.sched.requests.get(rid)
            while req is not None and req.state not in TERMINAL_STATES:
                self._wake.set()
                await self._agreed.wait()
            return req is not None and req.state is RequestState.CANCELLED
        ok = self.sched.cancel(rid)
        if ok:
            self._tell(("cancel", rid))
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
            if self._mesh is not None:
                self._agree_arrivals()
                if self._closed:        # rank 0 has stopped
                    return
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
                if self.sched.pending or self._owed \
                        or self._outbox:     # raced with a submit
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
