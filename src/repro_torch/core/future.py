"""Futures for the v2 executor API (``hpx::future`` analogue).

A thin, thread-safe wrapper over ``concurrent.futures.Future`` adding the
two combinators HPX builds its execution model on:

* ``Future.then(fn)``        — continuation chaining (``hpx::future::then``);
* ``when_all(futures)``      — join a set of futures into one.

Executors return these from ``async_execute`` / ``bulk_async_execute`` and
consume them in ``then_execute``; algorithm code never blocks on a single
task, only on the joined ``when_all`` future at a genuine barrier.

Deviation from HPX noted for readers: ``when_all(fs).result()`` yields
the list of *values* (in the order the futures were passed), not a list of
futures — Python has no ``future.unwrap()`` idiom and every call site wants
the values.
"""
from __future__ import annotations

import concurrent.futures as _cf
import threading
from typing import Any, Callable, Iterable, Sequence


class Future:
    """A value that will exist later; may already be resolved ("ready")."""

    __slots__ = ("_inner",)

    def __init__(self, inner: _cf.Future | None = None):
        self._inner = inner if inner is not None else _cf.Future()

    # -- construction -------------------------------------------------------
    @classmethod
    def ready(cls, value: Any) -> "Future":
        """An already-resolved future (``hpx::make_ready_future``)."""
        f = _cf.Future()
        f.set_result(value)
        return cls(f)

    @classmethod
    def exceptional(cls, exc: BaseException) -> "Future":
        f = _cf.Future()
        f.set_exception(exc)
        return cls(f)

    @classmethod
    def from_call(cls, fn: Callable[..., Any], *args: Any) -> "Future":
        """Run ``fn`` immediately on the calling thread, capture the
        outcome.  The inline-execution building block for synchronous
        executors."""
        f = _cf.Future()
        try:
            f.set_result(fn(*args))
        except Exception as e:  # noqa: BLE001 - exceptions travel via future
            f.set_exception(e)
        return cls(f)

    # -- state --------------------------------------------------------------
    def done(self) -> bool:
        return self._inner.done()

    def result(self, timeout: float | None = None) -> Any:
        return self._inner.result(timeout)

    # HPX spelling.
    get = result

    def set_result(self, value: Any) -> None:
        self._inner.set_result(value)

    def set_exception(self, exc: BaseException) -> None:
        self._inner.set_exception(exc)

    # -- combinators --------------------------------------------------------
    def then(self, fn: Callable[[Any], Any], executor: Any = None) -> "Future":
        """``fn(self.result())`` as a new Future.

        With ``executor`` the continuation is dispatched through
        ``executor.async_execute`` (i.e. may run on a pool thread);
        without, it runs inline on whichever thread resolves this future
        (or the caller's, if already resolved).  Exceptions — from this
        future or from ``fn`` — propagate to the returned future.
        """
        out = Future()

        def _fire(inner: _cf.Future) -> None:
            try:
                value = inner.result()
            except Exception as e:  # noqa: BLE001
                out.set_exception(e)
                return
            if executor is None:
                _chain_call(out, fn, value)
            else:
                try:
                    nxt = executor.async_execute(fn, value)
                except Exception as e:  # noqa: BLE001
                    out.set_exception(e)
                    return
                nxt._inner.add_done_callback(lambda g: _transfer(g, out))

        self._inner.add_done_callback(_fire)
        return out


def _chain_call(out: Future, fn: Callable[[Any], Any], value: Any) -> None:
    try:
        out.set_result(fn(value))
    except Exception as e:  # noqa: BLE001
        out.set_exception(e)


def _transfer(src: _cf.Future, dst: Future) -> None:
    try:
        dst.set_result(src.result())
    except Exception as e:  # noqa: BLE001
        dst.set_exception(e)


def when_all(futures: Iterable[Future]) -> Future:
    """Join: resolves to the list of values, in argument order, once every
    input future has resolved.  The first exception (in argument order)
    propagates instead."""
    fs: Sequence[Future] = list(futures)
    out = Future()
    if not fs:
        out.set_result([])
        return out
    lock = threading.Lock()
    remaining = [len(fs)]

    def _one_done(_: _cf.Future) -> None:
        with lock:
            remaining[0] -= 1
            if remaining[0]:
                return
        try:
            out.set_result([f.result() for f in fs])
        except Exception as e:  # noqa: BLE001
            out.set_exception(e)

    for f in fs:
        f._inner.add_done_callback(_one_done)
    return out
