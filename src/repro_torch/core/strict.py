"""Strict runtime mode: turn latent hot-path hazards into hard errors.

The static pass (the repo's lint) catches donation and host-sync hazards
it can see in source; this module catches the ones it can't — at
runtime, where they actually bite.  Two enforcers:

* **Poison-on-donate**: ``SlotKVCachePool`` marks its cache tree as
  handed to a dispatch that updates it in place.  Until ``adopt()``
  rebinds the pool, any read of ``pool.caches`` raises
  ``DonatedCacheError`` — the same discipline the JAX package's donated
  buffers need, kept so both serve loops obey one protocol.

* **Stale pages**: the paged pool (``PagedKVCachePool``) poisons a page
  the moment its refcount drops to zero; under strict mode every table
  it hands to a dispatch is validated first, and one that still maps a
  freed page raises ``StalePageError``.

* **Sync guard**: ``hot_dispatch_guard()`` sets
  ``torch.cuda.set_sync_debug_mode("error")`` around the serve tick, so
  any *implicit* device→host synchronisation (``.item()``, ``.cpu()``,
  a boolean-mask index, a blocking copy) raises.  The sanctioned syncs
  (the drain's one copy per dispatch, the first token of a request, the
  periodic timing sync) lower the mode around themselves with
  :func:`allow_sync`.  On the CPU there is nothing to guard and the
  guard does nothing.

Enablement: set ``REPRO_STRICT=1`` in the environment (the test suite
does), or call :func:`enable`.  When disabled, every hook here is a
no-op and the hot path pays nothing.
"""
from __future__ import annotations

import contextlib
import os

_FORCED = False


class DonatedCacheError(RuntimeError):
    """A donated cache tree was read before ``adopt()`` rebound it."""

    def __init__(self, consumer: str):
        self.consumer = consumer
        super().__init__(
            f"pool.caches was handed to {consumer!r} and not yet "
            f"re-adopted — it is being updated by that dispatch and "
            f"must not be read (RL001)")


class StalePageError(RuntimeError):
    """A page table references a page that was freed back to the pool.

    The paged KV pool (``serve/kv_cache.PagedKVCachePool``) poisons a
    page the moment its refcount drops to zero — whether it was released
    with its slot, evicted from the prefix cache, or left behind as a
    copy-on-write source.  Until the page is re-acquired from the free
    list, any dispatch whose page table still maps it would read rows
    that a *different* request may already be writing — the paged
    analogue of the donated-buffer read RL001 exists for.  The pool
    validates every table it hands to a dispatch and raises this instead
    of silently serving a reused page."""

    def __init__(self, slot: int, page: int):
        self.slot = slot
        self.page = page
        super().__init__(
            f"slot {slot}'s page table maps page {page}, which was "
            f"freed back to the pool and not re-acquired — attention "
            f"through this table would read rows now owned by another "
            f"request (RL001, paged)")


def enabled() -> bool:
    """Strict mode is on via ``REPRO_STRICT=1`` or :func:`enable`."""
    return _FORCED or os.environ.get("REPRO_STRICT", "") == "1"


def enable() -> None:
    """Force strict mode on for this process (the ``--strict`` flag)."""
    global _FORCED
    _FORCED = True


def _cuda_live() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def _sync_mode(mode: int):
    import torch

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def hot_dispatch_guard():
    """Raise on implicit device→host synchronisation inside the block.

    Wraps the serve scheduler's ``tick()``.  A no-op unless strict mode
    is enabled and the CUDA runtime is in use.
    """
    if not enabled() or not _cuda_live():
        yield
        return
    with _sync_mode(2):     # "error"
        yield


@contextlib.contextmanager
def allow_sync():
    """Lower the sync guard for one sanctioned synchronisation."""
    if not _cuda_live():
        yield
        return
    with _sync_mode(0):
        yield
