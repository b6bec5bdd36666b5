"""Slot-based KV cache pool for continuous batching (the counterpart of
``repro.serve.kv_cache.SlotKVCachePool``).

The per-layer K/V tensors are allocated **once**, with the leading batch
dimension read as ``n_slots`` fixed-size slots.  A request acquires a
slot on admission, carries its own position inside it, and releases it
when it finishes, so requests of any length join and leave the running
batch with no reallocation (``allocations`` stays 1).

Layout: per layer ``{"k", "v"}`` of shape (n_slots, H_kv, max_len, D).

Where the JAX pool relies on buffer donation, this one updates in place:
``read_slot`` returns views into the pool, a prefill chunk writes its
rows through them, and ``write_slot`` / ``adopt`` only check that what
they are handed is the pool's own storage (copying a foreign row in).
The strict-mode poison between a dispatch (``mark_donated``) and the
matching ``adopt`` is kept, so both serve loops obey one protocol.

The paged pool (``PagedKVCachePool``) is a later slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ArchConfig
from ..core import strict
from ..device import resolve_device
from ..models import lm


class SlotOverflowError(ValueError):
    """A lane's position would pass its slot's ``max_len`` storage.  The
    scheduler budgets every fused dispatch against the slot's remaining
    room, so raising here means that accounting broke."""

    def __init__(self, slot: int, pos: int, max_len: int):
        self.slot = slot
        self.pos = pos
        self.max_len = max_len
        super().__init__(
            f"slot {slot} advanced past max_len: {pos} > {max_len}")


class CacheLayoutError(ValueError):
    """An adopted cache tree does not match the pool's layout (other slot
    count, other arch, other dtype or device): rebinding it would corrupt
    every later slot read.  Checked structurally, with no device sync."""


def _layout(caches: list) -> tuple:
    """Hashable (shape, dtype, device) signature of a cache list."""
    return tuple((name, tuple(c[name].shape), str(c[name].dtype),
                  str(c[name].device))
                 for c in caches for name in ("k", "v"))


class SlotKVCachePool:
    """Fixed-size cache slots with a free-list and per-slot positions."""

    def __init__(self, cfg: ArchConfig, n_slots: int, max_len: int, *,
                 window: int | None = None, dtype: torch.dtype | None = None,
                 mesh=None, device: str | torch.device = "cuda"):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded slot pools are not ported yet (ROADMAP.md, "
                "multi-GPU)")
        self._donated_to: str | None = None
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_len = max_len
        self.window = window if window is not None else cfg.attn_window
        self.caches = lm.init_caches(cfg, n_slots, max_len,
                                     window=self.window, dtype=dtype,
                                     device=self.device)
        self._layout_sig = _layout(self.caches)
        self.allocations = 1            # init_caches calls ever made
        self._free = list(range(n_slots - 1, -1, -1))
        self.positions = [0] * n_slots  # tokens cached per slot (host side)
        self.owner: list[Any] = [None] * n_slots

    # -- donation poison (strict mode) ---------------------------------------
    @property
    def caches(self) -> list:
        """The per-layer cache list.  Under strict mode, reading this
        between a dispatch that updates it (``mark_donated``) and the
        matching ``adopt()`` raises ``DonatedCacheError``."""
        if self._donated_to is not None and strict.enabled():
            raise strict.DonatedCacheError(self._donated_to)
        return self._caches

    @caches.setter
    def caches(self, tree: list) -> None:
        self._caches = tree
        self._donated_to = None

    def mark_donated(self, consumer: str) -> None:
        """Poison ``caches`` until the next rebind (``adopt()`` or a
        direct assignment)."""
        self._donated_to = consumer

    # -- free-list -----------------------------------------------------------
    def free_slots(self) -> int:
        return len(self._free)

    def acquire(self, owner: Any = None) -> int | None:
        """Claim a slot for ``owner``; None when the pool is exhausted.
        KV rows need no wipe: attention masks by position."""
        if not self._free:
            return None
        slot = self._free.pop()
        self.owner[slot] = owner
        self.positions[slot] = 0
        return slot

    def release(self, slot: int) -> None:
        if self.owner[slot] is None and slot in self._free:
            raise ValueError(f"slot {slot} double-released")
        self.owner[slot] = None
        self.positions[slot] = 0
        self._free.append(slot)

    # -- slot I/O ------------------------------------------------------------
    def read_slot(self, slot: int) -> list:
        """The slot's caches as a batch-of-1 list of **views** into the
        pool: a forward that writes through them writes the pool."""
        return [{name: c[name][slot:slot + 1] for name in ("k", "v")}
                for c in self.caches]

    def write_slot(self, slot: int, row_caches: list) -> None:
        """Land a batch-of-1 cache list in ``slot``.  Views from
        ``read_slot`` already hold the pool's storage (nothing to do);
        any other row is copied in."""
        for c, row in zip(self.caches, row_caches, strict=True):
            for name in ("k", "v"):
                dst = c[name][slot:slot + 1]
                src = row[name]
                if src.data_ptr() != dst.data_ptr():
                    dst.copy_(src)

    def adopt(self, new_caches: list) -> None:
        """Rebind the pool to ``new_caches`` — the list a decode dispatch
        updated in place and handed back.  Raises ``CacheLayoutError``
        when its shapes, dtypes or device differ from the pool's."""
        if _layout(new_caches) != self._layout_sig:
            raise CacheLayoutError(
                f"adopted cache tree does not match the pool layout "
                f"(n_slots={self.n_slots}, max_len={self.max_len}, "
                f"arch={self.cfg.name})")
        self.caches = new_caches

    def advance(self, slot: int, n: int) -> int:
        """Advance ``slot``'s position by ``n`` cached tokens; raises
        ``SlotOverflowError`` on overshoot (the write would run past the
        slot's storage, which the JAX pool would have clamped silently)."""
        if n < 0:
            raise ValueError(f"negative advance: {n}")
        pos = self.positions[slot] + n
        if pos > self.max_len:
            raise SlotOverflowError(slot, pos, self.max_len)
        self.positions[slot] = pos
        return pos

    def positions_array(self) -> torch.Tensor:
        """Per-slot positions as an (n_slots,) long tensor on the pool's
        device (free slots report 0; their decode lanes are ignored).
        Copied without a host sync."""
        return host_to_device(
            [min(p, self.max_len - 1) for p in self.positions],
            torch.long, self.device)


def host_to_device(values: list, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """A small host list as a device tensor, copied asynchronously (a
    blocking host→device copy is a sync the strict guard rejects)."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)
