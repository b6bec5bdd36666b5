"""KV cache pools for continuous batching (the counterparts of
``repro.serve.kv_cache.SlotKVCachePool`` and ``PagedKVCachePool``).

The per-layer K/V tensors are allocated **once**, with the leading batch
dimension read as ``n_slots`` fixed-size slots.  A request acquires a
slot on admission, carries its own position inside it, and releases it
when it finishes, so requests of any length join and leave the running
batch with no reallocation (``allocations`` stays 1).

Layout: per layer ``{"k", "v"}`` of shape (n_slots, H_kv, max_len, D),
or under a sliding window (n_slots, H_kv, S, D) with ``S = min(window,
max_len)``: each slot is a ring, position ``p`` in row ``p % S``.  A
slot's position stays the count of tokens it cached (it runs past
``S``); ``read_slot`` / ``write_slot`` carry the ring's rows as they
lie, and the forward computes every write's row from the positions on
the device (``lm.forward_cached``).

Where the JAX pool relies on buffer donation, this one updates in place:
``read_slot`` returns views into the pool, a prefill chunk writes its
rows through them, and ``write_slot`` / ``adopt`` only check that what
they are handed is the pool's own storage (copying a foreign row in).
The strict-mode poison between a dispatch (``mark_donated``) and the
matching ``adopt`` is kept, so both serve loops obey one protocol.

``PagedKVCachePool`` is the paged alternative: K/V live in fixed-size
pages behind per-slot page tables, so identical prompt prefixes share
pages copy-on-write through a token-keyed prefix cache.  Same poison /
adopt discipline, same ``allocations`` invariant.

A recurrent layer holds its state (``mamba2`` ``{"ssm", "conv"}``,
``mlstm`` ``{"mem"}``, ``slstm`` ``{"c", "n", "m"}``) as slot rows
``(n_slots, ...)`` in both pools, beside the K/V: a state is a running
reduction over every token, so ``acquire`` zeroes every one of the
slot's state rows (on the device, with no host sync), as the reference
does -- sLSTM's ``m`` too, which a fresh state starts at -1e30 -- and
the paged pool reuses no prefix for an arch that has one
(``prefix_cache``).  Neither pool takes a cross-attention arch
(``refuse_cross_attention``), as in the reference.

With ``mesh`` (a ``launch.mesh.Mesh`` of ('data', 'model')) each rank
holds its part, by ``launch/sharding.cache_specs`` and
``paged_cache_specs`` under the serving plan (``sharding.tp_plan``,
cached): K/V by the attention rule (its kv heads where both head counts
split, the one kv head its q heads read under "kv_shared", its rotary
pairs of every head's dims under "head_dim"), and a recurrent state's
heads or channels where its block's do (Mamba2's conv carry: this
rank's x channels and the B/C channels whole); the slot pool holds only
its replica's slot group (``lanes``, ``n_slots / data`` rows); the
paged pool holds every page (replicated over 'data': prefix sharing
lets any lane map any page) and its replica's slot group of recurrent
state rows.  The host bookkeeping (free list, positions, page tables,
prefix cache) is the whole pool's and the same on every rank.  A paged
replica's writes reach the others' copies of the stores through
``exchange_rows``, and a fork into another replica's slot group takes
its state rows there (``fork``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..collectives import all_gather_into, broadcast
from ..configs.base import ArchConfig
from ..core import strict
from ..device import resolve_device
from ..models import attention, lm


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
    """Hashable (shape, dtype, device) signature of a cache list: every
    tensor of every layer's dict."""
    return tuple((name, tuple(t.shape), str(t.dtype), str(t.device))
                 for c in caches for name, t in c.items())


def refuse_cross_attention(cfg: ArchConfig, who: str) -> None:
    """The reference's refusal: per-request frontend features are not
    modelled by the scheduler or its pools, so a cross-attention arch
    serves through ``ServeEngine``'s lock-step batch path."""
    if "cross_attn" in cfg.layer_kinds():
        raise ValueError(
            f"{who} does not serve cross-attention archs (per-request "
            f"frontend feats); use ServeEngine's legacy batch path")


def _zero_states(kinds, caches: list, slot: int) -> None:
    """Zero ``slot``'s rows of every recurrent state (a memset on the
    device each, no host sync).  K/V rows need no wipe: attention masks
    by position."""
    for kind, c in zip(kinds, caches, strict=True):
        if kind not in lm.ATTN_KINDS:
            for t in c.values():
                t[slot].zero_()


def serve_mesh_replicas(mesh, n_slots: int) -> int:
    """The data replicas a serving ``mesh`` splits ``n_slots`` into;
    raises unless it is a ``launch.mesh.Mesh`` over ('data', 'model')
    whose replicas divide the slots."""
    if getattr(mesh, "ranks", None) is None \
            or set(mesh.axis_names) != {"data", "model"}:
        raise TypeError(
            "mesh must be a launch.mesh.Mesh over ('data', 'model') "
            "(launch.mesh.make_serve_mesh)")
    from ..launch.mesh import n_data_replicas

    n = n_data_replicas(mesh)
    if n_slots % n:
        raise ValueError(
            f"n_slots={n_slots} must divide into {n} data-parallel "
            f"replicas (mesh {dict(mesh.shape)})")
    return n


class _MeshPart:
    """A pool's place on a serving mesh: its replica's slot group
    ``[lo, lo + local)`` of ``n_slots``, the data group, and the
    tensor-parallel plan its caches are laid out by (``plan``: this
    rank's kv heads and each recurrent state's heads or channels,
    ``lm.init_caches(..., tp=plan)``; ``kv_heads``: the kv heads it
    holds)."""

    def __init__(self, cfg: ArchConfig, n_slots: int, mesh,
                 force_attn: str | None = None):
        if mesh is None:
            self.mesh, self.replica, self.n_replicas = None, 0, 1
            self.lo, self.local, self.plan = 0, n_slots, None
            self.kv_heads, self.head_dim = cfg.n_kv_heads, cfg.head_dim_
            return
        from ..launch import sharding

        self.mesh = mesh
        self.n_replicas = serve_mesh_replicas(mesh, n_slots)
        self.local = n_slots // self.n_replicas
        self.replica = mesh.coord("data")
        self.lo = self.replica * self.local
        self.plan = sharding.tp_plan(cfg, mesh, cached=True,
                                     force_attn=force_attn)
        self.kv_heads, self.head_dim = attention.local_kv(cfg, self.plan)

    @property
    def lanes(self) -> slice:
        return slice(self.lo, self.lo + self.local)

    def index(self, slot: int) -> int:
        """``slot``'s row in this rank's slot group."""
        i = slot - self.lo
        if not 0 <= i < self.local:
            raise ValueError(
                f"slot {slot} belongs to another data replica (this rank "
                f"holds slots [{self.lo}, {self.lo + self.local}))")
        return i

    def holds(self, slot: int) -> bool:
        return self.lo <= slot < self.lo + self.local


class SlotKVCachePool:
    """Fixed-size cache slots with a free-list and per-slot positions.
    ``force_attn``: the attention rule of the mesh plan
    (``sharding.tp_plan``), for tests and the size-1 paths."""

    def __init__(self, cfg: ArchConfig, n_slots: int, max_len: int, *,
                 window: int | None = None, dtype: torch.dtype | None = None,
                 mesh=None, device: str | torch.device = "cuda",
                 force_attn: str | None = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        refuse_cross_attention(cfg, "SlotKVCachePool")
        self.part = _MeshPart(cfg, n_slots, mesh, force_attn)
        self._donated_to: str | None = None
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_len = max_len
        self.window = window if window is not None else cfg.attn_window
        self.caches = lm.init_caches(cfg, self.part.local, max_len,
                                     window=self.window, dtype=dtype,
                                     device=self.device, tp=self.part.plan)
        self.kinds = tuple(cfg.layer_kinds())
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
        The slot's recurrent state rows are zeroed (K/V rows need no
        wipe: attention masks by position)."""
        if not self._free:
            return None
        slot = self._free.pop()
        self.owner[slot] = owner
        self.positions[slot] = 0
        if self.part.holds(slot):
            _zero_states(self.kinds, self.caches, self.part.index(slot))
        return slot

    def release(self, slot: int) -> None:
        if self.owner[slot] is None and slot in self._free:
            raise ValueError(f"slot {slot} double-released")
        self.owner[slot] = None
        self.positions[slot] = 0
        self._free.append(slot)

    @property
    def lanes(self) -> slice:
        """The slots whose rows this rank holds (all of them off a
        mesh): the decode lanes its steps run."""
        return self.part.lanes

    def holds(self, slot: int) -> bool:
        return self.part.holds(slot)

    # -- slot I/O ------------------------------------------------------------
    def read_slot(self, slot: int) -> list:
        """The slot's caches (K/V and state rows) as a batch-of-1 list of
        **views** into the pool: a forward that writes through them
        writes the pool.  On a mesh only a slot of this rank's group."""
        i = self.part.index(slot)
        return [{name: t[i:i + 1] for name, t in c.items()}
                for c in self.caches]

    def write_slot(self, slot: int, row_caches: list) -> None:
        """Land a batch-of-1 cache list in ``slot``.  Views from
        ``read_slot`` already hold the pool's storage (nothing to do);
        any other row is copied in."""
        i = self.part.index(slot)
        for c, row in zip(self.caches, row_caches, strict=True):
            for name, t in c.items():
                dst = t[i:i + 1]
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

    def rollback(self, slot: int, n: int) -> int:
        """Roll ``slot``'s position back by ``n`` tokens (speculative
        decode: drafts past the accept point are rejected).  Bookkeeping
        only: rows at and past the new position are dead storage the
        causal mask never reads, and the next write covers them."""
        if n < 0:
            raise ValueError(f"negative rollback: {n}")
        if n > self.positions[slot]:
            raise ValueError(
                f"rollback of {n} past slot {slot}'s position "
                f"{self.positions[slot]}")
        self.positions[slot] -= n
        return self.positions[slot]

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


class PagePoolExhaustedError(RuntimeError):
    """Every page is referenced by a live slot and nothing in the prefix
    cache is evictable: an ``ensure_writable`` could not be honoured.
    With the default sizing (``n_slots * pages_per_slot`` pages plus
    slack) this cannot happen for slot writes — it means the pool was
    constructed deliberately undersized, or refcounts leaked."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        super().__init__(
            f"page pool exhausted: all {n_pages} pages are referenced "
            f"by live slots (prefix cache already evicted)")


@dataclasses.dataclass
class _PrefixEntry:
    """One cached prompt block: the page holding the KV of tokens
    ``[len(key) - n_tokens, len(key))`` of the prefix spelled by ``key``
    (the dict key is the full token tuple up to and including this
    block, so a lookup hit *is* the content check)."""

    page: int
    n_tokens: int            # tokens of the block this page holds
    full: bool               # page-aligned block (ps tokens) or partial
    last_used: int = 0       # LRU clock for eviction


class PagedKVCachePool:
    """Paged KV pool: fixed-size pages behind per-slot page tables, with
    copy-on-write prefix sharing.

    Layout per attention layer: one flat token-major store ``{"k","v"}``
    of shape ``(n_pages * page_size, H_kv, D)`` — page ``p`` owns rows
    ``[p*ps, (p+1)*ps)``, allocated once (``allocations == 1``); per
    recurrent layer its state as slot rows ``(n_slots, ...)``, as in the
    slot pool.  The model reads a slot's rows through its table with the
    paged flash-attention kernel (``models/attention.py``), so the serve
    path builds no contiguous view, except under the "head_dim" split
    (a rank holds D / n dims of every row), whose plain-ops attention
    gathers each lane's rows through its table; ``read_slot`` /
    ``write_slot`` gather and scatter one (tests and tools), and
    ``slot_caches`` is what a prefill chunk of one slot runs over (the
    stores whole, the slot's state rows).

    ``prefix_cache`` (default on) is the reference's switch, and as
    there it stays off for any arch with a recurrent layer: a reused
    prefix would skip the state's updates over it.

    Page 0 is a permanently-allocated scratch page: unmapped table
    entries point at it, and writes the device drops (a speculative lane
    done inside its dispatch) are routed there.

    Copy-on-write protocol (host-side bookkeeping; device work only for
    the page copies, one ``copy_`` per layer and store):

    * every page has a refcount (slot tables + prefix-cache entries);
    * ``ensure_writable(slot, lo, hi)`` must precede any device write
      into ``[lo, hi)`` — it allocates unmapped pages and copy-on-writes
      shared ones;
    * ``register_prefix`` publishes a freshly-prefilled prompt's pages
      into the token-keyed prefix cache (including the partial tail
      page, which is what makes CoW fire on the very next decode
      write); ``acquire_with_prefix`` maps a later matching prompt's
      cached pages read-only and reports how many prefill tokens that
      avoided; least-recently-used entries nobody else references are
      evicted when the free list runs dry;
    * a page whose refcount hits zero goes back to the free list and is
      *poisoned* until re-acquired: under strict mode every table the
      pool hands out is validated first, and a stale mapping raises
      ``strict.StalePageError``.

    The donation poison is the slot pool's: ``caches`` raises between
    ``mark_donated`` and ``adopt`` under strict mode."""

    def __init__(self, cfg: ArchConfig, n_slots: int, max_len: int, *,
                 page_size: int = 16, n_pages: int | None = None,
                 window: int | None = None, dtype: torch.dtype | None = None,
                 mesh=None, device: str | torch.device = "cuda",
                 prefix_cache: bool = True, force_attn: str | None = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        refuse_cross_attention(cfg, "PagedKVCachePool")
        window = window if window is not None else cfg.attn_window
        if window is not None and window > 0:
            raise ValueError(
                "PagedKVCachePool does not support ring-buffer (SWA) "
                "windows: a wrapped write would straddle pages shared "
                "read-only; use SlotKVCachePool for windowed archs")
        lm.check_ported(cfg)
        self.part = _MeshPart(cfg, n_slots, mesh, force_attn)
        self._donated_to: str | None = None
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_len = max_len
        self.window = None
        self.page_size = ps = max(int(page_size), 1)
        self.pages_per_slot = -(-max_len // ps)          # ceil
        # Default sizing: full residency for every slot, plus one
        # pages-per-slot worth of slack so prefix-cache entries survive
        # a full pool, plus the scratch page.
        self.n_pages = int(n_pages) if n_pages is not None else \
            1 + n_slots * self.pages_per_slot + self.pages_per_slot
        if self.n_pages < 2:
            raise ValueError(f"n_pages must be >= 2, got {self.n_pages}")
        dtype = dtype or lm.compute_dtype(cfg)
        shape = (self.n_pages * ps, self.part.kv_heads, self.part.head_dim)
        self.kinds = tuple(cfg.layer_kinds())
        self.caches = [
            {"k": torch.zeros(shape, dtype=dtype, device=self.device),
             "v": torch.zeros(shape, dtype=dtype, device=self.device)}
            if kind in lm.ATTN_KINDS
            else lm.init_state(kind, cfg, self.part.local, dtype,
                               self.device, tp=self.part.plan)
            for kind in self.kinds]
        self._layout_sig = _layout(self.caches)
        self.allocations = 1            # store allocations ever made
        self._free = list(range(n_slots - 1, -1, -1))
        self.positions = [0] * n_slots
        self.owner: list[Any] = [None] * n_slots
        # Page bookkeeping (all host-side).  Page 0 is scratch: refcount
        # pinned at 1 so it can never be allocated or freed.
        self.page_refs = [0] * self.n_pages
        self.page_refs[0] = 1
        self._free_pages = list(range(self.n_pages - 1, 0, -1))
        self._poisoned: set[int] = set()
        self.page_tables = [[0] * self.pages_per_slot
                            for _ in range(n_slots)]
        # Prefix cache: token-tuple -> page entry (see _PrefixEntry).
        # ``_partials[key]`` lists the lengths of registered partial
        # tails extending the full-block chain ``key``.  Reuse is sound
        # only when every layer keys its cache by position.
        self.prefix_cache = bool(prefix_cache) and \
            all(kind in lm.ATTN_KINDS for kind in self.kinds)
        self._prefix: dict[tuple, _PrefixEntry] = {}
        self._partials: dict[tuple, list[int]] = {}
        self._lru = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefill_tokens_avoided = 0
        self.cow_copies = 0
        self.prefix_evictions = 0

    # -- donation poison (strict mode) ---------------------------------------
    @property
    def caches(self) -> list:
        """The per-layer page stores.  Poisons between ``mark_donated``
        and ``adopt`` exactly like the slot pool."""
        if self._donated_to is not None and strict.enabled():
            raise strict.DonatedCacheError(self._donated_to)
        return self._caches

    @caches.setter
    def caches(self, tree: list) -> None:
        self._caches = tree
        self._donated_to = None

    def mark_donated(self, consumer: str) -> None:
        self._donated_to = consumer

    def adopt(self, new_caches: list) -> None:
        """Rebind after a dispatch (see ``SlotKVCachePool.adopt``);
        raises ``CacheLayoutError`` on stores of another page geometry."""
        if _layout(new_caches) != self._layout_sig:
            raise CacheLayoutError(
                f"adopted cache tree does not match the paged pool "
                f"layout (n_pages={self.n_pages}, "
                f"page_size={self.page_size}, arch={self.cfg.name})")
        self.caches = new_caches

    # -- slot lifecycle ------------------------------------------------------
    def free_slots(self) -> int:
        return len(self._free)

    def free_pages(self) -> int:
        return len(self._free_pages)

    def pages_in_use(self) -> int:
        """Pages currently referenced (tables + prefix cache), scratch
        excluded."""
        return self.n_pages - 1 - len(self._free_pages)

    def acquire(self, owner: Any = None) -> int | None:
        """Claim a slot (no prefix lookup); None when exhausted.  The
        slot's recurrent state rows are zeroed."""
        if not self._free:
            return None
        slot = self._free.pop()
        self.owner[slot] = owner
        self.positions[slot] = 0
        if self.part.holds(slot):
            _zero_states(self.kinds, self.caches, self.part.index(slot))
        return slot

    @property
    def lanes(self) -> slice:
        """The slots whose state rows this rank holds and whose decode
        lanes its steps run (all of them off a mesh)."""
        return self.part.lanes

    def holds(self, slot: int) -> bool:
        return self.part.holds(slot)

    def slot_rows(self, slot: int, lo: int, hi: int) -> list[int]:
        """The store rows of logical positions ``[lo, hi)`` of ``slot``
        through its table (host side)."""
        ps = self.page_size
        table = self.page_tables[slot]
        return [table[p // ps] * ps + p % ps for p in range(lo, hi)]

    def exchange_rows(self, rows: list[list[int]]) -> None:
        """Bring every replica's copy of the stores up to date after a
        write: ``rows[r]`` lists the store rows data replica ``r`` wrote
        (every rank passes the same lists: they follow from the host
        bookkeeping).  One ``all_gather`` over the data group of each
        replica's rows of every attention store, padded to the longest
        list with scratch rows, then copied into place (the ranks of
        one data group share their 'model' coordinate, so their stores
        hold the same part of every row: a "split" rank's kv heads, a
        "kv_shared" rank's one head, a "head_dim" rank's D / n dims of
        every head).  Nothing to do
        with one replica (no other copy exists) or no attention layer (an
        xLSTM stack: its states are slot rows of each replica's own)."""
        part = self.part
        if part.mesh is None or part.n_replicas == 1:
            return
        width = max(len(r) for r in rows)
        stores = [t for kind, c in zip(self.kinds, self.caches, strict=True)
                  if kind in lm.ATTN_KINDS for t in (c["k"], c["v"])]
        if width == 0 or not stores:
            return
        mine = rows[part.replica]
        idx = host_to_device(mine + [0] * (width - len(mine)), torch.long,
                             self.device)
        send = torch.stack([t[idx] for t in stores])
        recv = torch.empty((part.n_replicas * send.shape[0],)
                           + tuple(send.shape[1:]), dtype=send.dtype,
                           device=send.device)
        all_gather_into(recv, send, group=part.mesh.groups["data"])
        recv = recv.view((part.n_replicas,) + tuple(send.shape))
        for r, got in enumerate(rows):
            if r == part.replica or not got:
                continue
            at = host_to_device(got, torch.long, self.device)
            for j, t in enumerate(stores):
                t.index_copy_(0, at, recv[r, j, :len(got)])

    def acquire_with_prefix(self, owner: Any,
                            prompt) -> tuple[int | None, int]:
        """Claim a slot and map any cached prefix of ``prompt`` into its
        page table read-only.  Returns ``(slot, reused)`` where
        ``reused`` is the number of prompt tokens whose KV is already
        resident (the caller starts prefill there).  Reuse is capped at
        ``len(prompt) - 1``: the last prompt token is always recomputed
        so the first-token logits exist."""
        slot = self.acquire(owner)
        if slot is None:
            return None, 0
        if not self.prefix_cache or prompt is None:
            return slot, 0
        toks = tuple(int(t) for t in prompt)
        self.prefix_lookups += 1
        ps = self.page_size
        cap = len(toks) - 1
        reused, j = 0, 0
        key: tuple = ()
        while (j + 1) * ps <= cap:
            cand = toks[:(j + 1) * ps]
            entry = self._prefix.get(cand)
            if entry is None:
                break
            self._map_shared(slot, j, entry)
            key, reused = cand, (j + 1) * ps
            j += 1
        # Longest registered partial tail extending the matched chain
        # (the block whose later extension is what CoW protects).
        for plen in sorted(self._partials.get(key, ()), reverse=True):
            # A tail page reaching past ``cap`` is still mappable — its
            # content for positions < cap is identical by key match; the
            # recomputed last token CoW-copies it before any write.
            if min(plen, cap) <= reused:
                continue
            entry = self._prefix.get(toks[:plen])
            if entry is not None:
                self._map_shared(slot, j, entry)
                reused = min(plen, cap)
                break
        if reused:
            self.prefix_hits += 1
            self.prefill_tokens_avoided += reused
            self.positions[slot] = reused
        return slot, reused

    def _map_shared(self, slot: int, j: int, entry: _PrefixEntry) -> None:
        self.page_refs[entry.page] += 1
        self.page_tables[slot][j] = entry.page
        self._lru += 1
        entry.last_used = self._lru

    def fork(self, src: int, owner: Any = None) -> int | None:
        """Clone ``src`` into a fresh slot sharing every mapped page
        copy-on-write (refcounts bumped; the first divergent write on
        either side triggers the copy); its recurrent state rows are
        copied.  None when no slot is free.  On a mesh every rank calls
        it (the bookkeeping is the same everywhere); where the new slot
        lies in another replica's slot group than ``src``, the state
        rows go there over 'data' (``_send_state_rows``)."""
        if not self._free:
            return None
        slot = self._free.pop()
        self.owner[slot] = owner
        self.positions[slot] = self.positions[src]
        for j, pid in enumerate(self.page_tables[src]):
            if pid:
                self.page_refs[pid] += 1
            self.page_tables[slot][j] = pid
        states = [t for kind, c in zip(self.kinds, self.caches, strict=True)
                  if kind not in lm.ATTN_KINDS for t in c.values()]
        part = self.part
        if not states:
            return slot
        if part.mesh is not None and \
                src // part.local != slot // part.local:
            self._send_state_rows(states, src, slot)
        elif part.holds(slot):
            i, j = part.index(slot), part.index(src)
            for t in states:
                t[i].copy_(t[j])
        return slot

    def _send_state_rows(self, states: list, src: int, slot: int) -> None:
        """``src``'s state rows into ``slot``, which lies in another data
        replica's slot group: over each data group (the ranks that share
        a 'model' coordinate, so hold the same tensor-parallel block of
        every state) ``src``'s replica broadcasts its rows, packed into
        one buffer per dtype, and ``slot``'s replica copies them in.
        Every rank of the mesh takes part; the rest receive and drop."""
        part = self.part
        mesh = part.mesh
        at = {"data": src // part.local, "model": mesh.coord("model")}
        root = int(mesh.ranks[tuple(at[a] for a in mesh.axis_names)])
        mine = part.holds(src)
        j = src - part.lo
        for dtype in dict.fromkeys(t.dtype for t in states):
            group = [t for t in states if t.dtype == dtype]
            if mine:
                buf = torch.cat([t[j].reshape(-1) for t in group])
            else:
                buf = torch.empty(sum(t[0].numel() for t in group),
                                  dtype=dtype, device=self.device)
            broadcast(buf, root, mesh.groups["data"])
            if part.holds(slot):
                i, off = part.index(slot), 0
                for t in group:
                    n = t[0].numel()
                    t[i].copy_(buf[off:off + n].view(t[i].shape))
                    off += n

    def release(self, slot: int) -> None:
        if self.owner[slot] is None and slot in self._free:
            raise ValueError(f"slot {slot} double-released")
        self.owner[slot] = None
        self.positions[slot] = 0
        for j, pid in enumerate(self.page_tables[slot]):
            if pid:
                self._unref_page(pid)
            self.page_tables[slot][j] = 0
        self._free.append(slot)

    # -- page allocation / refcounts -----------------------------------------
    def _unref_page(self, pid: int) -> None:
        self.page_refs[pid] -= 1
        if self.page_refs[pid] <= 0:
            # Freed: poisoned until re-acquired (strict.StalePageError).
            self.page_refs[pid] = 0
            self._poisoned.add(pid)
            self._free_pages.append(pid)

    def _alloc_page(self) -> int:
        if not self._free_pages:
            self._evict_for_space()
        if not self._free_pages:
            raise PagePoolExhaustedError(self.n_pages)
        pid = self._free_pages.pop()
        self._poisoned.discard(pid)
        self.page_refs[pid] = 1
        return pid

    def _evict_for_space(self) -> None:
        """Drop least-recently-used prefix entries whose page nobody
        else references until a page frees up (called only when the
        free list is empty)."""
        evictable = sorted(
            (e.last_used, key) for key, e in self._prefix.items()
            if self.page_refs[e.page] == 1)
        for _, key in evictable:
            self._drop_entry(key)
            self.prefix_evictions += 1
            if self._free_pages:
                return

    def _drop_entry(self, key: tuple) -> None:
        entry = self._prefix.pop(key)
        if not entry.full:
            chain = key[:len(key) - entry.n_tokens]
            lens = self._partials.get(chain)
            if lens is not None:
                lens.remove(len(key))
                if not lens:
                    del self._partials[chain]
        self._unref_page(entry.page)

    def ensure_writable(self, slot: int, lo: int, hi: int) -> bool:
        """Make pages covering ``[lo, hi)`` of ``slot`` exclusively
        writable: allocate unmapped entries, copy-on-write shared ones.
        Must precede every device write (prefill chunk, decode
        dispatch).  Returns True when the page table changed (the caller
        re-uploads it)."""
        if hi <= lo:
            return False
        if hi > self.max_len:
            raise SlotOverflowError(slot, hi, self.max_len)
        ps = self.page_size
        table = self.page_tables[slot]
        changed = False
        for j in range(lo // ps, -(-hi // ps)):
            pid = table[j]
            if pid == 0:
                table[j] = self._alloc_page()
                changed = True
            elif self.page_refs[pid] > 1:
                fresh = self._alloc_page()
                self._copy_page(pid, fresh)
                self.page_refs[pid] -= 1
                table[j] = fresh
                self.cow_copies += 1
                changed = True
        return changed

    def _copy_page(self, src: int, dst: int) -> None:
        """Device copy of one page: one ``copy_`` per layer and store."""
        ps = self.page_size
        for kind, c in zip(self.kinds, self.caches, strict=True):
            if kind not in lm.ATTN_KINDS:
                continue
            for store in c.values():
                store[dst * ps:(dst + 1) * ps].copy_(
                    store[src * ps:(src + 1) * ps])

    # -- prefix cache --------------------------------------------------------
    def register_prefix(self, slot: int, tokens) -> int:
        """Publish ``slot``'s freshly-prefilled prompt pages into the
        prefix cache (full blocks plus the partial tail).  The cache
        takes a reference on each page, so the slot's own next write
        into the tail page copy-on-writes it — cached content is never
        mutated.  Returns the number of new entries (none with
        ``prefix_cache`` off)."""
        if not self.prefix_cache:
            return 0
        toks = tuple(int(t) for t in tokens)
        ps = self.page_size
        table = self.page_tables[slot]
        added = 0
        for j in range(-(-len(toks) // ps)):
            end = min((j + 1) * ps, len(toks))
            key = toks[:end]
            if key in self._prefix:
                self._lru += 1
                self._prefix[key].last_used = self._lru
                continue
            pid = table[j]
            if pid == 0:        # nothing prefilled here
                continue
            n_tok = end - j * ps
            full = n_tok == ps
            self.page_refs[pid] += 1
            self._lru += 1
            self._prefix[key] = _PrefixEntry(
                page=pid, n_tokens=n_tok, full=full, last_used=self._lru)
            if not full:
                self._partials.setdefault(toks[:j * ps], []).append(end)
            added += 1
        return added

    # -- stale-page validation (strict mode) ---------------------------------
    def _validate_tables(self) -> None:
        """Raise ``strict.StalePageError`` if any live slot's table maps
        a freed page — the paged analogue of the donated-buffer read."""
        for slot in range(self.n_slots):
            if self.owner[slot] is None:
                continue
            for pid in self.page_tables[slot]:
                if pid and (pid in self._poisoned
                            or self.page_refs[pid] <= 0):
                    raise strict.StalePageError(slot, pid)

    # -- slot I/O ------------------------------------------------------------
    def _slot_indices(self, slot: int) -> list[int]:
        """Store row of every logical position of ``slot`` (length
        ``max_len``; unmapped entries resolve to the scratch page)."""
        ps = self.page_size
        return [pid * ps + i for pid in self.page_tables[slot]
                for i in range(ps)][:self.max_len]

    def page_table_array(self) -> torch.Tensor:
        """Every slot's page table as an (n_slots, pages_per_slot) int32
        tensor on the pool's device, in one asynchronous copy — what the
        paged kernel reads.  Every entry is checked against the store on
        this host copy (the kernel traps on one outside it, which would
        fail every later call in the process); freed pages are checked
        too under strict mode."""
        lo = min(map(min, self.page_tables))
        hi = max(map(max, self.page_tables))
        if lo < 0 or hi >= self.n_pages:
            raise ValueError(f"page table entries span [{lo}, {hi}], "
                             f"outside the store's [0, {self.n_pages})")
        if strict.enabled():
            self._validate_tables()
        return host_to_device(self.page_tables, torch.int32, self.device)

    def slot_caches(self, slot: int) -> list:
        """What a forward of ``slot`` alone (a prefill chunk, with the
        slot's page table) runs over: every attention layer's stores
        whole, every recurrent layer's state rows of ``slot`` as
        batch-of-1 **views** (updated in place)."""
        i = self.part.index(slot) if any(
            kind not in lm.ATTN_KINDS for kind in self.kinds) else 0
        return [c if kind in lm.ATTN_KINDS
                else {name: t[i:i + 1] for name, t in c.items()}
                for kind, c in zip(self.kinds, self.caches, strict=True)]

    def read_slot(self, slot: int) -> list:
        """The slot's rows gathered through its table into a contiguous
        batch-of-1 list ``{"k","v"}: (1, H_kv, max_len, D)``, and its state
        rows (1, ...) of recurrent layers (copies; the serve path reads
        the pages through the kernel instead)."""
        if strict.enabled():
            self._validate_tables()
        idx = host_to_device(self._slot_indices(slot), torch.long,
                             self.device)
        i = slot - self.part.lo
        return [{name: t[idx].permute(1, 0, 2)[None]
                 for name, t in c.items()} if kind in lm.ATTN_KINDS
                else {name: t[i:i + 1].clone()
                      for name, t in c.items()}
                for kind, c in zip(self.kinds, self.caches, strict=True)]

    def write_slot(self, slot: int, row_caches: list, lo: int = 0,
                   hi: int | None = None) -> None:
        """Scatter logical positions ``[lo, hi)`` of a contiguous
        batch-of-1 row (as ``read_slot`` returns) into the slot's pages;
        recurrent state is written whole.  The caller must have
        ``ensure_writable``-d the range — shared prefix pages outside it
        are never touched."""
        hi = self.max_len if hi is None else hi
        if hi - lo <= 0:
            return
        if hi > self.max_len:
            raise SlotOverflowError(slot, hi, self.max_len)
        idx = host_to_device(self._slot_indices(slot)[lo:hi],
                             torch.long, self.device)
        i = slot - self.part.lo
        for kind, c, row in zip(self.kinds, self.caches, row_caches,
                                strict=True):
            for name, t in c.items():
                if kind not in lm.ATTN_KINDS:
                    t[i:i + 1].copy_(row[name])
                    continue
                piece = row[name][0][:, lo:hi].permute(1, 0, 2)
                t.index_copy_(0, idx, piece.to(t.dtype))

    def advance(self, slot: int, n: int) -> int:
        """Advance the slot's position (see ``SlotKVCachePool.advance``)."""
        if n < 0:
            raise ValueError(f"negative advance: {n}")
        pos = self.positions[slot] + n
        if pos > self.max_len:
            raise SlotOverflowError(slot, pos, self.max_len)
        self.positions[slot] = pos
        return pos

    def rollback(self, slot: int, n: int) -> int:
        """Roll ``slot``'s position back by ``n`` tokens.  Page-refcount
        safe by construction: the dispatch's ``ensure_writable`` covered
        the whole speculative window before any device write, so every
        page touching the rolled-back range is exclusively this slot's
        and *stays mapped* — its stale rows are dead storage the causal
        mask never reads and the next write overwrites.  Raises if a
        shared page covers the range (the caller skipped
        ``ensure_writable``)."""
        if n < 0:
            raise ValueError(f"negative rollback: {n}")
        pos = self.positions[slot]
        if n > pos:
            raise ValueError(
                f"rollback of {n} past slot {slot}'s position {pos}")
        ps = self.page_size
        table = self.page_tables[slot]
        for j in range((pos - n) // ps, -(-pos // ps)):
            pid = table[j]
            if pid and self.page_refs[pid] > 1:
                raise ValueError(
                    f"rollback range [{pos - n}, {pos}) of slot {slot} "
                    f"touches shared page {pid} (refcount "
                    f"{self.page_refs[pid]}): the dispatch skipped "
                    f"ensure_writable over its speculative window")
        self.positions[slot] = pos - n
        return self.positions[slot]

    def positions_array(self) -> torch.Tensor:
        """Per-slot positions as an (n_slots,) long device tensor."""
        return host_to_device(
            [min(p, self.max_len - 1) for p in self.positions],
            torch.long, self.device)

    def prefix_stats(self) -> dict:
        """Prefix-cache effectiveness counters."""
        return {
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": self.prefix_hits / self.prefix_lookups
            if self.prefix_lookups else 0.0,
            "prefill_tokens_avoided": self.prefill_tokens_avoided,
            "cow_copies": self.cow_copies,
            "prefix_evictions": self.prefix_evictions,
            "prefix_entries": len(self._prefix),
            "pages_in_use": self.pages_in_use(),
            "n_pages": self.n_pages,
            "page_size": self.page_size,
        }

    def reset_prefix_stats(self) -> None:
        """Zero the effectiveness counters (cached entries stay live)."""
        self.prefix_lookups = self.prefix_hits = 0
        self.prefill_tokens_avoided = 0
        self.cow_copies = self.prefix_evictions = 0
