"""Fused decode loop: ``k`` tokens per dispatch over the whole slot pool
(the counterpart of ``repro.serve.decode_loop``).

The JAX package compiles one ``lax.fori_loop`` whose trip count rides in
as data and vmaps a per-lane step over the pool.  Here the lane axis is
the batch dimension of one forward, and the loop is a host loop over
``max(steps)`` — the host already knows every lane's step budget, so it
also knows, at every iteration, which lanes are still active.  That
knowledge replaces the reference's ``masked_merge`` (a ``where`` over
the whole pool per step, which XLA aliases away but which would copy the
full KV pool per token eagerly): inactive lanes simply do not write
their K/V rows.  Nothing in the loop waits for the card: the next
tokens stay on the device and feed the next iteration and the next
dispatch; the emitted tokens come back in one copy per dispatch when
the scheduler drains it.

Token semantics match the per-tick path: both run ``make_lane_step``,
greedy argmax, and the same active-lane writes.

Over the paged pool (``make_paged_decode_step``) the loop is the same;
the page table rides in as data, fixed for the dispatch (the host
resolves allocation and copy-on-write before it), and every attention
reads the pages through the paged kernel.

Self-speculative decoding (``make_spec_decode_step`` and its paged twin)
drafts ``d - 1`` tokens per lane from the lane's own token history
(prompt lookup), verifies all ``d`` positions in one forward, accepts
the longest matching prefix plus the corrected token and rolls the lane
back to its accept point: the emitted tokens are greedy decoding's.  How
many rounds a dispatch needs depends on acceptance, which only the card
knows.  The first ``ceil(max_take / d)`` rounds are always needed (a
round emits at most ``d`` tokens per lane) and run without a read; after
them the host reads ``max(rem)`` back once per round (``to_host``, a
counted round trip) and stops at 0.  Lanes whose budget runs out inside
the dispatch are known only on the card: their K/V writes are dropped
there (``write_keep``).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core import strict
from ..models import lm
from .kv_cache import host_to_device

# One fused step serves every depth up to this; the scheduler clamps
# adaptive depth decisions against it.
DEFAULT_MAX_DEPTH = 32

# Self-speculative decoding: the history ring is the draft proposer's
# only state; the candidate depths are the widths the
# ``serve_spec_depth`` decision picks between.
DEFAULT_SPEC_HISTORY = 64
SPEC_DEPTH_CANDIDATES = (1, 2, 4, 8)


def to_host(t: torch.Tensor) -> np.ndarray:
    """The serve path's one device→host read: a sanctioned sync (the
    drain's copy per dispatch, the first token of a request, the
    per-tick decode's tokens), with the strict guard lowered around it."""
    with strict.allow_sync():
        return np.asarray(t.detach().to("cpu"))  # repro-lint: disable=RL002


def device_sync(device: torch.device) -> None:
    """Wait for the card (the timed thunks and the periodic honest-timing
    dispatch): without it a timing records the launch, not the work."""
    if device.type == "cuda":
        with strict.allow_sync():
            torch.cuda.synchronize(device)


def make_lane_step(cfg: ArchConfig, *, window: int | None = None,
                   page_size: int | None = None) -> Callable:
    """The decode step over the slot pool.

    ``lanes(params, caches, toks, poss, write_rows, page_table) ->
    next_toks``: every leading dim is ``n_slots``; ``caches`` (the pool)
    is updated in place for the lanes in ``write_rows`` (None: all).
    With ``page_size`` the caches are the paged pool's stores, read
    through ``page_table``.  Both the per-tick step and the fused loop
    call exactly this function.
    """

    def lanes(params, caches, toks, poss, write_rows=None, page_table=None):
        logits, _ = lm.forward_cached(params, toks[:, None], caches, poss,
                                      cfg, window=window,
                                      write_rows=write_rows,
                                      page_table=page_table,
                                      page_size=page_size)
        return torch.argmax(logits[:, 0], dim=-1)

    return lanes


def _fused_loop(lanes: Callable, max_depth: int) -> Callable:
    """The host loop over budgets shared by the contiguous and the paged
    fused steps; ``page_table`` is None for the contiguous pool."""

    def fused(params, caches, page_table, toks, poss, steps):
        n = toks.shape[0]
        dev = toks.device
        budget = [min(max(int(s), 0), max_depth) for s in steps]
        out_buf = torch.zeros((max_depth, n), dtype=torch.long, device=dev)
        trip = max(budget, default=0)
        prev: list[int] | None = None
        rows = mask = step = None
        for j in range(trip):
            act = [i for i, s in enumerate(budget) if s > j]
            if act != prev:
                # The active set shrinks at most n times per dispatch.
                prev = act
                rows = host_to_device(act, torch.long, dev)
                flags = [i in act for i in range(n)]
                mask = host_to_device(flags, torch.bool, dev)
                step = host_to_device(flags, torch.long, dev)
            next_toks = lanes(params, caches, toks, poss,
                              None if len(act) == n else rows, page_table)
            toks = next_toks if len(act) == n \
                else torch.where(mask, next_toks, toks)
            out_buf[j] = toks
            poss = poss + step
        return caches, out_buf, toks

    return fused


def make_fused_decode_step(cfg: ArchConfig, *, window: int | None = None,
                           max_depth: int = DEFAULT_MAX_DEPTH) -> Callable:
    """Build the fused decode step.

    ``fused(params, caches, toks, poss, steps)`` advances lane ``i`` by
    ``steps[i]`` greedy tokens (a host list, ``0 <= steps[i] <=
    max_depth``) and returns ``(caches, out_buf, final_toks)``:

    * ``caches``     — the pool, updated in place (the caller adopts it);
    * ``out_buf``    — ``(max_depth, n_slots)`` long on the device; row
      ``j`` holds lane ``i``'s ``j``-th token for ``j < steps[i]`` (rows
      past a lane's budget repeat its last token);
    * ``final_toks`` — each lane's last token, ready for the next dispatch.
    """
    loop = _fused_loop(make_lane_step(cfg, window=window),
                       max(int(max_depth), 1))

    def fused(params, caches, toks, poss, steps):
        return loop(params, caches, None, toks, poss, steps)

    return fused


def make_paged_decode_step(cfg: ArchConfig, *, page_size: int,
                           max_depth: int = DEFAULT_MAX_DEPTH) -> Callable:
    """The fused decode step over a paged pool.

    ``fused(params, caches, page_tables, toks, poss, steps)`` — the
    ``make_fused_decode_step`` contract with the page tables
    (``(n_slots, pages_per_slot)`` int32 on the device) riding in as
    data, fixed for the dispatch: the host resolves allocation and
    copy-on-write before it.  Each active lane writes its new K/V row at
    ``table[pos // ps] * ps + pos % ps``; inactive lanes write nothing."""
    return _fused_loop(make_lane_step(cfg, page_size=page_size),
                       max(int(max_depth), 1))


# ---------------------------------------------------------------------------
# self-speculative decoding (n-gram draft -> one batched verify -> rollback)
# ---------------------------------------------------------------------------

def _check_spec_arch(cfg: ArchConfig, window) -> None:
    """Speculation needs per-position rollback, which only pure
    full-attention stacks give for free: a rejected draft's KV entry
    sits past the accept point where the causal mask never reads it and
    the next verify window overwrites it.  A sliding-window ring write
    would clobber live entries, and a recurrent state absorbs the draft
    tokens with no way to unwind — both are hard errors."""
    kinds = set(cfg.layer_kinds())
    if not kinds <= {"attn", "shared_attn"}:
        raise ValueError(
            f"speculative decoding requires attention-only archs "
            f"(recurrent state cannot roll back); got {sorted(kinds)}")
    if window is not None:
        raise ValueError(
            "speculative decoding requires full attention (a ring-buffer "
            "window write would clobber live entries on rollback); got "
            f"window={window}")


def draft_from_history(hist: torch.Tensor, depth: int) -> torch.Tensor:
    """Prompt-lookup draft for one lane: ``depth - 1`` candidate tokens
    from the lane's recent token history (``hist``, oldest->newest,
    ``-1``-padded; the last entry is the lane's current carry token).

    The proposer finds the most recent earlier occurrence of the current
    bigram and proposes the tokens that followed it; no match proposes
    the carry token repeated.  A bad draft costs only verify width."""
    h = hist.shape[0]
    d = int(depth)
    j = torch.arange(1, h - 1, device=hist.device)
    hit = (hist[j - 1] == hist[h - 2]) & (hist[j] == hist[h - 1])
    best = torch.where(hit, j, torch.full_like(j, -1)).amax()
    lo = (best + 1).clamp(0, h - (d - 1))
    cont = hist[lo + torch.arange(d - 1, device=hist.device)]
    fallback = hist[h - 1].expand(d - 1)
    # -1 padding never matches a real token; the verify rejects it, but
    # it must not reach the embedding gather as a negative index.
    return torch.where(best >= 0, cont, fallback).clamp(min=0)


def _draft_batch(hist: torch.Tensor, depth: int) -> torch.Tensor:
    """``draft_from_history`` over all lanes at once: the no-match
    fallback (carry token repeated) folds into the gather indices, so the
    draft is one compare/reduce plus one gather."""
    h = hist.shape[1]
    d = int(depth)
    j = torch.arange(1, h - 1, device=hist.device)
    hit = (hist[:, :-2] == hist[:, h - 2:h - 1]) \
        & (hist[:, 1:-1] == hist[:, h - 1:h])
    best = torch.where(hit, j[None, :], -1).amax(dim=1)
    lo = (best + 1).clamp(0, h - (d - 1))
    k = torch.arange(d - 1, device=hist.device)[None, :]
    idx = torch.where(best[:, None] >= 0, lo[:, None] + k, h - 1)
    return torch.gather(hist, 1, idx).clamp(min=0)


def _spec_emit(drafts: torch.Tensor, verified: torch.Tensor,
               rem: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Accept/emit bookkeeping of one verify round: draft ``j`` is
    accepted iff every earlier draft matched (the longest matching
    prefix — exactly what sequential greedy decoding would produce).
    Each active lane emits ``accepted + 1`` tokens (the corrected token
    rides on every verify), clamped to its remaining budget.  Returns
    ``(n_emit, new_toks)``."""
    match = (drafts == verified[:, :-1]).long()
    accepted = torch.cumprod(match, dim=1).sum(dim=1)
    n_emit = torch.minimum(accepted + 1, rem)
    last = (n_emit - 1).clamp(min=0)
    new_toks = torch.gather(verified, 1, last[:, None])[:, 0]
    return n_emit, new_toks


def _shift_history(hist: torch.Tensor, verified: torch.Tensor,
                   n_emit: torch.Tensor) -> torch.Tensor:
    """Shift each lane's ``n_emit`` freshly emitted tokens into its
    history ring (oldest->newest); ``n_emit == 0`` leaves it as is."""
    full = torch.cat([hist, verified], dim=1)
    idx = n_emit[:, None] + torch.arange(hist.shape[1],
                                         device=hist.device)[None, :]
    return torch.gather(full, 1, idx)


def _spec_write_out(out_buf: torch.Tensor, verified: torch.Tensor,
                    cursor: torch.Tensor,
                    n_emit: torch.Tensor) -> torch.Tensor:
    """Write each lane's emitted tokens into its ``out_buf`` rows
    ``cursor .. cursor + n_emit - 1`` (rows the drain reads in order)."""
    d = verified.shape[1]
    r = torch.arange(out_buf.shape[0], device=out_buf.device)[:, None]
    idx = (r - cursor[None, :]).clamp(0, d - 1)
    gathered = torch.gather(verified.t(), 0, idx)
    mask = (r >= cursor[None, :]) & (r < (cursor + n_emit)[None, :])
    return torch.where(mask, gathered, out_buf)


def make_spec_lane_step(cfg: ArchConfig, *, window: int | None = None,
                        page_size: int | None = None) -> Callable:
    """The verify step over the pool: ``lanes(params, caches, seqs, poss,
    write_rows, keep, page_table) -> verified`` where ``seqs`` is
    ``(n_slots, d)`` — each lane's carry token followed by its ``d - 1``
    drafts — and ``verified`` ``(n_slots, d)`` the greedy argmax after
    every fed position.  It is the same ``lm.forward_cached`` the plain
    lane runs, fed a chunk."""
    _check_spec_arch(cfg, window)

    def lanes(params, caches, seqs, poss, write_rows=None, keep=None,
              page_table=None):
        logits, _ = lm.forward_cached(
            params, seqs, caches, poss, cfg, window=window,
            write_rows=write_rows, write_keep=keep, all_logits=True,
            page_table=page_table, page_size=page_size)
        return torch.argmax(logits, dim=-1)

    return lanes


def _spec_loop(lanes: Callable, depth: int, max_depth: int) -> Callable:
    """The speculative round loop shared by the contiguous and the paged
    steps (``page_table`` None for the contiguous pool)."""
    d = depth

    def fused(params, caches, page_table, hist, toks, poss, steps):
        n = toks.shape[0]
        dev = toks.device
        budget = [min(max(int(s), 0), max_depth) for s in steps]
        out_buf = torch.zeros((max_depth, n), dtype=torch.long, device=dev)
        rem0 = host_to_device(budget, torch.long, dev)
        rem = rem0
        lane_rounds = torch.zeros(n, dtype=torch.long, device=dev)
        writers = [i for i, s in enumerate(budget) if s > 0]
        rows = None if len(writers) == n \
            else host_to_device(writers, torch.long, dev)
        blind = -(-max(budget, default=0) // d)   # rounds surely needed
        reads = 0
        rnd = 0
        while writers:
            if rnd >= blind:
                reads += 1
                if to_host(rem.amax()).tolist() <= 0:
                    break
            active = rem > 0
            drafts = _draft_batch(hist, d)
            seqs = torch.cat([toks[:, None], drafts], dim=1)
            keep = active if rows is None else active[rows]
            verified = lanes(params, caches, seqs, poss, rows, keep,
                             page_table)
            n_emit, new_toks = _spec_emit(drafts, verified, rem)
            out_buf = _spec_write_out(out_buf, verified, rem0 - rem, n_emit)
            hist = _shift_history(hist, verified, n_emit)
            toks = torch.where(active, new_toks, toks)
            poss = poss + n_emit
            rem = rem - n_emit
            lane_rounds = lane_rounds + active.long()
            rnd += 1
        # A lane is active for a prefix of the rounds and emits >= 1 token
        # per active round: loop rounds = max lane rounds, verify events =
        # their sum, and every dispatched token is emitted by exit.
        stats = torch.stack([lane_rounds.amax(), lane_rounds.sum(),
                             rem0.sum()])
        return caches, hist, out_buf, toks, stats, reads

    return fused


def make_spec_decode_step(cfg: ArchConfig, *, depth: int,
                          window: int | None = None,
                          max_depth: int = DEFAULT_MAX_DEPTH) -> Callable:
    """Build the self-speculative fused decode step.

    ``fused(params, caches, hist, toks, poss, steps)`` — the
    ``make_fused_decode_step`` contract plus the per-lane token-history
    ring ``hist`` (``(n_slots, h)`` long, ``-1``-padded, last entry the
    carry token; ``DEFAULT_SPEC_HISTORY`` wide in the scheduler). Each
    round drafts ``depth - 1`` tokens per lane, verifies all ``depth``
    positions in one forward, accepts the longest matching prefix plus
    the corrected token and rolls each lane back to its accept point: a
    rejected draft's K/V sits past the lane's position, where the causal
    mask never reads it, and the next round's writes start there.
    Returns ``(caches, hist, out_buf, final_toks, stats, reads)``:
    ``stats`` is ``(3,)`` long on the device (loop rounds, per-lane
    verify events, tokens emitted) and ``reads`` the number of round-
    count reads the host made (see the module docstring).
    """
    d = max(int(depth), 2)
    loop = _spec_loop(make_spec_lane_step(cfg, window=window), d,
                      max(int(max_depth), 1))

    def fused(params, caches, hist, toks, poss, steps):
        return loop(params, caches, None, hist, toks, poss, steps)

    return fused


def make_paged_spec_decode_step(cfg: ArchConfig, *, depth: int,
                                page_size: int,
                                max_depth: int = DEFAULT_MAX_DEPTH
                                ) -> Callable:
    """The self-speculative step over a paged pool: ``fused(params,
    caches, page_tables, hist, toks, poss, steps)``.  Page-refcount
    safety is the caller's pre-dispatch contract: the scheduler's
    ``ensure_writable`` covers the whole speculative window ``[pos, pos
    + take + depth - 1)``, so a rejected draft only ever lands in a page
    this slot owns alone; a lane done inside the dispatch writes to the
    scratch page."""
    d = max(int(depth), 2)
    return _spec_loop(make_spec_lane_step(cfg, page_size=page_size), d,
                      max(int(max_depth), 1))
