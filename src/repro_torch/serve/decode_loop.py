"""Fused decode loop: ``k`` tokens per dispatch over the whole slot pool
(the counterpart of ``repro.serve.decode_loop``).

The JAX package compiles one ``lax.fori_loop`` whose trip count rides in
as data and vmaps a per-lane step over the pool.  Here the lane axis is
the batch dimension of one forward, and the loop body is a function of
static buffers (``graphs.StepState``): ``fused_body`` is the reference's
body — ``active = rem > 0``, the next token of every lane, writes kept
only for active lanes, ``toks = where(active, next, toks)``, ``out[j] =
toks``, ``poss += active``, ``rem -= active``, ``j += 1`` — and nothing
in it reads the card from the host or takes a shape from the host's
active list.  A ``graphs.StepRunner`` copies a dispatch's inputs in and
runs the body ``max(steps)`` times: eagerly on the CPU, and on the card
as replays of one captured CUDA graph, so the host makes one graph
launch per step.  The emitted tokens come back in one copy per dispatch
when the scheduler drains it.

Inactive lanes compute like the reference's, and their K/V writes are
dropped where they land (``lm.forward_cached``'s ``write_keep``): the
contiguous pool reads the old rows back and writes them unchanged, the
paged pool sends them to the scratch page 0.  A recurrent layer's state
(both pools hold it as slot rows) is written whole, in place, as
``where(keep, new, old)``: a spent lane's state comes out exactly as it
went in.  ``masked_merge`` is the reference's merge, which those writes
agree with.

Over the paged pool (``make_paged_decode_step``) the loop is the same;
the page table rides in as data, fixed for the dispatch (the host
resolves allocation and copy-on-write before it), and every attention
reads the pages through the paged kernel (under the "head_dim" split
over 'model', through the table in plain ops:
``attention._paged_head_dim_attention``).

Every factory takes ``kernel_tuner`` (an ``autotune.KernelTuner``, the
reference's measured kernel blocks; None: the one ``models.flags``
holds): each dispatch runs under ``models.flags.kernel_tuner``, so kernel
1's warps and kernels 2 and 3's attention plans are measured ones,
resolved on the dispatch's own lanes in the eager step before a graph's
capture (``graphs.StepRunner``).

Self-speculative decoding (``make_spec_decode_step`` and its paged twin)
drafts ``d - 1`` tokens per lane from the lane's own token history
(prompt lookup), verifies all ``d`` positions in one forward, accepts
the longest matching prefix plus the corrected token and rolls the lane
back to its accept point: the emitted tokens are greedy decoding's.  How
many rounds a dispatch needs depends on acceptance, which only the card
knows.  The first ``ceil(max_take / d)`` rounds are always needed (a
round emits at most ``d`` tokens per lane) and run without a read; after
them the host reads ``max(rem)`` back once per round (``to_host``, a
counted round trip) and stops at 0.  Each round is one replay of the
graph captured for its width.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core import strict
from ..models import flags, lm
from .graphs import DecodeGraphs, StepRunner

# One fused step serves every depth up to this; the scheduler clamps
# adaptive depth decisions against it.
DEFAULT_MAX_DEPTH = 32

# Self-speculative decoding: the history ring is the draft proposer's
# only state; the candidate depths are the widths the
# ``serve_spec_depth`` decision picks between.
DEFAULT_SPEC_HISTORY = 64
SPEC_DEPTH_CANDIDATES = (1, 2, 4, 8)
# Every query length a decode graph attends with: the plain step and each
# verify width (``DecodeGraphs`` reserves scratch for the largest).
STEP_WIDTHS = (1,) + tuple(w for w in SPEC_DEPTH_CANDIDATES if w >= 2)


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


def _host_copy(caches: list, host: list) -> None:
    """A deliberate device-to-host copy of one cache row (the first
    store's row 0) into a pinned buffer (``host``, made at the first
    call, which is the eager step before a capture), for the launch
    audit's gate self-test (``analysis/launch_audit.py``); the scheduler
    never makes it.  Asynchronous, so a graph captures it as a copy
    node."""
    row = next(t for c in caches for t in c.values() if t is not None)[0]
    if not host or host[0].shape != row.shape or host[0].dtype != row.dtype:
        host[:] = [torch.empty(row.shape, dtype=row.dtype,
                               pin_memory=row.device.type == "cuda")]
    host[0].copy_(row, non_blocking=True)


def make_lane_step(cfg: ArchConfig, *, window: int | None = None,
                   page_size: int | None = None,
                   kernel_tuner=None) -> Callable:
    """The decode step over the slot pool.

    ``lanes(params, caches, toks, poss, page_table, keep) -> next_toks``:
    every leading dim is ``n_slots``; ``caches`` (the pool) is updated in
    place for the lanes whose ``keep`` flag (on the device; None: all) is
    set.  With ``page_size`` the caches are the paged pool's stores, read
    through ``page_table``.  Every decode step body calls exactly this
    function.  The forward runs under ``kernel_tuner`` (or the one
    ``models.flags`` holds).
    """

    def lanes(params, caches, toks, poss, page_table=None, keep=None):
        with flags.kernel_tuner(kernel_tuner or flags.KERNEL_TUNER):
            logits, _ = lm.forward_cached(params, toks[:, None], caches,
                                          poss, cfg, window=window,
                                          write_keep=keep,
                                          page_table=page_table,
                                          page_size=page_size)
        return torch.argmax(logits[:, 0], dim=-1)

    return lanes


def make_paged_lane_step(cfg: ArchConfig, *, page_size: int, max_len: int,
                         kernel_tuner=None) -> Callable:
    """The reference's name and keywords for the paged decode lane:
    ``make_lane_step(cfg, page_size=page_size)``.  ``max_len`` is taken
    and unused: the reference gathers each lane's pages into a
    ``max_len`` view, the port reads them through the table in the
    paged kernel.  The lanes are the port's own, ``lanes(params, caches,
    toks, poss, page_table, keep)``, updating the caches in place
    (ROADMAP.md, Divergences)."""
    return make_lane_step(cfg, page_size=page_size,
                          kernel_tuner=kernel_tuner)


def masked_merge(caches: list, new_caches: list,
                 active: torch.Tensor) -> list:
    """Keep ``new`` rows only for active lanes (the reference's merge):
    per layer and store, ``where(active, new, old)`` over the lane axis.
    The step bodies never call it — they drop inactive lanes' writes
    where they land (``write_keep``) — but it is the function those
    writes must agree with."""

    def keep(old, new):
        if old is None:
            return None
        return torch.where(active.reshape((-1,) + (1,) * (old.dim() - 1)),
                           new, old)

    return [{name: keep(c[name], nc[name]) for name in c}
            for c, nc in zip(caches, new_caches, strict=True)]


def _budgets(steps, max_depth: int) -> list[int]:
    return [min(max(int(s), 0), max_depth) for s in steps]


def fused_body(lanes: Callable, inject_host_copy: bool = False) -> Callable:
    """One decode step over a ``StepState`` (the reference's loop body):
    every lane runs, ``keep`` drops the writes of lanes whose budget is
    spent, and only active lanes take their next token and advance.
    ``inject_host_copy`` adds ``_host_copy`` after the forward."""
    host: list = []

    def body(params, caches, st):
        active = st.rem > 0
        nxt = lanes(params, caches, st.toks, st.poss, page_table=st.table,
                    keep=active)
        if inject_host_copy:
            _host_copy(caches, host)
        st.toks.copy_(torch.where(active, nxt, st.toks))
        st.out.index_copy_(0, st.j, st.toks[None])
        step = active.long()
        st.poss.add_(step)
        st.rem.sub_(step)
        st.j.add_(1)

    return body


def _fused_loop(cfg: ArchConfig, lanes: Callable, max_depth: int,
                graphs: DecodeGraphs | None, page_size: int | None,
                kernel_tuner=None,
                inject_host_copy: bool = False) -> Callable:
    """The dispatch shared by the contiguous and the paged fused steps
    (``page_table`` None for the contiguous pool): the inputs copied into
    the runner's state, ``max(steps)`` steps, the outputs copied out (a
    later dispatch reuses the state while this one's are still read)."""
    max_depth = max(int(max_depth), 1)
    runner = StepRunner(graphs or DecodeGraphs(), "fused",
                        fused_body(lanes, inject_host_copy), length=1,
                        heads=(cfg.n_heads, cfg.n_kv_heads),
                        widths=STEP_WIDTHS, page_size=page_size)

    def fused(params, caches, page_table, toks, poss, steps):
        budget = _budgets(steps, max_depth)
        with flags.kernel_tuner(kernel_tuner or flags.KERNEL_TUNER):
            st = runner.load(params, caches, toks, poss, budget, max_depth,
                             table=page_table)
            for _ in range(max(budget, default=0)):
                runner.step()
        return caches, st.out.clone(), st.toks.clone()

    fused.runner = runner
    return fused


def make_fused_decode_step(cfg: ArchConfig, *, window: int | None = None,
                           kernel_tuner=None,
                           max_depth: int = DEFAULT_MAX_DEPTH,
                           graphs: DecodeGraphs | None = None,
                           _inject_host_copy: bool = False) -> Callable:
    """Build the fused decode step.

    ``fused(params, caches, toks, poss, steps)`` advances lane ``i`` by
    ``steps[i]`` greedy tokens (a host list, ``0 <= steps[i] <=
    max_depth``) and returns ``(caches, out_buf, final_toks)``:

    * ``caches``     — the pool, updated in place (the caller adopts it);
    * ``out_buf``    — ``(max_depth, n_slots)`` long on the device; row
      ``j`` holds lane ``i``'s ``j``-th token for ``j < steps[i]`` (rows
      past a lane's budget repeat its last token, rows past the deepest
      budget are 0);
    * ``final_toks`` — each lane's last token, ready for the next dispatch.

    On the card each step is one replay of a captured graph
    (``serve/graphs.py``); ``graphs`` shares a memory pool and the
    attention scratch between steps (the scheduler passes one for all of
    its own).  ``kernel_tuner``: the measured kernel plans the step's
    forward takes.  ``_inject_host_copy`` (the launch audit's gate
    self-test only) adds a device-to-host copy of a cache row to the
    body, as the reference's ``_inject_reshard`` adds a reshard; the
    scheduler never sets it.
    """
    loop = _fused_loop(cfg, make_lane_step(cfg, window=window,
                                           kernel_tuner=kernel_tuner),
                       max_depth, graphs, None, kernel_tuner,
                       _inject_host_copy)

    def fused(params, caches, toks, poss, steps):
        return loop(params, caches, None, toks, poss, steps)

    fused.runner = loop.runner
    return fused


def make_paged_decode_step(cfg: ArchConfig, *, page_size: int,
                           kernel_tuner=None,
                           max_depth: int = DEFAULT_MAX_DEPTH,
                           graphs: DecodeGraphs | None = None,
                           _inject_host_copy: bool = False) -> Callable:
    """The fused decode step over a paged pool.

    ``fused(params, caches, page_tables, toks, poss, steps)`` — the
    ``make_fused_decode_step`` contract with the page tables
    (``(n_slots, pages_per_slot)`` int32 on the device) riding in as
    data, fixed for the dispatch: the host resolves allocation and
    copy-on-write before it.  Each active lane writes its new K/V row at
    ``table[pos // ps] * ps + pos % ps``; an inactive lane's row goes to
    the scratch page 0.  ``kernel_tuner`` and ``_inject_host_copy`` as
    for ``make_fused_decode_step``."""
    return _fused_loop(cfg, make_lane_step(cfg, page_size=page_size,
                                           kernel_tuner=kernel_tuner),
                       max_depth, graphs, page_size, kernel_tuner,
                       _inject_host_copy)


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


def make_spec_lane_step(cfg: ArchConfig, *, depth: int | None = None,
                        window: int | None = None,
                        page_size: int | None = None,
                        kernel_tuner=None) -> Callable:
    """The verify step over the pool: ``lanes(params, caches, seqs, poss,
    page_table, keep) -> verified`` where ``seqs`` is
    ``(n_slots, d)`` — each lane's carry token followed by its ``d - 1``
    drafts — and ``verified`` ``(n_slots, d)`` the greedy argmax after
    every fed position.  It is the same ``lm.forward_cached`` the plain
    lane runs, fed a chunk.  With ``depth`` (the reference's keyword)
    the lanes refuse ``seqs`` of another width; without it they take the
    width of ``seqs``.  ``kernel_tuner`` as in ``make_lane_step``."""
    _check_spec_arch(cfg, window)

    def lanes(params, caches, seqs, poss, page_table=None, keep=None):
        if depth is not None and seqs.shape[1] != depth:
            raise ValueError(f"verify lanes built for depth {depth} fed "
                             f"{seqs.shape[1]} positions")
        with flags.kernel_tuner(kernel_tuner or flags.KERNEL_TUNER):
            logits, _ = lm.forward_cached(
                params, seqs, caches, poss, cfg, window=window,
                write_keep=keep, all_logits=True, page_table=page_table,
                page_size=page_size)
        return torch.argmax(logits, dim=-1)

    return lanes


def make_paged_spec_lane_step(cfg: ArchConfig, *, depth: int,
                              page_size: int, max_len: int,
                              kernel_tuner=None) -> Callable:
    """The reference's name and keywords for the paged verify lane:
    ``make_spec_lane_step(cfg, depth=depth, page_size=page_size)``
    (``max_len`` taken and unused, as in ``make_paged_lane_step``)."""
    return make_spec_lane_step(cfg, depth=max(int(depth), 2),
                               page_size=page_size,
                               kernel_tuner=kernel_tuner)


def spec_body(lanes: Callable, depth: int) -> Callable:
    """One speculative round over a ``StepState`` (the reference's
    ``while_loop`` body): draft, verify all ``depth`` positions of every
    lane in one forward (``keep`` drops the writes of lanes whose budget
    is spent), accept, emit into ``out`` at each lane's cursor, shift the
    history and advance."""
    d = depth

    def body(params, caches, st):
        active = st.rem > 0
        drafts = _draft_batch(st.hist, d)
        seqs = torch.cat([st.toks[:, None], drafts], dim=1)
        verified = lanes(params, caches, seqs, st.poss, page_table=st.table,
                         keep=active)
        n_emit, new_toks = _spec_emit(drafts, verified, st.rem)
        st.out.copy_(_spec_write_out(st.out, verified, st.rem0 - st.rem,
                                     n_emit))
        st.hist.copy_(_shift_history(st.hist, verified, n_emit))
        st.toks.copy_(torch.where(active, new_toks, st.toks))
        st.poss.add_(n_emit)
        st.rem.sub_(n_emit)
        st.rounds.add_(active.long())

    return body


def _spec_loop(cfg: ArchConfig, lanes: Callable, depth: int, max_depth: int,
               graphs: DecodeGraphs | None, page_size: int | None,
               kernel_tuner=None) -> Callable:
    """The speculative dispatch shared by the contiguous and the paged
    steps (``page_table`` None for the contiguous pool)."""
    d = depth
    max_depth = max(int(max_depth), 1)
    runner = StepRunner(graphs or DecodeGraphs(), f"spec{d}",
                        spec_body(lanes, d), length=d,
                        heads=(cfg.n_heads, cfg.n_kv_heads),
                        widths=STEP_WIDTHS, page_size=page_size)

    def fused(params, caches, page_table, hist, toks, poss, steps):
        budget = _budgets(steps, max_depth)
        blind = -(-max(budget, default=0) // d)   # rounds surely needed
        reads = 0
        rnd = 0
        with flags.kernel_tuner(kernel_tuner or flags.KERNEL_TUNER):
            st = runner.load(params, caches, toks, poss, budget, max_depth,
                             table=page_table, hist=hist)
            while any(budget):
                if rnd >= blind:
                    reads += 1
                    if to_host(st.rem.amax()).tolist() <= 0:
                        break
                runner.step()
                rnd += 1
        # A lane is active for a prefix of the rounds and emits >= 1 token
        # per active round: loop rounds = max lane rounds, verify events =
        # their sum, and every dispatched token is emitted by exit.
        stats = torch.stack([st.rounds.amax(), st.rounds.sum(),
                             st.rem0.sum()])
        return (caches, st.hist.clone(), st.out.clone(), st.toks.clone(),
                stats, reads)

    fused.runner = runner
    return fused


def make_spec_decode_step(cfg: ArchConfig, *, depth: int,
                          window: int | None = None, kernel_tuner=None,
                          max_depth: int = DEFAULT_MAX_DEPTH,
                          graphs: DecodeGraphs | None = None) -> Callable:
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
    count reads the host made (see the module docstring).  On the card
    each round is one replay of a graph captured per width.
    ``kernel_tuner``: the measured kernel plans the verify forward takes.
    """
    d = max(int(depth), 2)
    loop = _spec_loop(cfg, make_spec_lane_step(cfg, depth=d, window=window,
                                               kernel_tuner=kernel_tuner),
                      d, max_depth, graphs, None, kernel_tuner)

    def fused(params, caches, hist, toks, poss, steps):
        return loop(params, caches, None, hist, toks, poss, steps)

    fused.runner = loop.runner
    return fused


def make_paged_spec_decode_step(cfg: ArchConfig, *, depth: int,
                                page_size: int, kernel_tuner=None,
                                max_depth: int = DEFAULT_MAX_DEPTH,
                                graphs: DecodeGraphs | None = None
                                ) -> Callable:
    """The self-speculative step over a paged pool: ``fused(params,
    caches, page_tables, hist, toks, poss, steps)``.  Page-refcount
    safety is the caller's pre-dispatch contract: the scheduler's
    ``ensure_writable`` covers the whole speculative window ``[pos, pos
    + take + depth - 1)``, so a rejected draft only ever lands in a page
    this slot owns alone; a lane whose budget is spent writes to the
    scratch page."""
    d = max(int(depth), 2)
    return _spec_loop(cfg, make_paged_spec_lane_step(
        cfg, depth=d, page_size=page_size, max_len=0,
        kernel_tuner=kernel_tuner), d, max_depth, graphs, page_size,
        kernel_tuner)
