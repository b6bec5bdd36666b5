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


def make_lane_step(cfg: ArchConfig, *, window: int | None = None) -> Callable:
    """The decode step over the slot pool.

    ``lanes(params, caches, toks, poss, write_rows) -> next_toks``: every
    leading dim is ``n_slots``; ``caches`` (the pool) is updated in place
    for the lanes in ``write_rows`` (None: all).  Both the per-tick step
    and the fused loop call exactly this function.
    """

    def lanes(params, caches, toks, poss, write_rows=None):
        logits, _ = lm.forward_cached(params, toks[:, None], caches, poss,
                                      cfg, window=window,
                                      write_rows=write_rows)
        return torch.argmax(logits[:, 0], dim=-1)

    return lanes


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
    lanes = make_lane_step(cfg, window=window)
    max_depth = max(int(max_depth), 1)

    def fused(params, caches, toks, poss, steps):
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
                              None if len(act) == n else rows)
            toks = next_toks if len(act) == n \
                else torch.where(mask, next_toks, toks)
            out_buf[j] = toks
            poss = poss + step
        return caches, out_buf, toks

    return fused
