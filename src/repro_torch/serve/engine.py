"""Serving engine: a thin facade over the continuous-batching scheduler
(the counterpart of ``repro.serve.engine``).

``generate`` submits one request per prompt row to a ``ServeScheduler``
and returns the greedy tokens.  The stateful lock-step batch surface
(``prefill`` / ``decode`` / ``pos`` / ``caches``) is there for callers
that drive one batch themselves; ``generate`` takes it once the engine
holds cache state (``pos != 0``), for a cross-attention arch (the
scheduler does not serve one) and whenever ``frontend_feats`` are
given, as the reference does.  The features (B, T, d) go to every
forward of the batch, where the ``cross_attn`` layers attend them.
``make_decode_step`` is that path's pure step, and ``make_prefill_step``
the one-shot prefill over the full-sequence ``lm.forward``.  A
``kernel_tuner`` (the measured kernel plans) applies around every
forward of both paths, as the reference applies it around its traces.

On a mesh (``mesh``) the lock-step batch runs on this rank's
tensor-parallel blocks (every block kind, by the plan) and every data
replica runs the whole batch, except that a batch that does not split
over 'data' puts the caches' sequence there, as the reference's
``cache_specs`` do (``cache_seq_model``: on 'model'); such a cache is
prefilled one row a step (``models/attention.py``).  The attention
blocks follow the serving plan's rule (``sharding.tp_plan``, cached;
``force_attn`` names one for tests).
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from ..configs.base import ArchConfig
from ..core.acc import AdaptiveCoreChunk
from ..core.executor import SequentialExecutor
from ..core.future import Future
from ..core.properties import params_of
from ..device import resolve_device
from ..models import flags, lm
from .decode_loop import to_host
from .scheduler import ServeScheduler


def prefill_segments(s: int, chunk: int, *, pos: int = 0,
                     window: int | None = None) -> list[tuple[int, int]]:
    """(start, step) prefill pieces for ``s`` new tokens; ring-buffer
    (SWA) writes never cross a window boundary.  The segments tile
    [0, s) exactly."""
    if s < 0:
        raise ValueError(f"negative token count: {s}")
    window = None if window is None or window <= 0 else window
    chunk = max(int(chunk), 1)
    segs: list[tuple[int, int]] = []
    start = 0
    while start < s:
        step = min(chunk, s - start)
        if window is not None:
            step = min(step, window - pos % window)
        segs.append((start, step))
        pos += step
        start += step
    return segs


def _contexts(tp, seq) -> contextlib.ExitStack:
    """The mesh contexts a step runs under: ``tp`` (a
    ``flags.TensorParallel``) and ``seq`` (a ``flags.SeqSplit``) where
    given; what the caller's context holds where None."""
    stack = contextlib.ExitStack()
    if tp is not None:
        stack.enter_context(flags.tensor_parallel(tp))
    if seq is not None:
        stack.enter_context(flags.cache_seq(seq))
    return stack


def make_decode_step(cfg: ArchConfig, *, window: int | None = None,
                     kernel_tuner=None, tp=None, seq=None) -> Callable:
    """``(params, caches, tokens (B, L), pos, frontend_feats=None) ->
    (logits (B, 1, V), caches)``: one cached forward at position ``pos``
    (an int), the caches updated in place, under ``kernel_tuner`` (or
    the one ``models.flags`` holds).  A mesh rank's step: ``tp`` and
    ``seq`` (``_contexts``), the params its blocks and the caches its
    local layout (``lm.init_caches(..., tp=..., seq_blocks=...)``); a
    cache with its sequence on a mesh axis takes one row a step."""

    def decode_step(params, caches, tokens, pos, frontend_feats=None):
        with flags.kernel_tuner(kernel_tuner or flags.KERNEL_TUNER), \
                _contexts(tp, seq):
            return lm.forward_cached(params, tokens, caches, pos, cfg,
                                     window=window,
                                     frontend_feats=frontend_feats)

    return decode_step


def make_prefill_step(cfg: ArchConfig, *, window: int | None = None,
                      attn_impl: str = "chunked", tp=None) -> Callable:
    """One-shot prefill: ``(params, batch {"tokens": (B, S)}) -> logits
    (B, 1, V)`` of the last position, from the full-sequence forward (no
    cache is written).  ``attn_impl="flash"`` runs kernel 2 on the card;
    call it under ``torch.no_grad()`` when the parameters require grad.
    ``tp``: a mesh rank's tensor-parallel context, its params its
    blocks."""

    def prefill_step(params, batch):
        with _contexts(tp, None):
            logits, _ = lm.forward(params, batch, cfg, window=window,
                                   attn_impl=attn_impl)
        return logits[:, -1:]

    return prefill_step


def _seq_split(cfg: ArchConfig, mesh, batch: int, rows: int,
               cache_seq_model: bool) -> tuple[str | None,
                                               flags.SeqSplit | None]:
    """(axis, split): the mesh axis the lock-step caches of ``rows`` rows
    hold their sequence on, as ``cache_specs`` names it (on 'data' when
    the batch does not split over it, on 'model' with
    ``cache_seq_model``), and its ``flags.SeqSplit``; (None, None) where
    they keep it whole or off a mesh."""
    if mesh is None:
        return None, None
    from ..launch import sharding

    axis = sharding.cache_seq_axis(cfg, mesh, batch, rows,
                                   seq_over_model=cache_seq_model)
    return axis, None if axis is None else flags.SeqSplit(
        mesh.groups[axis], mesh.shape[axis], mesh.coord(axis))


class ServeEngine:
    """Stateful wrapper: greedy generation through the scheduler, or a
    lock-step batch the caller drives (``prefill`` / ``decode``)."""

    def __init__(self, cfg: ArchConfig, params, *, batch: int, max_len: int,
                 window: int | None = None,
                 acc: AdaptiveCoreChunk | None = None,
                 executor=None, kernel_tuner=None,
                 dispatch_depth: int | str | None = None,
                 mesh=None, cache_seq_model: bool = False,
                 device: str | torch.device = "cuda",
                 force_attn: str | None = None):
        self.cfg = cfg
        self.force_attn = force_attn
        self.params = params
        self.window = window if window is not None else cfg.attn_window
        self.max_len = max_len
        self.batch = batch
        self.device = resolve_device(device)
        self.executor = executor if executor is not None \
            else SequentialExecutor()
        self.acc = acc or params_of(self.executor) or AdaptiveCoreChunk()
        self.dispatch_depth = dispatch_depth
        self.mesh = mesh
        self.kernel_tuner = kernel_tuner
        self._caches = None   # lazy: the scheduled path never builds it
        self.pos = 0
        self._seq_axis, self.seq = _seq_split(
            cfg, mesh, batch, min(self.window, max_len) if self.window
            else max_len, cache_seq_model)
        self._lock = None   # lazy: (params, tp, decode step), lock-step path
        self._sched = None   # lazily built, reused across generate() calls

    def _lockstep(self) -> tuple:
        """(params, tensor-parallel context, decode step) of the lock-step
        batch, built on its first use.  Off a mesh: the params, None and
        the plain step.  On one: this rank's tensor-parallel blocks
        (``serve_param_specs``), every data replica running the whole
        batch; with the caches' sequence on 'model' (``self.seq``) the
        attention runs whole."""
        if self._lock is None:
            params, tp = self.params, None
            if self.mesh is not None:
                from ..launch import sharding

                whole = self._seq_axis == "model"
                params = sharding.local_tree(
                    self.params, sharding.serve_param_specs(
                        self.cfg, self.params, self.mesh,
                        seq_over_model=whole, force_attn=self.force_attn),
                    self.mesh)
                tp = sharding.tensor_parallel(
                    self.cfg, self.mesh, seq_over_model=whole, cached=True,
                    force_attn=self.force_attn)
            self._lock = (params, tp, make_decode_step(
                self.cfg, window=self.window, kernel_tuner=self.kernel_tuner,
                tp=tp, seq=self.seq))
        return self._lock

    @property
    def caches(self) -> list:
        if self._caches is None:
            _, tp, _ = self._lockstep()
            self._caches = lm.init_caches(
                self.cfg, self.batch, self.max_len, window=self.window,
                device=self.device, tp=tp,
                seq_blocks=1 if self.seq is None else self.seq.size)
        return self._caches

    @caches.setter
    def caches(self, value: list) -> None:
        self._caches = value

    def _feats(self, frontend_feats) -> torch.Tensor | None:
        if frontend_feats is None:
            return None
        return torch.as_tensor(frontend_feats).to(
            self.device, lm.compute_dtype(self.cfg))

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens).to(self.device, torch.long)

    def prefill(self, tokens, frontend_feats=None,
                chunk: int | None = None) -> torch.Tensor:
        """Chunked prefill of ``tokens`` (B, S) at the engine's position;
        the chunk from the acc model unless given.  The chunks' forwards
        chain through the executor (``then_execute``): each consumes the
        previous one's (logits, caches, position), joined at the end.
        Returns the last chunk's logits (B, 1, V)."""
        feats = self._feats(frontend_feats)
        tokens = self._tokens(tokens)
        s = tokens.shape[1]
        params, _, decode = self._lockstep()
        if self.seq is not None:
            chunk = 1       # a sequence-split cache takes one row a step
        if chunk is None:
            from ..train.autotune import token_profile

            def decide():
                return self.acc.decide_for_profile(
                    self.executor, token_profile(self.cfg, training=False),
                    s).chunk_elems

            # On a mesh every rank must run the same chunks: mesh rank 0
            # decides (a decision may read timings, which differ).
            chunk = max(min(decide() if self.mesh is None
                            else self.mesh.agree(decide), s), 1)

        def step_for(start: int, step: int):
            piece = tokens[:, start:start + step]

            def run(state):
                _, caches, pos = state
                logits, caches = decode(params, caches, piece, pos, feats)
                return logits, caches, pos + step

            return run

        state = Future.ready((None, self.caches, self.pos))
        for start, step in prefill_segments(s, chunk, pos=self.pos,
                                            window=self.window):
            state = self.executor.then_execute(step_for(start, step), state)
        logits, self.caches, self.pos = state.result()
        return logits

    def decode(self, tokens, frontend_feats=None) -> torch.Tensor:
        """One forward of ``tokens`` (B, L) at the engine's position;
        returns its last logits (B, 1, V)."""
        tokens = self._tokens(tokens)
        params, _, decode = self._lockstep()
        logits, self.caches = decode(params, self.caches, tokens, self.pos,
                                     self._feats(frontend_feats))
        self.pos += tokens.shape[1]
        return logits

    def generate(self, prompt, n_new: int,
                 frontend_feats=None) -> torch.Tensor:
        """Greedy generation; ``prompt`` (B, S); returns (B, n_new) long
        token ids on the host.  Through the scheduler (one request per
        row) while the engine holds no cache state, the arch has no
        ``cross_attn`` layer, no features are given and the caches keep
        their sequence whole; else the lock-step batch loop, as in the
        reference."""
        if frontend_feats is None and self.pos == 0 \
                and "cross_attn" not in self.cfg.layer_kinds() \
                and self.seq is None:
            return self._generate_scheduled(prompt, n_new)
        return self._generate_lockstep(prompt, n_new, frontend_feats)

    def _generate_scheduled(self, prompt, n_new: int) -> torch.Tensor:
        prompt = torch.as_tensor(prompt).to("cpu", torch.long)
        bsz = prompt.shape[0]
        if self._sched is None or self._sched.pool.n_slots < bsz:
            self._sched = ServeScheduler(
                self.cfg, self.params, n_slots=bsz, max_len=self.max_len,
                window=self.window, executor=self.executor, acc=self.acc,
                kernel_tuner=self.kernel_tuner,
                dispatch_depth=self.dispatch_depth, mesh=self.mesh,
                device=self.device, force_attn=self.force_attn)
        rids = [self._sched.submit(prompt[i], max_new_tokens=n_new)
                for i in range(bsz)]
        outs = self._sched.run_until_idle()
        tokens = torch.tensor([outs[rid] for rid in rids], dtype=torch.long)
        self._sched.clear_finished()
        return tokens

    def _generate_lockstep(self, prompt, n_new: int,
                           frontend_feats=None) -> torch.Tensor:
        """Prefill the prompt after the engine's state, then ``n_new``
        greedy steps of the whole batch; one token read at the end."""
        feats = self._feats(frontend_feats)
        logits = self.prefill(prompt, feats)
        out = []
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        for _ in range(n_new):
            out.append(tok)
            logits = self.decode(tok, feats)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return torch.from_numpy(to_host(torch.cat(out, dim=1)))
