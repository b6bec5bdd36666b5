"""Serving engine: a thin facade over the continuous-batching scheduler
(the counterpart of ``repro.serve.engine.ServeEngine``'s scheduled path).

``generate`` submits one request per prompt row to a ``ServeScheduler``
and returns the greedy tokens.  The lock-step batch path of the JAX
engine (``prefill`` / ``decode`` / ``_generate_legacy``, the route of the
cross-attention archs) is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core.acc import AdaptiveCoreChunk
from ..core.executor import SequentialExecutor
from ..core.properties import params_of
from ..device import resolve_device


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


class ServeEngine:
    """Stateful wrapper: greedy generation through the scheduler."""

    def __init__(self, cfg: ArchConfig, params, *, batch: int, max_len: int,
                 window: int | None = None,
                 acc: AdaptiveCoreChunk | None = None,
                 executor=None, kernel_tuner=None,
                 dispatch_depth: int | str | None = None,
                 mesh=None, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.params = params
        self.window = window if window is not None else cfg.attn_window
        self.max_len = max_len
        self.batch = batch
        self.device = resolve_device(device)
        self.executor = executor if executor is not None \
            else SequentialExecutor()
        self.acc = acc or params_of(self.executor) or AdaptiveCoreChunk()
        self.kernel_tuner = kernel_tuner
        self.dispatch_depth = dispatch_depth
        self.mesh = mesh
        self._sched = None   # lazily built, reused across generate() calls

    def generate(self, prompt, n_new: int) -> torch.Tensor:
        """Greedy generation; ``prompt`` (B, S) on the host; returns
        (B, n_new) long token ids on the host."""
        from .scheduler import ServeScheduler

        if "cross_attn" in self.cfg.layer_kinds():
            raise NotImplementedError(
                "the lock-step batch path for cross-attention archs is not "
                "ported yet (ROADMAP.md, remaining architectures)")
        prompt = torch.as_tensor(prompt).to("cpu", torch.long)
        bsz = prompt.shape[0]
        if self._sched is None or self._sched.pool.n_slots < bsz:
            self._sched = ServeScheduler(
                self.cfg, self.params, n_slots=bsz, max_len=self.max_len,
                window=self.window, executor=self.executor, acc=self.acc,
                kernel_tuner=self.kernel_tuner,
                dispatch_depth=self.dispatch_depth, mesh=self.mesh,
                device=self.device)
        rids = [self._sched.submit(prompt[i], max_new_tokens=n_new)
                for i in range(bsz)]
        outs = self._sched.run_until_idle()
        tokens = torch.tensor([outs[rid] for rid in rids], dtype=torch.long)
        self._sched.clear_finished()
        return tokens
