"""Fault tolerance: a checkpoint/restart training loop (the counterpart
of ``repro.runtime.ft``).

``FaultTolerantTrainer`` wraps any (params, opt_state, batch) → ... step:
periodic async checkpoints, restart from the latest on failure, bounded
retries.  Failures are injected through ``failure_hook`` (the tests and
``chip_smoke.py`` raise ``SimulatedFailure``); on a real cluster the same
hook is where the coordinator's health signal lands.  Each step runs
under ``strict.hot_dispatch_guard``: under strict mode an implicit
device→host synchronisation inside the step raises; the metrics are read
after it.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Iterator

from ..checkpoint import checkpointer
from ..core import strict

log = logging.getLogger("repro_torch.ft")


class SimulatedFailure(RuntimeError):
    """Injected node/step failure (tests)."""


@dataclasses.dataclass
class FaultTolerantTrainer:
    train_step: Callable
    ckpt_dir: str
    save_every: int = 50
    keep: int = 3
    max_restarts: int = 5
    failure_hook: Callable[[int], None] | None = None

    def run(self, params: Any, opt_state: Any, data: Iterator,
            num_steps: int, *, start_step: int = 0) -> tuple[Any, Any, list]:
        saver = checkpointer.AsyncCheckpointer(self.ckpt_dir, keep=self.keep)
        metrics_log: list = []
        restarts = 0
        step = start_step

        # resume if a checkpoint exists
        path = checkpointer.latest(self.ckpt_dir)
        if path is not None:
            (params, opt_state), step = checkpointer.restore(
                path, (params, opt_state))
            log.info("resumed from %s at step %d", path, step)

        while step < num_steps:
            batch = next(data)
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)
                with strict.hot_dispatch_guard():
                    params, opt_state, metrics = self.train_step(
                        params, opt_state, batch)
            except SimulatedFailure:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                saver.wait()
                path = checkpointer.latest(self.ckpt_dir)
                if path is None:
                    log.warning("failure before first checkpoint; "
                                "restarting from step 0 state")
                    continue
                (params, opt_state), step = checkpointer.restore(
                    path, (params, opt_state))
                log.warning("restart %d from %s at step %d",
                            restarts, path, step)
                continue
            step += 1
            metrics_log.append({k: float(v) for k, v in metrics.items()})
            if step % self.save_every == 0:
                saver.save_async(step, (params, opt_state))
        saver.wait()
        checkpointer.save(self.ckpt_dir, step, (params, opt_state),
                          keep=self.keep)
        return params, opt_state, metrics_log
