"""Model-layer flags (the counterpart of ``repro.models.flags``): the
measured kernel tuner and the tensor-parallel context.

``KERNEL_TUNER`` is an ``autotune.KernelTuner`` or None.  When set, the
model layers resolve kernel 1's warps per block and kernels 2 and 3's
attention plans through it (``models/common.py``, ``models/attention.py``)
and pass them down; when None they pass nothing and the analytic plans
hold.  The serve path sets it around each forward (``kernel_tuner``),
the train launcher for the run (``--kernel-autotune``), as the reference
sets it around its traces.

``TP`` is a ``TensorParallel`` or None.  When set, the weights a forward
reads are this rank's blocks of a tensor-parallel model (mesh serving,
``launch/sharding.serve_param_specs``): attention runs on the local
heads and ends in one ``all_reduce`` of the row-parallel ``wo``, the
feed-forward the same with ``w_down``, the embedding is a masked local
lookup plus an ``all_reduce`` and the head's local logits are
``all_gather``-ed (``common.linear_rows``, ``common.embed``,
``lm._head``).  A part its plan leaves whole runs on every rank with no
collective.  The scheduler sets it around each tick, as it does the
tuner.  The rest of the reference's flags (activation sharding, MoE
dispatch groups, unrolled accounting) serve its dry run (ROADMAP A.6b).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

KERNEL_TUNER = None
TP = None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the 'model' axis and what is split over it
    (``launch/sharding.TPPlan``): ``group`` the model-axis process group,
    ``size`` its extent, ``index`` this rank's coordinate."""

    group: Any
    size: int
    index: int
    attn: bool
    ffn: bool
    vocab: bool


@contextlib.contextmanager
def kernel_tuner(tuner):
    global KERNEL_TUNER
    prev = KERNEL_TUNER
    KERNEL_TUNER = tuner
    try:
        yield
    finally:
        KERNEL_TUNER = prev


@contextlib.contextmanager
def tensor_parallel(tp: TensorParallel | None):
    global TP
    prev = TP
    TP = tp
    try:
        yield
    finally:
        TP = prev
