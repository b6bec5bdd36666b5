"""Model-layer flags (the counterpart of ``repro.models.flags``): only
the measured kernel tuner.

``KERNEL_TUNER`` is an ``autotune.KernelTuner`` or None.  When set, the
model layers resolve kernel 1's warps per block and kernels 2 and 3's
attention plans through it (``models/common.py``, ``models/attention.py``)
and pass them down; when None they pass nothing and the analytic plans
hold.  The serve path sets it around each forward (``kernel_tuner``),
the train launcher for the run (``--kernel-autotune``), as the reference
sets it around its traces.
"""
from __future__ import annotations

import contextlib

KERNEL_TUNER = None


@contextlib.contextmanager
def kernel_tuner(tuner):
    global KERNEL_TUNER
    prev = KERNEL_TUNER
    KERNEL_TUNER = tuner
    try:
        yield
    finally:
        KERNEL_TUNER = prev
