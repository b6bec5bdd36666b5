"""Checkpointing: atomic publish, async save, restore onto any tree
(the counterpart of ``repro.checkpoint.checkpointer``, same layout).

Layout:  <dir>/step_<n>/arrays.npz + meta.json + DONE.  Writes go to a
temp dir first and are renamed into place; a checkpoint without DONE is
ignored by ``latest`` (crash-safe); ``keep`` prunes the oldest.  A leaf's
key is its path in the tree joined by "/".  bf16 leaves are stored as
f32 (numpy has no bf16; the round trip is exact) and ``restore`` casts
each array back to its like-leaf's dtype and device.

``AsyncCheckpointer`` writes on a background thread, but copies the tree
to host memory before ``save_async`` returns: the port's optimizer
updates its tensors in place, so a thread that read live tensors could
save a state torn between two steps.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch

from .. import tree


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _host(leaf: Any) -> np.ndarray:
    """A tensor leaf as a host copy that later in-place updates of the
    tensor cannot reach; any other leaf as an array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _flatten(state: Any) -> dict[str, np.ndarray]:
    return {_key(path): _host(leaf) for path, leaf in tree.with_paths(state)}


def save(ckpt_dir: str, step: int, state: Any, *, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **_flatten(state))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step}, f)
        with open(os.path.join(tmp, "DONE"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    done = [d for d in sorted(os.listdir(ckpt_dir))
            if d.startswith("step_")
            and os.path.exists(os.path.join(ckpt_dir, d, "DONE"))]
    return os.path.join(ckpt_dir, done[-1]) if done else None


def restore(path: str, like: Any) -> tuple[Any, int]:
    """The arrays of the checkpoint at ``path`` on the structure of
    ``like``: each tensor leaf on its like-leaf's device and dtype, and
    the checkpoint's step."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = dict(z.items())
    with open(os.path.join(path, "meta.json")) as f:
        step = json.load(f)["step"]
    leaves = []
    for p, leaf in tree.with_paths(like):
        arr = arrays[_key(p)]
        if isinstance(leaf, torch.Tensor):
            leaves.append(torch.from_numpy(arr).to(device=leaf.device,
                                                   dtype=leaf.dtype))
        else:
            leaves.append(arr)
    return tree.unflatten(like, leaves), step


class AsyncCheckpointer:
    """Background-thread saver: one save in flight; ``wait()`` joins it
    and raises what it raised."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None

    def save_async(self, step: int, state: Any) -> None:
        self.wait()
        host_state = tree.map_leaves(_host, state)   # before returning

        def work():
            try:
                save(self.ckpt_dir, step, host_state, keep=self.keep)
            except BaseException as e:  # noqa: BLE001 - raised in wait()
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
