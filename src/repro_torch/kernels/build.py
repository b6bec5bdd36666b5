"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file is one kernel with a plain C entry point; it is
compiled on first use into its own shared library for ``sm_90a``
(``nvcc -gencode arch=compute_90a,code=sm_90a -shared``), keyed by a hash
of the sources and flags, under ``build/kernels/`` at the repository
root.  All sources are compiled at once, one ``nvcc`` process each, so a
cold build takes as long as the slowest file.  Nothing is compiled when
this module is imported.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Any, Callable

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None     # wall-clock of the last cold build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on the machine with the card (set CUDA_HOME)")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(src: pathlib.Path) -> str:
    h = hashlib.sha256()
    for dep in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(src: pathlib.Path) -> pathlib.Path:
    return BUILD_DIR / f"lib{src.stem}-{_digest(src)}.so"


def build_all() -> dict[str, pathlib.Path]:
    """Compile every kernel source that has no up-to-date library yet, all
    ``nvcc`` processes started together; returns ``{stem: library}``.
    Raises with the compiler's output if any build fails."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src)) for src in _sources()}
    todo = {stem: st for stem, st in targets.items() if not st[1].exists()}
    if todo:
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for stem, (src, out) in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[stem] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        errors = []
        for stem, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {stem}.cu:\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)   # atomic: no torn library is loaded
        build_seconds = time.perf_counter() - t0
        if errors:
            raise RuntimeError("\n".join(errors))
    return {stem: out for stem, (_, out) in targets.items()}


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            paths = build_all()
            if stem not in paths:
                raise KeyError(f"no kernel source csrc/{stem}.cu")
            lib = ctypes.CDLL(str(paths[stem]))
            _libs[stem] = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


@functools.cache
def _sms(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """SMs of a CUDA device (the current one where it has no index)."""
    import torch

    index = device.index
    return _sms(torch.cuda.current_device() if index is None else index)


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph: a wrapper
    then may not make or grow a scratch buffer (the graph would keep its
    address after it is freed)."""
    import torch

    return torch.cuda.is_available() \
        and torch.cuda.is_current_stream_capturing()


# Set by ``plain_on_meta``: meta tensors take the wrappers' plain
# versions.
_PLAIN_META = False


def plain(x) -> bool:
    """Whether a kernel wrapper runs its plain version for ``x``: a CPU
    tensor, or a meta tensor under ``plain_on_meta`` (the dry run's
    count on the meta device, which computes shapes only).  A meta tensor
    otherwise stands for a card's (the wrappers' card branch)."""
    kind = x.device.type
    return kind == "cpu" or (kind == "meta" and _PLAIN_META)


@contextlib.contextmanager
def plain_on_meta():
    global _PLAIN_META
    prev = _PLAIN_META
    _PLAIN_META = True
    try:
        yield
    finally:
        _PLAIN_META = prev


def records_grad(*tensors) -> bool:
    """Whether autograd records an op on ``tensors``: grad mode is on and
    one of them requires grad."""
    import torch

    if torch.is_grad_enabled():
        for t in tensors:
            if t.requires_grad:
                return True
    return False


def refuse_grad(name: str, use: str, *tensors) -> None:
    """Raise if autograd would record an op on ``tensors``
    (``records_grad``): a kernel fills its output through a raw pointer,
    so the output would have no autograd node and every gradient upstream
    of it would silently be lost.  ``use`` names the differentiable entry
    to call instead."""
    if records_grad(*tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and this kernel entry has no "
            f"autograd node (its result would be cut from the graph); use "
            f"{use}")


_counters: list[LaunchCounter] = []


class LaunchCounter:
    """How many times a wrapper launched its kernel (a plain integer that
    ``chip_smoke.py`` resets before a run and reads after it), and, where
    the wrapper names one, how many times at each key (``by_key``: kernel
    3 keys its launches by shape).  Locked: the parallel algorithms
    launch from several worker threads.  Every counter is registered, so
    a CUDA graph can take back what its capture counted and count it
    again at each replay (``snapshot`` / ``restore`` / ``add_tally``)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.by_key: dict = {}
        self._lock = threading.Lock()
        _counters.append(self)

    def add(self, key=None) -> None:
        with self._lock:
            self.count += 1
            if key is not None:
                self.by_key[key] = self.by_key.get(key, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.by_key = {}


def snapshot() -> dict:
    """Every counter's count and keyed counts, to ``restore`` or to diff
    against (``tally_since``)."""
    return {c: (c.count, dict(c.by_key)) for c in _counters}


def restore(snap: dict) -> None:
    for c, (count, by_key) in snap.items():
        with c._lock:
            c.count, c.by_key = count, dict(by_key)


def tally_since(snap: dict) -> dict:
    """What every counter gained since ``snap``: ``{counter: (launches,
    {key: launches})}``, counters that gained nothing left out."""
    out = {}
    for c, (count, by_key) in snap.items():
        keys = {k: n - by_key.get(k, 0) for k, n in c.by_key.items()
                if n != by_key.get(k, 0)}
        if c.count != count or keys:
            out[c] = (c.count - count, keys)
    return out


def add_tally(tally: dict) -> None:
    """Count ``tally`` (from ``tally_since``) once more."""
    for c, (count, by_key) in tally.items():
        with c._lock:
            c.count += count
            for k, n in by_key.items():
                c.by_key[k] = c.by_key.get(k, 0) + n


# ---------------------------------------------------------------------------
# the work a kernel call must do (analysis/roofline.count_costs reads it)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Work:
    """What one kernel call must do, whatever implements it: products on
    the tensor cores (bf16), other operations, and bytes (each input read
    once, each output written once; where the work depends on the data,
    what this call's data needs)."""

    tensor_flops: float = 0.0
    other_flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: Work) -> Work:
        return Work(self.tensor_flops + other.tensor_flops,
                    self.other_flops + other.other_flops,
                    self.bytes + other.bytes)


# Active cost counts: each is called with (kernel name, Work) once per
# wrapper call while it is listed (``analysis/roofline.count_costs``).
work_sinks: list[Callable[[str, Work], None]] = []
# Called with each counted wrapper call's result while a count is active
# (the count's memory tally sees the tensors a wrapper makes).
result_sinks: list[Callable[[Any], None]] = []
# Context managers a counted wrapper's own body runs under while a count
# is active (the count's op memo, which counts nothing).
quiet_modes: list[Callable[[], Any]] = []


def counted(name: str, work: Callable[..., Work]):
    """Decorate a kernel wrapper: while a cost count is active
    (``work_sinks``), each call adds ``work(*args, **kwargs)`` (the
    wrapper's own count of its work) and runs with the count's tensor-op
    mode suppressed, so the wrapper's own tensor ops (its plain version
    on the CPU, its allocations on the card) are not counted again: one
    call counts the same on the CPU and on the card.  With no count
    active the wrapper runs as it is."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not work_sinks:
                return fn(*args, **kwargs)
            from torch.utils._python_dispatch import _disable_current_modes

            with _disable_current_modes():
                w = work(*args, **kwargs)
                for sink in list(work_sinks):
                    sink(name, w)
                with contextlib.ExitStack() as stack:
                    for mode in quiet_modes:
                        stack.enter_context(mode())
                    out = fn(*args, **kwargs)
                for sink in list(result_sinks):
                    sink(out)
                return out
        return wrapper
    return deco
