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

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

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


class LaunchCounter:
    """How many times a wrapper launched its kernel (a plain integer that
    ``chip_smoke.py`` resets before a run and reads after it).  Locked:
    the parallel algorithms launch from several worker threads."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0
