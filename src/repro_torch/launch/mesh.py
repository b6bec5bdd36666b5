"""Device meshes for the port (the counterpart of ``repro.launch.mesh``).

The reference is single-controller: one process drives every device and
a ``jax.sharding.Mesh`` names them.  The port is multi-controller: one
process per device over ``torch.distributed`` (launched by ``torchrun``
or ``torch.multiprocessing.spawn``), NCCL on the card and gloo on the
CPU.  A ``Mesh`` is this process's view of a mesh of ranks: the ranks
by mesh coordinate, this rank's process group along each axis, one
group over the whole mesh, one over the mesh's first ``d`` ranks for
each divisor ``d`` of its size (the algorithms' acc-sized sub-groups),
and one gloo group over the same ranks for host objects (``agree``).

Every rank runs the same code and enters every collective in the same
order.  Two rules follow, which every mesh path of the port keeps:

* a decision that reads a measured time is taken on mesh rank 0 and
  broadcast (``Mesh.agree``): timings differ from rank to rank, and
  deciding on each would desynchronise the collectives (a hang, not an
  error);
* every wait is bounded: ``init_distributed`` gives the process group
  a timeout (60 s by default), and every group of a mesh gets the
  mesh's, so a desynchronised run fails in a minute.

Process groups are collectives themselves: every rank of the job
creates every group of a mesh, in one fixed order, when the mesh is
made (``dist.new_group`` called later on a rank-local branch would
deadlock).

``n_data_replicas``, ``data_axes`` and ``batch_axes`` read any object
with a ``shape`` mapping, as the reference's do, so a stub mesh works
with no process group.  ``make_host_mesh`` is the one-process view of
the visible cards (``HostMesh``).

``make_production_mesh`` gives the dry run's (16, 16) and (2, 16, 16)
meshes.  The dry run has no 512 cards: it joins a ``"fake"`` process
group of 512 ranks as rank 0 (``init_fake``), whose collectives return
at once and move nothing, and runs on meta tensors
(``launch/dryrun.py``).  On a fake group the mesh's host-object group is
a group of the default backend (a gloo group cannot be made there), and
the eager probe of ``_build`` runs on a CPU tensor.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

DEFAULT_TIMEOUT_S = 60.0


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The devices one process sees, as a ("data", "model") mesh with
    every device on the data axis: what ``core.executor.MeshExecutor``
    and ``train.autotune.choose_plan`` read (``shape``)."""

    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "model": 1}


def make_host_mesh(device: str | torch.device = "cuda") -> HostMesh:
    """A data axis over the visible cards (``device="cpu"``: the CPU as
    one device); raises with no card unless the CPU is asked for."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return HostMesh((dev,))
    return HostMesh(tuple(torch.device("cuda", i)
                          for i in range(torch.cuda.device_count())))


def _timeout(timeout_s: float | None) -> datetime.timedelta:
    return datetime.timedelta(
        seconds=DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s)


def init_distributed(device: str | torch.device = "cuda", *,
                     init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None,
                     timeout_s: float | None = None) -> torch.device:
    """Join the job's default process group and return this rank's device.

    ``"cuda"`` gives NCCL and makes the rank's card (``LOCAL_RANK``, else
    the rank modulo the visible cards) current; ``"cpu"`` gives gloo.
    Rank and world size come from the arguments or from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``; ``init_method`` defaults to
    ``env://``).  Every collective of the job waits at most
    ``timeout_s`` (60 s).  With no card, ``"cuda"`` raises: there is no
    gloo fallback.  Calling it again in a process that already joined
    returns the device and changes nothing."""
    dev = resolve_device(device)
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    world_size = int(os.environ.get("WORLD_SIZE", 1)) \
        if world_size is None else int(world_size)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method or "env://", rank=rank,
        world_size=world_size, timeout=_timeout(timeout_s))
    return dev


def init_fake(world_size: int) -> None:
    """Join a ``"fake"`` process group of ``world_size`` ranks as rank 0
    (``torch.testing``'s ``FakeStore``): every group of it can be made,
    and its collectives return at once without moving data.  For the
    dry run's count on meta tensors; nothing else of the port runs on
    it.  A process that already joined a group keeps it."""
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(world_size))


def is_fake() -> bool:
    return dist.is_initialized() and dist.get_backend() == "fake"


def _default_device() -> torch.device:
    """This rank's device under the default group's backend."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclasses.dataclass(eq=False)
class Mesh:
    """A mesh of ``torch.distributed`` ranks, as this rank sees it.

    ``ranks`` holds the global rank at every mesh coordinate;
    ``groups[axis]`` is this rank's process group along ``axis`` (the
    ranks that differ from it in that coordinate only), and, on a mesh
    with a 'pod' axis, ``groups[("pod", "data")]`` along both (the ranks
    that hold other rows of a batch); ``whole`` the
    group over every rank of the mesh, ``ctrl`` a gloo group over the
    same ranks for host objects.  A rank outside the mesh (a serving
    mesh over a subset) holds None for each.  ``subgroups[d]`` is, for
    each divisor ``d`` of the mesh's size, (this rank's group over the
    mesh's first ``d`` ranks, or None outside them; those ranks): what
    ``core.executor.MeshExecutor.subgroup`` reads."""

    ranks: np.ndarray
    axis_names: tuple[str, ...]
    device: torch.device
    groups: dict[str, Any]
    whole: Any
    ctrl: Any
    subgroups: dict[int, tuple[Any, tuple[int, ...]]]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape, strict=True))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def rank(self) -> int:
        """This process's global rank."""
        return dist.get_rank()

    @property
    def contains(self) -> bool:
        return self.rank in self.ranks

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        where = np.argwhere(self.ranks == self.rank)
        if not len(where):
            raise ValueError(f"rank {self.rank} is not in the mesh")
        return int(where[0][self.axis_names.index(axis)])

    @property
    def leader(self) -> int:
        """The global rank of mesh rank 0, which takes the decisions."""
        return int(self.ranks.reshape(-1)[0])

    def agree(self, fn: Callable[[], Any], model=None) -> Any:
        """``fn()`` decided once for the whole mesh: mesh rank 0 calls
        it, and its value and the decisions it recorded in ``model``'s
        trace (an ``ExecutionModel``, or None) are broadcast over the
        gloo group; every other rank records the same decisions and
        returns the same value, without calling ``fn``.  A rank outside
        the mesh (which enters none of its collectives) calls ``fn``
        itself."""
        if not self.contains or self.size == 1:
            return fn()
        if self.rank == self.leader:
            seq = model.trace._seq if model is not None else 0
            value = fn()
            new = [e.decision for e in model.trace.entries()
                   if e.seq >= seq] if model is not None else []
            box = [(value, new)]
        else:
            box = [None]
        dist.broadcast_object_list(box, src=self.leader, group=self.ctrl)
        value, new = box[0]
        if self.rank != self.leader and model is not None:
            for decision in new:
                model.trace.record(decision)
        return value


def _new_group(ranks: list[int], timeout_s, backend=None):
    return dist.new_group(ranks=ranks, timeout=_timeout(timeout_s),
                          backend=backend)


def _build(ranks: np.ndarray, axes: tuple[str, ...], device: torch.device,
           timeout_s: float | None) -> Mesh:
    """Every group of the mesh, created by every rank of the job in one
    fixed order (axis by axis, lines in index order; with a 'pod' axis
    the ('pod', 'data') lines; the whole mesh; the host-object group; the
    prefix sub-groups in increasing size), each waiting at most
    ``timeout_s``; this rank keeps its own."""
    me = dist.get_rank()
    groups: dict[Any, Any] = {}
    for i, axis in enumerate(axes):
        lines = np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
        groups[axis] = None
        for line in lines:
            g = _new_group([int(r) for r in line], timeout_s)
            if me in line:
                groups[axis] = g
    if "pod" in axes and "data" in axes:
        # The batch axes together: every line over (pod, data) at one
        # model coordinate.
        both = (axes.index("pod"), axes.index("data"))
        rest = [i for i in range(len(axes)) if i not in both]
        lines = np.transpose(ranks, rest + list(both)).reshape(
            -1, ranks.shape[both[0]] * ranks.shape[both[1]])
        groups[("pod", "data")] = None
        for line in lines:
            g = _new_group([int(r) for r in line], timeout_s)
            if me in line:
                groups[("pod", "data")] = g
    flat = [int(r) for r in ranks.reshape(-1)]
    whole = _new_group(flat, timeout_s)
    # A fake group (the dry run) makes no gloo group: the host objects
    # go over a group of its own backend.
    ctrl = _new_group(flat, timeout_s,
                      backend=None if is_fake() else "gloo")
    inside = me in flat
    subgroups = {}
    for d in range(1, len(flat) + 1):
        if len(flat) % d == 0:
            g = whole if d == len(flat) else _new_group(flat[:d], timeout_s)
            subgroups[d] = (g if me in flat[:d] else None, tuple(flat[:d]))
    mesh = Mesh(ranks, tuple(axes), device, groups,
                whole if inside else None, ctrl if inside else None,
                subgroups)
    if inside:
        # One eager collective on every group of this rank: NCCL builds a
        # group's communicator at its first collective, which must not be
        # inside a CUDA graph capture (the decode steps capture theirs).
        probe = torch.zeros(1, device="cpu" if is_fake() else device)
        for g in list(groups.values()) + [whole]:
            dist.all_reduce(probe, group=g)
    return mesh


def make_mesh(shape, axes, *, device: str | torch.device | None = None,
              timeout_s: float | None = None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over ranks ``0..prod(shape)``
    of the job (``init_distributed`` first), whose groups each wait at
    most ``timeout_s`` (60 s).  Every rank of the job must call it."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "launch.mesh.init_distributed first")
    need = int(np.prod(shape))
    world = dist.get_world_size()
    if need > world:
        raise ValueError(f"mesh {shape} needs {need} ranks, the job has "
                         f"{world}")
    dev = _default_device() if device is None else resolve_device(device)
    return _build(np.arange(need).reshape(shape), axes, dev, timeout_s)


def make_serve_mesh(data: int, model: int, *,
                    device: str | torch.device | None = None,
                    timeout_s: float | None = None) -> Mesh:
    """A (data, model) serving mesh over the first ``data*model`` ranks:
    'data' carries the data-parallel slot-group replicas, 'model' the
    tensor-parallel shards within each replica.  As in the reference the
    mesh may occupy a subset of the job; ranks outside it idle."""
    data, model = int(data), int(model)
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({data}, {model})")
    return make_mesh((data, model), ("data", "model"), device=device,
                     timeout_s=timeout_s)


def make_production_mesh(*, multi_pod: bool = False,
                         timeout_s: float | None = None) -> Mesh:
    """The dry run's meshes, as the reference's: (16, 16) ("data",
    "model") over the first 256 ranks, or with ``multi_pod`` (2, 16, 16)
    ("pod", "data", "model") over 512.  Every rank of the job must call
    it; the dry run calls it on a fake group (``init_fake``), where its
    device is the meta device."""
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs a process group: "
                           "call init_fake(512) (the dry run) or "
                           "init_distributed first")
    if is_fake():
        need = int(np.prod(shape))
        if need > dist.get_world_size():
            raise ValueError(f"mesh {shape} needs {need} ranks, the job has "
                             f"{dist.get_world_size()}")
        return _build(np.arange(need).reshape(shape), axes,
                      torch.device("meta"), timeout_s)
    return make_mesh(shape, axes, timeout_s=timeout_s)


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def n_data_replicas(mesh) -> int:
    """Number of data-parallel replicas (product of the non-'model'
    batch axes): the serve pool's slot dim splits into this many groups."""
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return n


def batch_axes(mesh):
    """The spec entry for a global-batch dimension."""
    ax = data_axes(mesh)
    return ax if len(ax) > 1 else (ax[0] if ax else None)
