"""Device meshes for the port.  Only the one-process host view is ported
(``make_host_mesh``); ``torch.distributed.DeviceMesh`` meshes, the
production and serving meshes and their axis helpers wait for
multi-GPU (ROADMAP.md A.6)."""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device


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
