"""Elastic scaling: re-plan parallelism for a changed device pool (the
counterpart of ``repro.runtime.elastic``).

The paper's Eq. 7 is reused verbatim as the elastic-scaling rule: given
the surviving ranks, the acc model recomputes how many the workload can
use at the target efficiency, and the checkpoint is resharded onto the
new mesh: each rank takes its own blocks of the restored tree
(``launch.sharding.local_tree``), where the reference hands the whole
tree to ``jax.device_put``.  Straggler mitigation is the C=8
over-decomposition, quantified in ``runtime/stragglers.py``.
"""
from __future__ import annotations

from typing import Any

from ..core.acc import AdaptiveCoreChunk
from ..core.adaptive import adaptive
from ..core.cost_model import WorkloadProfile
from ..core.executor import MeshExecutor
from ..launch import mesh as mesh_lib
from ..launch import sharding


def surviving_mesh(n_devices: int | None = None, *,
                   model_parallel: int = 1, device=None,
                   timeout_s: float | None = None) -> mesh_lib.Mesh:
    """Largest regular (data, model) mesh over the first ``n_devices``
    ranks of the job (all of them by default): after a loss the pool
    shrinks and the mesh stays rectangular.  Every rank of the job calls
    it; ranks past the mesh idle."""
    import torch.distributed as dist

    world = dist.get_world_size()
    n = world if n_devices is None else min(int(n_devices), world)
    mp = max(int(model_parallel), 1)
    while n % mp:
        mp -= 1
    return mesh_lib.make_mesh((n // mp, mp), ("data", "model"),
                              device=device, timeout_s=timeout_s)


def elastic_plan(cfg_profile: WorkloadProfile, n_elements: int, mesh,
                 acc: AdaptiveCoreChunk | None = None):
    """acc decision over the surviving mesh (Eq. 7 as the scaling rule),
    taken on mesh rank 0 and broadcast when the mesh is one of ranks."""
    mexec = adaptive(MeshExecutor(mesh, data_axes=("data",)), acc)

    def decide():
        return mexec.params.decide_for_profile(mexec, cfg_profile,
                                               n_elements)

    if hasattr(mesh, "agree"):
        return mesh.agree(decide, mexec.params.model)
    return decide()


def reshard(tree: Any, mesh, spec_tree: Any = None) -> Any:
    """This rank's blocks of a (restored) full tree on ``mesh``.
    ``spec_tree`` may be one spec (a tuple) for every leaf, a matching
    tree of specs, or None (replicate: the tree itself)."""
    if spec_tree is None:
        spec_tree = ()
    return sharding.local_tree(tree, spec_tree, mesh)
