"""Fault tolerance, straggler analysis and elastic resharding for
training (``elastic``: the surviving mesh, the acc re-plan over it, and
each rank's blocks of a restored tree)."""
from .elastic import elastic_plan, reshard, surviving_mesh
from .ft import FaultTolerantTrainer, SimulatedFailure
from .stragglers import mitigation_table, straggler_step_time

__all__ = ["FaultTolerantTrainer", "SimulatedFailure", "surviving_mesh",
           "elastic_plan", "reshard", "mitigation_table",
           "straggler_step_time"]
