"""Fault tolerance and straggler analysis for training.  Elastic restart
onto a smaller mesh (``runtime/elastic.py``) waits for multi-GPU
(ROADMAP.md A.6)."""
from .ft import FaultTolerantTrainer, SimulatedFailure
from .stragglers import mitigation_table, straggler_step_time

__all__ = ["FaultTolerantTrainer", "SimulatedFailure", "mitigation_table",
           "straggler_step_time"]
