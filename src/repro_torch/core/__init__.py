"""Core: the paper's adaptive core/chunk execution model, for the port.

Copies of the JAX package's framework-free core modules (the solver,
the calibration store, the executors), with the framework touchpoints
ported: ``hardware_key`` names the CUDA card or the CPU, the measured
search synchronises the card around each probe, and strict mode guards
the serve tick with ``torch.cuda.set_sync_debug_mode``.  The execution
policies (``seq``/``par``/...) and the three customization points are
the parallel algorithms' entry (``repro_torch.algorithms``).
"""
from . import (calibration, cost_model, customization, feedback, model,
               overhead_law, properties)
from .acc import AdaptiveCoreChunk, StaticCoreChunk
from .adaptive import AdaptiveExecutor, adaptive
from .calibration import CalibrationCache
from .cost_model import WorkloadProfile, t0_analytic, t_iter_analytic
from .customization import (get_chunk_size, measure_iteration,
                            processing_units_count)
from .executor import (Chunk, Executor, ExecutorBase, HostParallelExecutor,
                       MeshExecutor, SequentialExecutor, make_chunks)
from .feedback import OnlineFeedback, tag_workload
from .future import Future, when_all
from .hardware import H100_SXM, HardwareSpec
from .model import (Decision, DecisionKey, DecisionTrace, ExecutionModel,
                    hardware_key)
from .overhead_law import AccDecision, decide
from .policy import ExecutionPolicy, par, par_unseq, seq, unseq

__all__ = [
    "calibration", "cost_model", "customization", "feedback", "model",
    "overhead_law", "properties",
    "measure_iteration", "processing_units_count", "get_chunk_size",
    "ExecutionPolicy", "seq", "par", "unseq", "par_unseq",
    "AdaptiveCoreChunk", "StaticCoreChunk", "AdaptiveExecutor", "adaptive",
    "CalibrationCache", "WorkloadProfile", "t0_analytic", "t_iter_analytic",
    "Chunk", "Executor", "ExecutorBase", "HostParallelExecutor",
    "MeshExecutor", "SequentialExecutor", "make_chunks", "OnlineFeedback",
    "tag_workload",
    "Future", "when_all", "H100_SXM", "HardwareSpec", "Decision",
    "DecisionKey", "DecisionTrace", "ExecutionModel", "hardware_key",
    "AccDecision", "decide",
]
