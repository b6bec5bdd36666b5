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
from .cost_model import (ADJACENT_DIFFERENCE, WorkloadProfile,
                         artificial_work, t0_analytic, t_iter_analytic)
from .customization import (get_chunk_size, measure_iteration,
                            processing_units_count)
from .executor import (Chunk, Executor, ExecutorBase, HostParallelExecutor,
                       MeshExecutor, SequentialExecutor, UnsupportedOperation,
                       make_chunks, mesh_executor_of, unwrap_executor)
from .feedback import OnlineFeedback, tag_workload
from .future import Future, when_all
from .hardware import (AMD_EPYC_48C, H100_SXM, INTEL_SKYLAKE_40C,
                       HardwareSpec, this_host)
from .model import (Decision, DecisionKey, DecisionTrace, ExecutionModel,
                    hardware_key)
from .overhead_law import AccDecision, decide
from .policy import ExecutionPolicy, par, par_unseq, seq, unseq
from .properties import (ExecutorAnnotations, ExecutorProperty,
                         UnsupportedProperty, params_of, prefer, require,
                         with_hint, with_params, with_priority)
from .simmachine import EPYC_48, SKYLAKE_40, SimMachine

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
    "UnsupportedOperation", "unwrap_executor", "mesh_executor_of",
    "ExecutorAnnotations", "ExecutorProperty", "UnsupportedProperty",
    "prefer", "require", "params_of", "with_priority", "with_hint",
    "with_params", "SimMachine", "SKYLAKE_40", "EPYC_48",
    "ADJACENT_DIFFERENCE", "artificial_work", "this_host",
    "INTEL_SKYLAKE_40C", "AMD_EPYC_48C",
]
