"""acc-driven training autotuning: data-parallel width + microbatch
count, and the per-token workload profiles the serve scheduler reads
(the counterpart of ``repro.train.autotune``).

This is the paper's executor applied at the training-loop level:

* ``measure_iteration`` → analytic per-token step cost from the model's
  FLOPs and the weight/activation traffic through the card's roofline
  (``core.hardware.H100_SXM``);
* ``processing_units_count`` → how many cards the step should occupy
  (Eq. 7: a small workload leaves cards free);
* ``get_chunk_size`` → tokens per microbatch (Eq. 10, C chunks per
  core), floored by the T_m rule so a microbatch still fills the card.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig, ShapeConfig
from ..core.acc import AdaptiveCoreChunk
from ..core.calibration import CalibrationCache
from ..core.cost_model import WorkloadProfile
from ..core.executor import Executor
from ..core.model import DecisionKey
from ..core.overhead_law import AccDecision
from ..core.properties import params_of
from ..kernels.autotune import KernelTuner


def make_kernel_tuner(cache: CalibrationCache | None = None,
                      **kw) -> KernelTuner:
    """The process's measured kernel-block tuner, bound to the same
    calibration store the acc decisions read (training and serving share
    one store)."""
    if cache is None:
        cache = CalibrationCache.persistent()
    return KernelTuner(cache, **kw)


def token_profile(cfg: ArchConfig, *, training: bool = True) -> WorkloadProfile:
    """Per-token cost of one step (per-device view is handled by acc)."""
    n_active = cfg.active_param_count()
    flops = (6.0 if training else 2.0) * n_active
    # weight traffic dominates memory per step at large batch; activations
    # are roughly d_model * n_layers * ~20 bytes/token
    bytes_ = 20.0 * cfg.d_model * cfg.n_layers
    return WorkloadProfile(flops_per_elem=flops, bytes_per_elem=bytes_,
                           name=f"{cfg.name}-{'train' if training else 'serve'}")


def serve_profiles(cfg: ArchConfig) -> tuple[WorkloadProfile, WorkloadProfile]:
    """(prefill, decode) per-token profiles for the serving scheduler.

    Prefill reuses the training-loop profile at forward-only FLOPs (the
    workload element is a prompt token).  Decode is the memory-bound
    regime: each generated token re-reads the active weights, so the
    bytes term is the full 2-byte-per-param weight stream rather than the
    amortised activation traffic.
    """
    prefill = token_profile(cfg, training=False)
    n_active = cfg.active_param_count()
    decode = WorkloadProfile(flops_per_elem=2.0 * n_active,
                             bytes_per_elem=2.0 * n_active,
                             name=f"{cfg.name}-decode")
    return prefill, decode


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    data_parallel: int       # devices the step occupies (acc Eq. 7)
    accum: int               # gradient-accumulation microbatches (Eq. 10)
    microbatch: int          # sequences per microbatch (global)
    decision: AccDecision


def choose_plan(cfg: ArchConfig, shape: ShapeConfig,
                mesh_exec: Executor,
                acc: AdaptiveCoreChunk | None = None,
                *, max_accum: int = 64) -> TrainPlan:
    """``mesh_exec`` may be a ``MeshExecutor`` or any wrapper around one
    (``adaptive(MeshExecutor(mesh))``); with an ``AdaptiveExecutor`` the
    acc object rides on the executor and ``acc=`` can be omitted."""
    acc = acc or params_of(mesh_exec) or AdaptiveCoreChunk()
    profile = token_profile(cfg, training=(shape.kind == "train"))
    tokens = shape.global_batch * shape.seq_len
    key = DecisionKey("train_plan", (cfg.name, shape.name,
                                     shape.global_batch, shape.seq_len))
    d = acc.decide_for_profile(mesh_exec, profile, tokens, key=key)

    dp = d.n_cores
    while dp > 1 and shape.global_batch % dp:
        dp -= 1  # dp must divide the global batch
    # chunk(tokens) -> microbatches: one microbatch must hold >= dp
    # sequences (one per device) and divide the global batch.
    seqs_per_chunk = max(d.chunk_elems // shape.seq_len, 1)
    accum = max(min(shape.global_batch // max(seqs_per_chunk, 1), max_accum), 1)
    while shape.global_batch % accum or (shape.global_batch // accum) % dp:
        accum -= 1  # snap to a divisor compatible with the dp width
    microbatch = shape.global_batch // accum
    # The divisor snapping changes the shipped numbers, so the trace
    # records what actually runs.
    acc.model.note(key, policy="train-plan", cores=dp,
                   chunk=microbatch * shape.seq_len, batch_width=dp, acc=d,
                   inputs=(("accum", accum), ("microbatch", microbatch),
                           ("tokens", tokens)))
    return TrainPlan(data_parallel=dp, accum=accum,
                     microbatch=microbatch, decision=d)
