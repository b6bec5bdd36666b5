"""The roofline on one card: the model's useful flops, the report the
reference prints, and the count of the work one eager call must do.

The reference reads its costs from a compiled XLA artifact
(``extract_costs``: ``cost_analysis()`` and the partitioned HLO).  PyTorch
runs eagerly, so here ``count_costs(fn, *args)`` runs ``fn`` once and
counts in two parts:

* every tensor op, through a ``TorchDispatchMode``: flops by
  ``torch.utils.flop_counter``'s formulas (products: ``mm``, ``bmm``,
  ...; elementwise ops count none), bytes as its tensor inputs read and
  outputs written once — none for a view, the gathered or scattered
  elements (and the indices) for an indexed read or write, not the whole
  tensor indexed;
* every kernel wrapper, by its own count of its work (``build.Work``:
  ``rmsnorm.*_work``, ``flash_attention.*_work``), with the mode
  suppressed inside the wrapper (``build.counted``), so one call counts
  the same on the CPU (the plain versions) and on the card (the
  kernels).

Flops are split into tensor-core ones (products with bf16 or fp16
inputs, and the attention kernels in bf16) and the rest, and each is
divided by its own peak: 989 TFLOP/s bf16 (``core.hardware.H100_SXM``)
and 67 TFLOP/s f32 outside the tensor cores (``H100_F32_FLOPS``), both
NVIDIA's H100 SXM data sheet, bytes by 3.35 TB/s.  A bound is the larger
of the bytes' time and the flops' time.  ``collective_s`` is 0 on one
card.  The dry-run half (``analyze``, ``analyze_calibrated``: a compiled
multi-device artifact) waits for the multi-GPU port (ROADMAP.md).
"""
from __future__ import annotations

import collections
import dataclasses
import json
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..configs.base import ArchConfig, ShapeConfig
from ..core.hardware import H100_SXM
from ..kernels import build
from ..kernels import flash_attention as kfa

H100_F32_FLOPS = 67e12        # f32 outside the tensor cores, data sheet


# ---------------------------------------------------------------------------
# the model's useful flops and the report
# ---------------------------------------------------------------------------

def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6·N(active)·tokens for training, 2·N(active)·tokens for prefill,
    2·N(active)·batch for a decode step (the reference's formula)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_detail: dict
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    useful_fraction: float
    peak_memory_bytes: float
    argument_bytes: float
    peak_flops: float = H100_SXM.peak_flops

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: overlapped model = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bound step time (MFU at the roofline),
        against ``peak_flops`` (the card's bf16 rate by default)."""
        ideal = self.model_flops / (self.chips * self.peak_flops)
        return ideal / self.step_time_s if self.step_time_s > 0 else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, step_time_s=self.step_time_s,
                 roofline_fraction=self.roofline_fraction)
        return d


def flash_attention_hbm_bytes(cfg: ArchConfig, shape: ShapeConfig, *,
                              chips: int, passes: float = 4.0,
                              dtype_bytes: int = 2,
                              block_q: int | None = None) -> float:
    """Per-device device-memory traffic of the flash kernel for one step.

    Per layer, forward: q read + out write (2·T·Hq·D·b) plus K/V streamed
    once per q-block row (nq · 2·T·Hkv·D·b · visible-fraction; causal ⇒
    ~0.55 of tiles visible; a window caps the visible keys).  ``passes``:
    fwd(1) + bwd(2) + remat-fwd(1) = 4 for training, 1 for prefill.
    ``block_q``: query positions per block; by default the tile path's,
    ``TILE_ROWS`` packed rows (``SPLIT_ROWS`` in f32) over the GQA group
    (the reference's formula at the reference's block gives its number).
    """
    s = shape.seq_len
    tokens = shape.global_batch * s
    d = cfg.head_dim_
    if block_q is None:
        rows = kfa.TILE_ROWS if dtype_bytes == 2 else kfa.SPLIT_ROWS
        block_q = max(rows // max(cfg.n_heads // cfg.n_kv_heads, 1), 1)
    nq = max(s // block_q, 1)
    visible = 0.55 if cfg.attn_window is None else min(
        cfg.attn_window / s + 0.5 / nq, 1.0)
    attn_layers = sum(1 for k in cfg.layer_kinds()
                      if k in ("attn", "shared_attn", "cross_attn"))
    per_layer = (2.0 * tokens * cfg.n_heads * d * dtype_bytes
                 + nq * 2.0 * tokens * cfg.n_kv_heads * d * dtype_bytes
                 * visible)
    return passes * attn_layers * per_layer / chips


def save_report(report: RooflineReport, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report.to_dict(), f, indent=2)


def format_row(r: RooflineReport) -> str:
    return (f"{r.arch:22s} {r.shape:12s} {r.mesh:6s} "
            f"cmp {r.compute_s*1e3:9.3f}ms  mem {r.memory_s*1e3:9.3f}ms  "
            f"col {r.collective_s*1e3:9.3f}ms  dom={r.dominant:10s} "
            f"useful {r.useful_fraction*100:5.1f}%  "
            f"roofline {r.roofline_fraction*100:5.1f}%  "
            f"hbm {(r.argument_bytes+r.peak_memory_bytes)/2**30:6.2f}GiB")


# ---------------------------------------------------------------------------
# the count of one eager call
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Costs:
    """What one call must do: tensor-core flops, other flops, bytes, and
    each kernel's share (its wrapper's own count, summed by name)."""

    tensor_flops: float = 0.0
    other_flops: float = 0.0
    bytes: float = 0.0
    kernels: dict = dataclasses.field(
        default_factory=lambda: collections.defaultdict(build.Work))

    @property
    def flops(self) -> float:
        return self.tensor_flops + self.other_flops

    def add(self, work: build.Work) -> None:
        self.tensor_flops += work.tensor_flops
        self.other_flops += work.other_flops
        self.bytes += work.bytes

    def bound(self) -> tuple[float, str]:
        """(the least time the card could take, "bytes" or
        "operations": which of the two sets it), at the H100's rates."""
        t_b = self.bytes / H100_SXM.mem_bw
        t_o = self.tensor_flops / H100_SXM.peak_flops \
            + self.other_flops / H100_F32_FLOPS
        return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def bound_of(work: build.Work) -> tuple[float, str]:
    """The bound of one kernel call's ``Work`` (seconds, what sets it)."""
    costs = Costs()
    costs.add(work)
    return costs.bound()


_aten = torch.ops.aten
# No data moves: allocations, detaching, and the like.
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.detach, _aten.lift_fresh, _aten.alias, _aten.new_empty,
         _aten.new_empty_strided, _aten._local_scalar_dense}
# Indexed reads: the gathered elements read, the indices read, the
# output written.
_GATHER = {_aten.index, _aten.index_select, _aten.gather, _aten.embedding}
# Indexed writes: the values (the last tensor argument) and the indices
# read, the values written.
_SCATTER = {_aten.index_put_, _aten.index_put, _aten.index_copy_,
            _aten.index_copy, _aten.scatter_, _aten.scatter,
            _aten.index_add_, _aten.index_add}
# Writes only.
_FILL = {_aten.fill_, _aten.zero_, _aten.zeros, _aten.ones, _aten.full,
         _aten.zeros_like, _aten.ones_like, _aten.full_like, _aten.arange}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one tensor op must move (module docstring)."""
    packet = func._overloadpacket
    if func.is_view or packet in _FREE:
        return 0
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    if packet in _FILL:
        return sum(map(_nbytes, outs))
    if packet is _aten.copy_:
        return _nbytes(args[0]) + _nbytes(args[1])
    if packet in _GATHER:
        return sum(map(_nbytes, ins[1:])) + 2 * sum(map(_nbytes, outs))
    if packet in _SCATTER:
        others = ins[1:]
        return sum(map(_nbytes, others)) + (_nbytes(others[-1])
                                            if others else 0)
    return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))


def op_flops(func, args, kwargs, out) -> tuple[float, bool]:
    """(flops by ``torch.utils.flop_counter``'s formula, 0 where it has
    none; whether they run on the tensor cores: bf16 or fp16 inputs)."""
    from torch.utils.flop_counter import flop_registry

    formula = flop_registry.get(func._overloadpacket)
    if formula is None:
        return 0.0, False
    flops = float(formula(*args, **kwargs, out_val=out))
    tensor = any(t.dtype in (torch.bfloat16, torch.float16)
                 for t in _tensors(args))
    return flops, tensor


class _TensorOpCount(TorchDispatchMode):
    def __init__(self, costs: Costs):
        super().__init__()
        self.costs = costs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flops, tensor = op_flops(func, args, kwargs, out)
        self.costs.add(build.Work(
            tensor_flops=flops if tensor else 0.0,
            other_flops=0.0 if tensor else flops,
            bytes=op_bytes(func, args, kwargs, out)))
        return out


def count_costs(fn: Callable, *args, **kwargs) -> Costs:
    """Run ``fn(*args, **kwargs)`` once, eagerly, and count what it must
    do (module docstring).  The call's own effects happen as usual."""
    costs = Costs()

    def kernel(name: str, work: build.Work) -> None:
        costs.add(work)
        costs.kernels[name] = costs.kernels[name] + work

    build.work_sinks.append(kernel)
    try:
        with _TensorOpCount(costs):
            fn(*args, **kwargs)
    finally:
        build.work_sinks.remove(kernel)
    costs.kernels = dict(costs.kernels)
    return costs
