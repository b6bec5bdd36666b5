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
of the bytes' time and the flops' time.

The count also records the call's collectives (``collectives.py``'s
sink: kind, bytes of the result buffer, the group's size; the tensor-op
mode skips the ``c10d`` ops themselves) and the peak of the bytes of the
tensors the call made and still holds, each storage tallied when it is
made and dropped when it is freed (a storage shared by views counts
once; the arguments' own storages are not the call's).

``analyze`` turns one rank's count of one call into the reference's
``RooflineReport`` (the dry run's, ``launch/dryrun.py``): per-device
flops and bytes, the collectives' wire bytes by the reference's formula
(``collective_bytes``, ``wire_bytes``) over NVLink's 450 GB/s.  The
reference's ``analyze_calibrated`` corrects XLA's cost analysis, which
counts a loop body once; an eager count sees every iteration, so it
needs no calibration (ROADMAP.md A.7b).
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import json
import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import collectives as coll
from ..configs.base import ArchConfig, ShapeConfig
from ..core.hardware import H100_SXM, HardwareSpec
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


def collective_bytes(records: list) -> dict:
    """Per-kind totals of a count's collectives (``Costs.collectives``),
    as the reference's ``collective_bytes`` reads them off partitioned
    HLO: ``{"bytes": {kind: result bytes, "total", "wire_total"},
    "counts": {kind: calls}}``.  A collective over a group of one rank
    moves nothing (XLA emits none): it is counted as a call and adds no
    bytes."""
    out: dict[str, float] = {}
    counts: dict[str, int] = {}
    for kind, nbytes, size in records:
        counts[kind] = counts.get(kind, 0) + 1
        out[kind] = out.get(kind, 0.0) + (float(nbytes) if size > 1 else 0.0)
    out["total"] = sum(out.values())
    out["wire_total"] = wire_bytes(out)
    return {"bytes": out, "counts": counts}


def wire_bytes(byte_map: dict) -> float:
    """The reference's ring-wire model: an all-reduce crosses the ring
    twice (2× its buffer), every other collective ~1× its result."""
    total = 0.0
    for kind, v in byte_map.items():
        if kind in ("total", "wire_total"):
            continue
        total += 2.0 * v if kind == "all-reduce" else v
    return total


def analyze(costs: "Costs", *, cfg: ArchConfig, shape: ShapeConfig,
            mesh_name: str, chips: int, argument_bytes: float = 0.0,
            hw: HardwareSpec = H100_SXM) -> RooflineReport:
    """The roofline of one rank's count of one call (``count_costs``):
    compute at the tensor-core and f32 peaks, memory at HBM's rate, the
    collectives' wire bytes at NVLink's; ``peak_memory_bytes`` the
    count's peak, ``argument_bytes`` what the caller passed in."""
    detail = collective_bytes(costs.collectives)
    cb = float(detail["bytes"]["wire_total"])
    flops = costs.flops
    mf = model_flops(cfg, shape)
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=costs.bytes,
        collective_bytes_per_device=cb, collective_detail=detail,
        compute_s=costs.tensor_flops / hw.peak_flops
        + costs.other_flops / H100_F32_FLOPS,
        memory_s=costs.bytes / hw.mem_bw,
        collective_s=cb / hw.link_bw,
        model_flops=mf,
        useful_fraction=mf / (flops * chips) if flops else 0.0,
        peak_memory_bytes=float(costs.peak_bytes),
        argument_bytes=float(argument_bytes),
        peak_flops=hw.peak_flops)


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
    # (kind, result bytes, group size) of every collective, in order.
    collectives: list = dataclasses.field(default_factory=list)
    # The most bytes of tensors the call had made and held at once.
    peak_bytes: float = 0.0

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
    """The tensors of an op's arguments or results (nested tuples, lists
    and dicts)."""
    out: list[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(tree)
    return out


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


class _LiveBytes:
    """The bytes of the storages a call made that are still alive, and
    their peak: a storage is tallied the first time a new result holds it
    (an op's result that aliases no argument, or a kernel wrapper's) and
    untallied when it is freed.  A storage held only by a reference
    cycle (a frame kept by a traceback, say) is freed when the garbage
    collector finds it, so before the tally passes its peak by more than
    ``slack`` the collector runs: the peak is that of reachable storages,
    to within the slack (1% of the peak, at least ``min_slack`` bytes)."""

    min_slack = 256 << 20

    def __init__(self, costs: Costs):
        self.costs = costs
        self.live = 0
        self.seen: set[int] = set()
        self.collected = 0

    def _free(self, key: int, nbytes: int) -> None:
        self.seen.discard(key)
        self.live -= nbytes

    def made(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self.seen:
                continue
            nbytes = st.nbytes()
            self.seen.add(key)
            self.live += nbytes
            weakref.finalize(st, self._free, key, nbytes)
        if self.live > self.collected + max(self.min_slack,
                                            0.01 * self.collected):
            gc.collect()
            self.collected = max(self.collected, self.live)
        self.costs.peak_bytes = max(self.costs.peak_bytes, self.live)


_HASHABLE = (int, float, bool, str, type(None), torch.dtype, torch.device,
             torch.memory_format, torch.layout)


def _meta_key(x):
    """A hashable key of an op argument: a meta tensor by its shape,
    strides and dtype; None where there is none."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            return None
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        keys = [type(x)]
        for v in x:
            k = _meta_key(v)
            if k is None and v is not None:
                return None
            keys.append(k)
        return tuple(keys)
    return x if isinstance(x, _HASHABLE) else None


_fresh: dict = {}


def _memoizable(func) -> bool:
    """Whether an op's results are new tensors, none aliasing or writing
    an argument (its meta result then depends on its arguments' metadata
    alone)."""
    known = _fresh.get(func)
    if known is None:
        schema = func._schema
        known = _fresh[func] = not func.is_view and all(
            a.alias_info is None for a in list(schema.arguments)
            + list(schema.returns))
    return known


def _empty(shape, stride, dtype) -> torch.Tensor:
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _spec(out):
    """How to make ``out`` (meta tensors) again, or None."""
    def meta(t):
        return isinstance(t, torch.Tensor) and t.device.type == "meta"

    if meta(out):
        return (tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, tuple) and out and all(map(meta, out)):
        return [(tuple(t.shape), t.stride(), t.dtype) for t in out]
    return None


def _remake(spec):
    return tuple(_empty(*s) for s in spec) if isinstance(spec, list) \
        else _empty(*spec)


def _op_key(func, args, kwargs):
    """The memo key of an op whose results are new tensors and whose
    arguments are meta tensors and hashable values; None otherwise."""
    if not _memoizable(func):
        return None
    k = _meta_key((args, tuple(sorted(kwargs.items()))))
    return None if k is None else (func, k)


def _fresh_results(func, args, kwargs, out) -> bool:
    """Whether the op's results are new storages: no alias in its schema
    and none found (``_unsafe_view`` aliases without saying so)."""
    if not _memoizable(func):
        return False
    ins = {id(t.untyped_storage()) for t in _tensors((args, kwargs))}
    return not any(id(t.untyped_storage()) in ins for t in _tensors(out))


class _QuietMemo(TorchDispatchMode):
    """A kernel wrapper's own ops (counted by its ``Work``, not one by
    one), their meta results remembered as ``_TensorOpCount`` does."""

    def __init__(self, known: dict):
        super().__init__()
        self.known = known

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = _op_key(func, args, kwargs)
        spec = self.known.get(key, 0) if key is not None else None
        if spec:
            return _remake(spec)
        out = func(*args, **kwargs)
        if spec == 0:
            self.known[key] = _spec(out) if _fresh_results(
                func, args, kwargs, out) else None
        return out


class _TensorOpCount(TorchDispatchMode):
    """Counts every op (``op_flops``, ``op_bytes``) and tallies the
    storages of its new results.  An op on meta tensors met again with
    the same arguments' metadata (a dry-run cell repeats every layer's
    ops thousands of times) makes its results with ``empty_strided`` and
    adds the count it added the first time, instead of running its meta
    kernel (in Python, hundreds of microseconds each) and counting
    again.  ``c10d`` ops are counted as collectives
    (``collectives.collective_sinks``), not here."""

    def __init__(self, costs: Costs, live: _LiveBytes):
        super().__init__()
        self.costs = costs
        self.live = live
        self.known: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = _op_key(func, args, kwargs)
        hit = self.known.get(key) if key is not None else None
        if hit is not None and hit[0] is not None:
            spec, work, fresh = hit
            out = _remake(spec)
        else:
            out = func(*args, **kwargs)
            if hit is not None:
                _, work, fresh = hit
            else:
                work = None
                if func.namespace != "c10d":
                    flops, tensor = op_flops(func, args, kwargs, out)
                    work = build.Work(
                        tensor_flops=flops if tensor else 0.0,
                        other_flops=0.0 if tensor else flops,
                        bytes=op_bytes(func, args, kwargs, out))
                fresh = _fresh_results(func, args, kwargs, out)
                if key is not None:
                    self.known[key] = (_spec(out) if fresh else None, work,
                                       fresh)
        if fresh:
            self.live.made(out)
        if work is not None:
            self.costs.add(work)
        return out


def count_costs(fn: Callable, *args, **kwargs) -> Costs:
    """Run ``fn(*args, **kwargs)`` once, eagerly, and count what it must
    do, its collectives and its peak of live bytes (module docstring).
    The call's own effects happen as usual."""
    costs = Costs()
    live = _LiveBytes(costs)

    def kernel(name: str, work: build.Work) -> None:
        costs.add(work)
        costs.kernels[name] = costs.kernels[name] + work

    def collective(kind: str, nbytes: int, size: int) -> None:
        costs.collectives.append((kind, nbytes, size))

    quiet: dict = {}

    def quiet_mode():
        return _QuietMemo(quiet)

    build.work_sinks.append(kernel)
    build.result_sinks.append(live.made)
    build.quiet_modes.append(quiet_mode)
    coll.collective_sinks.append(collective)
    # The objects made before the count are none of its garbage: the
    # collections of the memory tally skip them.
    gc.collect()
    gc.freeze()
    try:
        with _TensorOpCount(costs, live):
            fn(*args, **kwargs)
    finally:
        gc.unfreeze()
        build.work_sinks.remove(kernel)
        build.result_sinks.remove(live.made)
        build.quiet_modes.remove(quiet_mode)
        coll.collective_sinks.remove(collective)
    costs.kernels = dict(costs.kernels)
    return costs
