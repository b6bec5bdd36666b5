"""Sharding rules: logical partition specs for params, optimizer state,
batches and serve caches, with shape-aware divisibility fallbacks (the
counterpart of ``repro.launch.sharding``, rule for rule).

Strategy (the reference's):
  * weights — Megatron TP over 'model' (column: out-dim, row: in-dim)
    combined with FSDP over 'data' on the other dim; 'pod' is pure DP.
  * MoE expert weights — stacked (E, ·, ·), expert dim replicated, inner
    dims 2-D sharded (expert tensor parallelism).
  * batches — batch dim over ('pod','data') when divisible.
  * serve caches — batch over data axes when divisible, else sequence
    (long-context SP); KV heads over 'model' when divisible, else head_dim.

Any axis that does not divide its dim is dropped.

A spec is a plain tuple with one entry per dim of its tensor: an axis
name, a tuple of names, or None (replicated); ``()`` replicates the whole
tensor.  It reads as the reference's ``PartitionSpec`` entry by entry.
Paths are the port's parameter-dict paths (``layers/3/attn/wq/w``); the
regexes are the reference's, whose suffixes the port's key names share.
The reference stacks the layers of a pattern group, so its spec of a
layer's leaf has one more leading None than the port's.

The reference hands specs to ``jax.device_put``, which gives every device
its block.  Here each rank takes its own block of a full tensor with
``local_shard`` / ``local_tree``.  What mesh serving slices is
``serve_param_specs``: ``param_specs`` with 'data' dropped, except that
an attention block whose heads do not split over 'model' stays whole on
every rank (``tp_plan``), where GSPMD would shard a head's dims.  What
the sharded train step holds is ``train_param_specs``: ``param_specs``
with the same attention rule ('data' still splitting the leaves), its
gradients synced as ``grad_reduction`` says.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

from .. import tree
from ..configs.base import ArchConfig
from . import mesh as mesh_lib

# (path-suffix regex, spec for the TRAILING dims of the leaf)
_RULES: list[tuple[str, tuple]] = [
    (r"(wq|wk|wv)/w$", ("data", "model")),
    (r"(wq|wk|wv)/b$", ("model",)),
    (r"wo/w$", ("model", "data")),
    (r"(w_up|w_gate)/w$", ("data", "model")),
    (r"w_down/w$", ("model", "data")),
    (r"router/w$", (None, None)),
    (r"moe/(w_up|w_gate)$", (None, "data", "model")),
    (r"moe/w_down$", (None, "model", "data")),
    (r"in_proj/w$", ("data", "model")),
    (r"out_proj/w$", ("model", "data")),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    (r"w_if/w$", ("data", None)),
    (r"w_o/w$", ("data", "model")),
    (r"w_zifo/w$", ("data", "model")),
    (r"proj/w$", ("data", "model")),
    (r"embed/table$", ("model", None)),
    (r"lm_head/w$", ("data", "model")),
]

# Weight-stationary expert rules (--moe-ff2d): expert ff sharded over BOTH
# mesh axes, d unsharded.
_MOE_FF2D_RULES: list[tuple[str, tuple]] = [
    (r"moe/(w_up|w_gate)$", (None, None, ("data", "model"))),
    (r"moe/w_down$", (None, ("data", "model"), None)),
]


def _path_str(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _fit(shape: tuple[int, ...], trailing: tuple, axis_sizes: dict) -> tuple:
    """Pad the trailing spec to ndim and drop non-dividing axes."""
    spec: list = [None] * (len(shape) - len(trailing)) + list(trailing)
    out = []
    for dim, ax in zip(shape, spec, strict=True):
        if ax is None:
            out.append(None)
            continue
        size = axis_sizes.get(ax)
        out.append(ax if size and dim % size == 0 and dim >= size else None)
    return tuple(out)


def _fit2(shape, trailing, axis_sizes) -> tuple:
    """``_fit`` where an entry may also be a tuple of axes."""
    out = []
    spec = [None] * (len(shape) - len(trailing)) + list(trailing)
    for dim, ax in zip(shape, spec, strict=True):
        if ax is None:
            out.append(None)
        elif isinstance(ax, tuple):
            size = 1
            for a in ax:
                size *= axis_sizes.get(a, 1)
            out.append(ax if dim % size == 0 and dim >= size else None)
        else:
            size = axis_sizes.get(ax)
            out.append(ax if size and dim % size == 0 and dim >= size
                       else None)
    return tuple(out)


def param_specs(params: Any, mesh, drop_axes: tuple = (),
                moe_ff2d: bool = False) -> Any:
    """A spec per leaf of ``params`` (any tree of tensors; meta tensors
    do).  ``drop_axes``: remove these mesh axes from weight specs (serving
    drops 'data').  ``moe_ff2d``: the weight-stationary expert rules."""
    axis_sizes = dict(mesh.shape)
    rules = (_MOE_FF2D_RULES + _RULES) if moe_ff2d else _RULES
    specs = []
    for path, leaf in tree.with_paths(params):
        ps = _path_str(path)
        for pat, trailing in rules:
            if re.search(pat, ps):
                t = tuple(None if (not isinstance(a, tuple)
                                   and a in drop_axes) else a
                          for a in trailing)
                specs.append(_fit2(tuple(leaf.shape), t, axis_sizes))
                break
        else:
            specs.append(())
    return tree.unflatten(params, specs)


def opt_specs(param_spec_tree: Any, master: bool = False) -> dict:
    out = {"m": param_spec_tree, "v": param_spec_tree, "step": ()}
    if master:
        out["master"] = param_spec_tree
    return out


def batch_specs(cfg: ArchConfig, mesh, global_batch: int) -> dict:
    bax = mesh_lib.batch_axes(mesh)
    n_data = mesh_lib.n_data_replicas(mesh)
    bspec = bax if (global_batch % n_data == 0 and global_batch >= n_data) \
        else None
    out = {"tokens": (bspec, None), "labels": (bspec, None)}
    if cfg.frontend == "vision":
        out["frontend_feats"] = (bspec, None, None)
    return out


def _heads_spec(n_heads: int, head_dim: int, axis_sizes: dict
                ) -> tuple[Any, Any]:
    """(heads_axis, head_dim_axis): prefer sharding KV heads over 'model';
    fall back to head_dim when heads don't divide."""
    m = axis_sizes.get("model", 1)
    if n_heads % m == 0 and n_heads >= m:
        return "model", None
    if head_dim % m == 0 and head_dim >= m:
        return None, "model"
    return None, None


def cache_specs(cfg: ArchConfig, mesh, global_batch: int,
                cache_len: int, *, seq_over_model: bool = False) -> list:
    """Per-layer cache specs mirroring ``lm.init_caches`` (K/V
    ``(B, Hkv, S, D)``).  ``seq_over_model``: shard the KV cache sequence
    dim over 'model' instead of KV heads / head_dim."""
    axis_sizes = dict(mesh.shape)
    bax = mesh_lib.batch_axes(mesh)
    n_data = mesh_lib.n_data_replicas(mesh)
    batch_ok = global_batch % n_data == 0 and global_batch >= n_data
    bspec = bax if batch_ok else None
    # When the batch can't occupy the data axes, shard the cache sequence
    # dim instead (long-context sequence parallelism).
    data_ax = "data" if not batch_ok else None
    hax, dax = _heads_spec(cfg.n_kv_heads, cfg.head_dim_, axis_sizes)
    m = axis_sizes.get("model", 1)

    specs: list = []
    for kind in cfg.layer_kinds():
        if kind in ("attn", "shared_attn"):
            if seq_over_model and cache_len % m == 0:
                kv = (bspec, None, "model", None)
            else:
                seq_ax = data_ax if (data_ax and cache_len % axis_sizes.get(
                    "data", 1) == 0) else None
                kv = (bspec, hax, seq_ax, dax)
            specs.append({"k": kv, "v": kv})
        elif kind == "cross_attn":
            specs.append(None)
        elif kind == "mamba2":
            hm = "model" if cfg.ssm_heads % m == 0 else None
            conv_ch = cfg.d_inner + 2 * cfg.ssm_state
            cm_ = "model" if conv_ch % m == 0 else None
            specs.append({"ssm": (bspec, hm, None, None),
                          "conv": (bspec, None, cm_)})
        elif kind == "mlstm":
            pm = "model" if cfg.ssm_head_dim % m == 0 else None
            specs.append({"mem": (bspec, None, pm, None)})
        elif kind == "slstm":
            dm = "model" if cfg.d_inner % m == 0 else None
            specs.append({"c": (bspec, dm), "n": (bspec, dm),
                          "m": (bspec, dm)})
        else:
            raise ValueError(kind)
    return specs


def paged_cache_specs(cfg: ArchConfig, mesh, n_slots: int,
                      max_len: int) -> list:
    """Per-layer specs for ``serve/kv_cache.PagedKVCachePool``.  The
    token-major page stores ``(n_pages * page_size, H_kv, D)`` are
    replicated over the data axes (prefix sharing lets any lane map any
    page, so each replica holds every page and the lane updates are
    exchanged); KV heads shard over 'model' as in ``cache_specs``.
    Recurrent state stays slot-major, with the ``cache_specs`` rule."""
    axis_sizes = dict(mesh.shape)
    hax, dax = _heads_spec(cfg.n_kv_heads, cfg.head_dim_, axis_sizes)
    slot_specs = cache_specs(cfg, mesh, n_slots, max_len)
    specs: list = []
    for kind, slot_spec in zip(cfg.layer_kinds(), slot_specs, strict=True):
        if kind in ("attn", "shared_attn"):
            kv = (None, hax, dax)
            specs.append({"k": kv, "v": kv})
        else:
            specs.append(slot_spec)
    return specs


# ---------------------------------------------------------------------------
# The port's own: which blocks mesh serving splits, and each rank's block
# ---------------------------------------------------------------------------

# Block kinds tensor parallelism covers (a MoE feed-forward too); the
# others wait for A.6b.
TP_KINDS = ("attn",)


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """What a mesh splits over 'model': attention heads (q and kv heads
    both divide), the feed-forward hidden dim, the vocabulary (embedding
    rows, head columns), the experts' hidden dim.  A part that does not
    divide runs whole on every rank, with no collective."""

    size: int
    attn: bool
    ffn: bool
    vocab: bool
    moe: bool = False


def tp_plan(cfg: ArchConfig, mesh) -> TPPlan:
    """The tensor-parallel plan of ``cfg`` on ``mesh``'s 'model' axis.
    Raises ``NotImplementedError`` for a block kind TP does not cover
    (Mamba2, xLSTM, cross-attention) when the axis is above 1."""
    m = dict(mesh.shape).get("model", 1)
    if m > 1:
        other = sorted(set(cfg.layer_kinds()) - set(TP_KINDS))
        if other:
            raise NotImplementedError(
                f"{cfg.name}: tensor parallelism over 'model' covers "
                f"attention, dense and MoE feed-forward blocks; {other} "
                f"wait for ROADMAP.md A.6b (use a model extent of 1)")
    split_ff = bool(cfg.d_ff) and cfg.d_ff % m == 0
    return TPPlan(
        size=m,
        attn=cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0,
        ffn=split_ff,
        vocab=cfg.vocab_size % m == 0,
        moe=split_ff and bool(cfg.n_experts))


_ATTN_LEAF = re.compile(r"(^|/)attn/")


def serve_param_specs(cfg: ArchConfig, params: Any, mesh) -> Any:
    """The specs mesh serving slices the weights by: ``param_specs`` with
    'data' dropped (each replica holds a full TP copy), and every leaf of
    an attention block whose heads do not split (``tp_plan``) whole."""
    plan = tp_plan(cfg, mesh)
    specs = param_specs(params, mesh, drop_axes=("data",))
    if plan.attn:
        return specs
    flat = [(path, spec) for (path, _), spec in zip(
        tree.with_paths(params), spec_leaves(specs), strict=True)]
    return tree.unflatten(params, [
        () if _ATTN_LEAF.search(_path_str(path)) else spec
        for path, spec in flat])


def serve_shardings(cfg: ArchConfig, mesh, params, n_slots: int,
                    max_len: int) -> tuple[Any, Any]:
    """(param specs, cache specs) for mesh-sharded serving: weights
    tensor-parallel over 'model' only (``serve_param_specs``), the slot
    pool's cache specs from ``cache_specs``."""
    return (serve_param_specs(cfg, params, mesh),
            cache_specs(cfg, mesh, n_slots, max_len))


def _axis_index(mesh, ax) -> tuple[int, int]:
    """(block count, this rank's block) of a spec entry."""
    axes = ax if isinstance(ax, tuple) else (ax,)
    n, idx = 1, 0
    for a in axes:
        size = mesh.shape[a]
        idx = idx * size + mesh.coord(a)
        n *= size
    return n, idx


def local_shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec`` (a view:
    ``.contiguous()`` copies it when the block is strided).  Entries past
    the spec's length are replicated."""
    out = t
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n, idx = _axis_index(mesh, ax)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"into {n} blocks ({spec})")
        out = out.chunk(n, dim=dim)[idx]
    return out


def spec_leaves(specs: Any) -> list:
    """The specs of a spec tree in ``tree``'s leaf order: dicts (sorted
    keys) and lists are walked, a tuple or None is one leaf."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]


def local_tree(tree_: Any, specs: Any, mesh) -> Any:
    """``local_shard`` over a tree (``specs`` of the same structure, or
    one spec for every leaf), each block copied contiguous: what
    ``jax.device_put(tree, NamedSharding)`` gives a process's devices."""
    flat = tree.leaves(tree_)
    spec_flat = [specs] * len(flat) if isinstance(specs, tuple) \
        else spec_leaves(specs)
    return tree.unflatten(tree_, [
        local_shard(t, s, mesh).contiguous()
        for t, s in zip(flat, spec_flat, strict=True)])


# ---------------------------------------------------------------------------
# The training plan: FSDP over 'data' × tensor parallelism over 'model'
# ---------------------------------------------------------------------------

def _drop_model(spec: tuple) -> tuple:
    return tuple(None if a == "model" else a for a in spec)


def train_param_specs(cfg: ArchConfig, params: Any, mesh) -> Any:
    """The specs the sharded train step holds the parameters by:
    ``param_specs`` (FSDP over 'data', tensor parallelism over 'model'),
    except that an attention block whose heads do not split
    (``tp_plan``) keeps 'model' out of its leaves' specs and runs whole
    on every model rank, 'data' still splitting them (GSPMD would split a
    head's dims instead)."""
    plan = tp_plan(cfg, mesh)
    specs = param_specs(params, mesh)
    if plan.attn:
        return specs
    return tree.unflatten(params, [
        _drop_model(spec) if _ATTN_LEAF.search(_path_str(path)) else spec
        for (path, _), spec in zip(tree.with_paths(params),
                                   spec_leaves(specs), strict=True)])


def split_axes(spec: tuple, mesh) -> tuple[str, ...]:
    """The axes of extent above 1 that ``spec`` splits its leaf over."""
    axes: list[str] = []
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None and mesh.shape.get(a, 1) > 1:
                axes.append(a)
    return tuple(axes)


def grad_reduction(spec: tuple, mesh) -> tuple[tuple[str, str], ...]:
    """How the sharded step syncs the gradient of a leaf held by
    ``spec``, as (collective, axis) pairs in order: a leaf split over
    'data' is reduce-scattered over it (the FSDP gather's backward), one
    replicated over 'data' all-reduced; then every leaf all-reduced over
    'pod'.  Nothing is reduced over 'model': each model rank computes
    its own block, or all of a replicated leaf's gradient.  Every sum is
    then divided by the batch ranks' count (the mean)."""
    out = []
    if "data" in mesh.shape:
        data_split = any(a == "data" or (isinstance(a, tuple) and "data" in a)
                         for a in spec)
        out.append(("reduce-scatter" if data_split else "all-reduce",
                    "data"))
    if "pod" in mesh.shape:
        out.append(("all-reduce", "pod"))
    return tuple(out)
