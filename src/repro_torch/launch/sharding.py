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
``serve_param_specs``: ``param_specs`` with 'data' dropped, laid out for
the hand-written tensor parallelism (``_tp_spec``): an attention block
lies over 'model' by its rule (``attention_rule``: its heads, its q
heads sharing each kv head, or, on cached paths, its heads' dims in
rotary pairs, where GSPMD would shard a head's dims as one block), and
a block whose heads or channels do not split stays whole on every rank
(``tp_plan``); a concatenated
projection splits segment by segment (``Segments``), where the
reference's contiguous block of its columns would cut across its parts
and GSPMD would reshard behind it (the Mamba2 ``in_proj``: z, x and Δ by
heads, B and C replicated; the conv channels alike; the mLSTM ``w_if``
and the sLSTM ``w_zifo`` gate by gate); zamba2's ``proj`` stays whole.
What the sharded train step holds is ``train_param_specs``: the same
layout of ``param_specs`` ('data' still splitting the leaves), its
gradients synced as ``grad_reduction`` says.  ``param_specs`` and
``cache_specs`` stay the reference's, rule for rule.
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
                cache_len: int, *, seq_over_model: bool = False,
                plan: "TPPlan | None" = None) -> list:
    """Per-layer cache specs mirroring ``lm.init_caches`` (K/V
    ``(B, Hkv, S, D)``).  ``seq_over_model``: shard the KV cache sequence
    dim over 'model' instead of KV heads / head_dim.  With ``plan`` (a
    ``tp_plan``) the K/V entries follow the port's attention rule
    (``_kv_entries``) instead of the reference's ``_heads_spec``: what
    the pools and the engine hold (``lm.init_caches(..., tp=plan)``)."""
    axis_sizes = dict(mesh.shape)
    bax = mesh_lib.batch_axes(mesh)
    n_data = mesh_lib.n_data_replicas(mesh)
    batch_ok = global_batch % n_data == 0 and global_batch >= n_data
    bspec = bax if batch_ok else None
    # When the batch can't occupy the data axes, shard the cache sequence
    # dim instead (long-context sequence parallelism).
    data_ax = "data" if not batch_ok else None
    hax, dax = _heads_spec(cfg.n_kv_heads, cfg.head_dim_, axis_sizes) \
        if plan is None else _kv_entries(cfg, plan)
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
                      max_len: int, *, plan: "TPPlan | None" = None
                      ) -> list:
    """Per-layer specs for ``serve/kv_cache.PagedKVCachePool``.  The
    token-major page stores ``(n_pages * page_size, H_kv, D)`` are
    replicated over the data axes (prefix sharing lets any lane map any
    page, so each replica holds every page and the lane updates are
    exchanged); KV heads shard over 'model' as in ``cache_specs``
    (``plan``: by the port's attention rule, every one of the four:
    under "head_dim" a store row holds the rank's rotary pairs of every
    kv head's dims).  Recurrent state stays slot-major, with the
    ``cache_specs`` rule."""
    axis_sizes = dict(mesh.shape)
    hax, dax = _heads_spec(cfg.n_kv_heads, cfg.head_dim_, axis_sizes) \
        if plan is None else _kv_entries(cfg, plan)
    slot_specs = cache_specs(cfg, mesh, n_slots, max_len, plan=plan)
    specs: list = []
    for kind, slot_spec in zip(cfg.layer_kinds(), slot_specs, strict=True):
        if kind in ("attn", "shared_attn"):
            kv = (None, hax, dax)
            specs.append({"k": kv, "v": kv})
        else:
            specs.append(slot_spec)
    return specs


# ---------------------------------------------------------------------------
# The port's own: which blocks a mesh splits, and each rank's block
# ---------------------------------------------------------------------------

ATTN_RULES = ("split", "kv_shared", "head_dim", "whole")


def attention_rule(n_heads: int, n_kv_heads: int, head_dim: int, m: int,
                   *, cached: bool, qk_norm: bool = False) -> str:
    """How an attention block of ``n_heads`` q and ``n_kv_heads`` kv heads
    of ``head_dim`` lies over a 'model' axis of extent ``m``:

    * "split": both head counts divide by m; each rank its heads;
    * "kv_shared": the q heads divide by m and m is a multiple of the kv
      heads (so a rank's q heads read one kv head); the K/V projections
      keep the reference's contiguous column split (their columns divide
      by m), and the forward gathers the ranks' columns and keeps that
      one head;
    * "head_dim": ``cached`` (a path that reads or writes K/V caches),
      no q/k-norm (its norm would need a head's sum of squares over
      'model') and the head dim splits into m blocks of rotary pairs (D /
      2 divides by m): each rank holds D / m dims of every head, the
      logits summed over 'model' (the reference's fallback,
      ``_heads_spec``);
    * "whole": every rank runs the block whole."""
    if n_heads % m == 0 and n_kv_heads % m == 0:
        return "split"
    if n_heads % m == 0 and m % n_kv_heads == 0 \
            and (n_kv_heads * head_dim) % m == 0:
        return "kv_shared"
    if cached and not qk_norm and head_dim % (2 * m) == 0:
        return "head_dim"
    return "whole"


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """What a mesh splits over 'model': the attention blocks by their
    rule (``attn`` the self-attention blocks, ``xattn`` the
    cross-attention ones: one of ``ATTN_RULES``, ``attention_rule``), the
    feed-forward hidden dim, the vocabulary (embedding rows, head
    columns), the experts' hidden dim, the Mamba2 heads (``mamba``), the
    mLSTM heads (``mlstm``) and the sLSTM channels (``slstm``).  A part
    that does not divide runs whole on every model rank, with no
    collective."""

    size: int
    attn: str
    ffn: bool
    vocab: bool
    moe: bool = False
    mamba: bool = False
    mlstm: bool = False
    slstm: bool = False
    xattn: str = "whole"

    def splits(self, family: str) -> bool:
        """Whether the plan splits ``family``'s blocks over 'model'."""
        value = getattr(self, family)
        return value != "whole" if isinstance(value, str) else value


def tp_plan(cfg: ArchConfig, mesh, *, seq_over_model: bool = False,
            cached: bool = False, force_attn: str | None = None) -> TPPlan:
    """The tensor-parallel plan of ``cfg`` on ``mesh``'s 'model' axis.
    ``seq_over_model``: the decode caches hold their sequence over
    'model' (``cache_specs``), so every model rank needs every q head for
    its block of rows and the self-attention blocks run whole.
    ``cached``: the plan of a path whose self-attention reads K/V caches
    (serving, a decode cell), where the "head_dim" rule applies; a
    full-sequence forward with no cache (the training step, a prefill
    cell) runs such a block whole.  ``force_attn``: the self-attention
    rule to use whatever the head counts say (tests, and the size-1
    paths on one card); forcing "head_dim" on an arch with q/k-norm
    raises ``NotImplementedError`` (no arch of the registry has both)."""
    m = dict(mesh.shape).get("model", 1)
    kinds = set(cfg.layer_kinds())
    split_ff = bool(cfg.d_ff) and cfg.d_ff % m == 0
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, m)
    if force_attn is not None and force_attn not in ATTN_RULES:
        raise ValueError(f"unknown attention rule {force_attn!r}")
    if force_attn == "head_dim" and cfg.qk_norm:
        raise NotImplementedError(
            f"{cfg.name}: the head_dim attention split under q/k-norm "
            f"(the norm would need its sum of squares over 'model')")
    attn = "whole"
    if kinds & {"attn", "shared_attn"} and not seq_over_model:
        attn = force_attn or attention_rule(*heads, cached=cached,
                                            qk_norm=cfg.qk_norm)
    return TPPlan(
        size=m,
        attn=attn,
        ffn=split_ff,
        vocab=cfg.vocab_size % m == 0,
        moe=split_ff and bool(cfg.n_experts),
        mamba="mamba2" in kinds and cfg.ssm_heads % m == 0,
        mlstm="mlstm" in kinds and cfg.ssm_heads % m == 0,
        slstm="slstm" in kinds and cfg.d_inner % m == 0,
        xattn=attention_rule(*heads, cached=False)
        if "cross_attn" in kinds else "whole")


def tensor_parallel(cfg: ArchConfig, mesh, **kw):
    """This rank's ``models.flags.TensorParallel`` on ``mesh``'s 'model'
    axis: the plan's flags, the model group and this rank's index."""
    from ..models import flags

    plan = tp_plan(cfg, mesh, **kw)
    return flags.TensorParallel(
        mesh.groups["model"], plan.size, mesh.coord("model"),
        **{f.name: getattr(plan, f.name)
           for f in dataclasses.fields(TPPlan) if f.name != "size"})


@dataclasses.dataclass(frozen=True)
class Grouped:
    """A spec entry for a dim cut into ``blocks`` blocks over ``axis``
    whose extent is a multiple of ``blocks``: rank i of the axis holds
    block ``i · blocks // extent``, replicated over the extent / blocks
    ranks of its group (a "kv_shared" cache's one kv head)."""

    axis: str
    blocks: int


def _kv_entries(cfg: ArchConfig, plan) -> tuple[Any, Any]:
    """(heads entry, head-dim entry) of a K/V cache under ``plan``'s
    self-attention rule: this rank's kv heads ("split"), the one kv head
    its q heads read ("kv_shared"), its rotary-paired block of every
    head's dims ("head_dim"), or all of it ("whole")."""
    d = cfg.head_dim_
    return {"split": ("model", None),
            "kv_shared": (Grouped("model", cfg.n_kv_heads), None),
            "head_dim": (None, Segments("model", (d // 2, d // 2),
                                        (True, True))),
            "whole": (None, None)}[plan.attn]


@dataclasses.dataclass(frozen=True)
class Segments:
    """A spec entry for a dim made of consecutive segments (the columns
    of a concatenated projection): segment i has ``sizes[i]`` entries and
    is split over ``axis`` where ``split[i]``, replicated otherwise.  A
    rank's block is its block of every split segment and the whole of
    every other, in order (``local_shard``)."""

    axis: str
    sizes: tuple
    split: tuple

    def local_sizes(self, n: int) -> tuple:
        return tuple(s // n if sp else s
                     for s, sp in zip(self.sizes, self.split, strict=True))


def _segments(cfg: ArchConfig, leaf: str) -> Segments | None:
    """The segment layout of a block leaf whose dim concatenates parts
    that split differently (or each on its own) over 'model'."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    if leaf == "mamba/in_proj/w":          # z, x, B, C, dt
        return Segments("model", (di, di, n, n, h),
                        (True, True, False, False, True))
    if leaf in ("mamba/conv_w", "mamba/conv_b"):   # x, B, C
        return Segments("model", (di, n, n), (True, False, False))
    if leaf == "mlstm/w_if/w":             # i and f, one column a head
        return Segments("model", (h, h), (True, True))
    if leaf == "slstm/w_zifo/w":           # z, i, f, o
        return Segments("model", (di,) * 4, (True,) * 4)
    return None


# A block's leaves by family; each family is its plan flag's name.
_BLOCK = re.compile(r"(?:^|/)(attn|xattn|mamba|mlstm|slstm)/(.+)$")
_HEAD_VECTORS = ("a_log", "dt_bias", "d_skip")


def _tp_spec(cfg: ArchConfig, plan: TPPlan, path: str, spec: tuple,
             shape: tuple) -> tuple:
    """A leaf's spec of ``param_specs`` laid out for the port's
    hand-written tensor parallelism: a block whose plan flag is false,
    and the zamba2 ``proj`` of a ``shared_attn`` layer, keep 'model' out
    of their leaves; a split block's concatenated projections split by
    segments (``_segments``) and the Mamba2 per-head vectors by heads."""
    if re.search(r"^layers/\d+/proj/w$", path):
        return _drop_model(spec)
    m = _BLOCK.search(path)
    if m is None:
        return spec
    family, leaf = m.group(1), m.group(1) + "/" + m.group(2)
    if not plan.splits(family):
        return _drop_model(spec)
    if plan.size == 1:
        return spec
    if family == "attn" and plan.attn == "head_dim":
        return _head_dim_spec(cfg, m.group(2), spec)
    seg = _segments(cfg, leaf)
    if seg is not None:
        return tuple(spec[:-1]) + (seg,) if len(spec) == len(shape) \
            else (None,) * (len(shape) - 1) + (seg,)
    if family == "mamba" and m.group(2) in _HEAD_VECTORS:
        return ("model",)
    return spec


def _head_dim_spec(cfg: ArchConfig, leaf: str, spec: tuple) -> tuple:
    """A "head_dim" attention leaf's spec: the 'model' entry of ``wq`` /
    ``wk`` / ``wv`` (columns, and biases) and of ``wo`` (rows) becomes one
    segment per half of every head, each split over 'model', so that a
    rank holds the same block of both halves of every head (dim i and
    its rotary partner i + D / 2, ``models/common.py``'s rotate-half)."""
    heads = cfg.n_kv_heads if leaf.startswith(("wk/", "wv/")) \
        else cfg.n_heads
    half = cfg.head_dim_ // 2
    seg = Segments("model", (half,) * (2 * heads), (True,) * (2 * heads))
    return tuple(seg if a == "model" else a for a in spec)


def _laid_out(cfg: ArchConfig, params: Any, specs: Any,
              plan: TPPlan) -> Any:
    return tree.unflatten(params, [
        _tp_spec(cfg, plan, _path_str(path), spec, tuple(leaf.shape))
        for (path, leaf), spec in zip(tree.with_paths(params),
                                      spec_leaves(specs), strict=True)])


def serve_param_specs(cfg: ArchConfig, params: Any, mesh, *,
                      seq_over_model: bool = False,
                      force_attn: str | None = None) -> Any:
    """The specs mesh serving slices the weights by: ``param_specs`` with
    'data' dropped (each replica holds a full TP copy), laid out by
    ``_tp_spec``: every leaf of a block the plan (``tp_plan``, of a
    cached path) leaves whole is whole on every rank."""
    plan = tp_plan(cfg, mesh, seq_over_model=seq_over_model, cached=True,
                   force_attn=force_attn)
    specs = param_specs(params, mesh, drop_axes=("data",))
    return _laid_out(cfg, params, specs, plan)


def serve_shardings(cfg: ArchConfig, mesh, params, n_slots: int,
                    max_len: int) -> tuple[Any, Any]:
    """(param specs, cache specs) for mesh-sharded serving: weights
    tensor-parallel over 'model' only (``serve_param_specs``), the slot
    pool's cache specs from ``cache_specs`` (the reference's)."""
    return (serve_param_specs(cfg, params, mesh),
            cache_specs(cfg, mesh, n_slots, max_len))


def cache_seq_axis(cfg: ArchConfig, mesh, global_batch: int,
                   cache_len: int, *, seq_over_model: bool = False
                   ) -> str | None:
    """The mesh axis ``cache_specs`` puts the K/V caches' sequence on
    ('data' when the batch does not split over the data axes, 'model'
    under ``seq_over_model``), or None."""
    for spec in cache_specs(cfg, mesh, global_batch, cache_len,
                            seq_over_model=seq_over_model):
        if spec is not None and "k" in spec:
            return spec["k"][2]
    return None


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
        if isinstance(ax, Segments):
            out = _segment_block(out, dim, ax, mesh)
            continue
        if isinstance(ax, Grouped):
            n = mesh.shape[ax.axis]
            out = out.chunk(ax.blocks, dim=dim)[
                mesh.coord(ax.axis) * ax.blocks // n]
            continue
        n, idx = _axis_index(mesh, ax)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"into {n} blocks ({spec})")
        out = out.chunk(n, dim=dim)[idx]
    return out


def _segment_block(t: torch.Tensor, dim: int, seg: Segments, mesh
                   ) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` under ``seg``."""
    if sum(seg.sizes) != t.shape[dim]:
        raise ValueError(f"segments {seg.sizes} do not cover dim {dim} of "
                         f"{tuple(t.shape)}")
    n, idx = _axis_index(mesh, seg.axis)
    pieces = []
    for piece, split in zip(t.split(list(seg.sizes), dim=dim), seg.split,
                            strict=True):
        if split and n > 1:
            if piece.shape[dim] % n:
                raise ValueError(f"a segment of {piece.shape[dim]} does "
                                 f"not split into {n} blocks")
            piece = piece.chunk(n, dim=dim)[idx]
        pieces.append(piece)
    return torch.cat(pieces, dim=dim)


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


def train_param_specs(cfg: ArchConfig, params: Any, mesh, *,
                      seq_over_model: bool = False, cached: bool = False,
                      moe_ff2d: bool = False) -> Any:
    """The specs the sharded train step holds the parameters by:
    ``param_specs`` (FSDP over 'data', tensor parallelism over 'model'),
    laid out by ``_tp_spec``: a block whose heads or channels do not
    split (``tp_plan``) keeps 'model' out of its leaves' specs and runs
    whole on every model rank, 'data' still splitting them (GSPMD would
    split a head's dims instead); a split block's concatenated
    projections split by segments.  ``seq_over_model`` and ``cached``:
    ``tp_plan``'s (a decode cell over FSDP weights is cached).
    ``moe_ff2d``: the weight-stationary expert rules (the experts' hidden
    dim over ('data', 'model'), d whole)."""
    plan = tp_plan(cfg, mesh, seq_over_model=seq_over_model, cached=cached)
    return _laid_out(cfg, params, param_specs(params, mesh,
                                              moe_ff2d=moe_ff2d), plan)


def split_axes(spec: tuple, mesh) -> tuple[str, ...]:
    """The axes of extent above 1 that ``spec`` splits its leaf over (a
    ``Segments`` entry: its axis, where a segment splits)."""
    axes: list[str] = []
    for ax in spec:
        if isinstance(ax, Segments):
            ax = ax.axis if any(ax.split) else None
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None and mesh.shape.get(a, 1) > 1:
                axes.append(a)
    return tuple(axes)


def split_parts(block: torch.Tensor, spec: tuple, mesh
                ) -> list[tuple[torch.Tensor, tuple[str, ...]]]:
    """A rank's ``block`` of a leaf as (part, the axes the part is split
    over): the block itself with ``split_axes``, or, under a
    ``Segments`` entry, its split segments and its replicated ones apart
    (a replicated segment is the same on every rank of the axis)."""
    for dim, ax in enumerate(spec):
        if not isinstance(ax, Segments) or mesh.shape.get(ax.axis, 1) == 1:
            continue
        rest = tuple(a for i, a in enumerate(spec) if i != dim)
        other = split_axes(rest, mesh)
        pieces = block.split(list(ax.local_sizes(mesh.shape[ax.axis])),
                             dim=dim)
        out = []
        for piece, split in zip(pieces, ax.split, strict=True):
            out.append((piece, other + ((ax.axis,) if split else ())))
        return out
    return [(block, split_axes(spec, mesh))]


def grad_reduction(spec: tuple, mesh) -> tuple[tuple[str, str], ...]:
    """How the sharded step syncs the gradient of a leaf held by
    ``spec``, as (collective, axis) pairs in order: a leaf split over
    'data' alone is reduce-scattered over it (the FSDP gather's
    backward), one replicated over 'data' all-reduced, and a
    weight-stationary expert leaf (its hidden dim over ('data',
    'model'), ``moe_ff2d``) not reduced over 'data' at all: its rank
    computed its slice's gradient from every data rank's tokens, which
    the dispatch buffer's gather brought (``models/moe.py``); then every
    leaf is all-reduced over 'pod'.  Nothing is reduced over 'model'
    here: each model rank computes its own block, or all of a replicated
    leaf's gradient; what a rank holds only part of is summed by *f* in
    the forward (the Mamba2 B/C columns, ``models/mamba2.py``; the q/k-
    norm gains of split heads; under sequence parallelism every norm's
    gain, since a rank's norms read its rows alone, ``models/lm.py``).
    Every sum is then divided by the batch ranks' count (the mean)."""
    out = []
    if "data" in mesh.shape:
        if "data" in spec:
            out.append(("reduce-scatter", "data"))
        elif not any(isinstance(a, tuple) and "data" in a for a in spec):
            out.append(("all-reduce", "data"))
    if "pod" in mesh.shape:
        out.append(("all-reduce", "pod"))
    return tuple(out)
