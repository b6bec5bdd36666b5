"""The FSDP × TP training step on a mesh of ``torch.distributed`` ranks:
the counterpart of ``jax.jit(make_train_step(...), in_shardings=...)``
with the reference's ``sharding.param_specs`` / ``opt_specs`` /
``batch_specs`` (``src/repro/launch/dryrun.py``, ``lower_train``).

GSPMD partitions the reference's one program; here every rank runs this
step on its own blocks (SPMD), and the collectives are written out:

* the parameters and the optimizer state are held by
  ``sharding.train_param_specs`` / ``opt_specs``: a leaf's 'data' blocks
  (FSDP) and 'model' blocks (tensor parallelism), each rank its own
  (``shard_train_state``);
* the batch by rows over the batch axes ('pod' and 'data'), each
  microbatch's rows split in rank order (``shard_batch``);
* the forward gathers each layer's 'data' blocks inside the layer's
  checkpoint region and runs tensor parallelism over 'model'
  (``models/lm.py``, ``models/common.py``, under ``flags.fsdp`` and
  ``flags.tensor_parallel``); the gathers' backward reduce-scatters the
  gradients of the FSDP leaves over 'data';
* every block kind splits over 'model' by its own flag of the plan
  (``sharding.tp_plan``: attention and cross-attention heads, Mamba2 and
  mLSTM heads, sLSTM channels) or runs whole; a segment of a split leaf
  that every model rank holds whole (the Mamba2 B/C columns) has its
  gradient summed over 'model' by *f* in the forward, and nowhere else;
* the gradients of the leaves replicated over 'data' are all-reduced
  over it, every gradient over 'pod', and every sum divided by the
  batch ranks' count: the mean the reference's loss takes over the
  global batch (``sharding.grad_reduction``);
* the clip norm is the norm of the whole gradient, each element counted
  once (``global_norm``), and AdamW updates each rank's blocks in place;
* ``seq_shard`` (Megatron-SP, the reference's ``--seq-shard``): the
  residual stream between blocks holds this rank's rows of the sequence
  over 'model' (``flags.sequence_parallel``; ``models/lm.py``,
  ``models/common.py``), the row-parallel sums reduce-scattered and the
  blocks' inputs gathered in place of *g* and *f*;
* ``moe_ff2d`` (the reference's ``--moe-ff2d``): the experts' hidden dim
  over ('data', 'model'), d whole (``sharding.train_param_specs(...,
  moe_ff2d=True)``), never gathered; the dispatch buffer goes to the
  weights instead (``flags.moe_ff2d``, ``models/moe.py``), and their
  gradients are whole for their slice (``sharding.grad_reduction``).

``make_train_step`` keeps the reference's signature; this step adds the
mesh.  With one rank it computes what ``make_train_step`` does, op for
op.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .. import collectives, tree
from ..configs.base import ArchConfig
from ..launch import sharding
from ..models import flags, lm
from ..optim import adamw
from . import train_loop


def _axis(mesh, axis: str) -> tuple[Any, int, int]:
    """(group, extent, this rank's index) of ``axis``; (None, 1, 0)
    where the mesh has no such axis."""
    if axis not in mesh.shape:
        return None, 1, 0
    return mesh.groups[axis], mesh.shape[axis], mesh.coord(axis)


def batch_ranks(mesh) -> tuple[Any, int, int]:
    """(group, count, this rank's index) of the ranks that hold other
    rows of the batch: 'pod' × 'data', in the reference's row order."""
    pod, n_pod, i_pod = _axis(mesh, "pod")
    data, n_data, i_data = _axis(mesh, "data")
    if pod is None:
        return data, n_data, i_data
    return mesh.groups[("pod", "data")], n_pod * n_data, \
        i_pod * n_data + i_data


def contexts(cfg: ArchConfig, mesh, specs: Any, *,
             split_at_one: bool = False, **plan
             ) -> tuple[flags.TensorParallel | None, flags.FSDPContext]:
    """The model-layer contexts of this rank on ``mesh``: tensor
    parallelism over 'model' (None at an extent of 1 unless
    ``split_at_one``; ``plan``: ``sharding.tp_plan``'s keywords) and
    FSDP over 'data', with the batch ranks."""
    m = mesh.shape.get("model", 0)
    tp = sharding.tensor_parallel(cfg, mesh, **plan) \
        if m > 1 or (m == 1 and split_at_one) else None
    data, n_data, i_data = _axis(mesh, "data")
    batch, n, idx = batch_ranks(mesh)
    return tp, flags.FSDPContext(data, n_data, i_data, specs, batch, n, idx)


def lever_contexts(cfg: ArchConfig, mesh, specs: Any, tp, *,
                   seq_shard: bool = False, moe_ff2d: bool = False
                   ) -> tuple[Any, flags.SeqParallel | None,
                              flags.FF2DContext | None]:
    """(the tensor-parallel context, the sequence-parallel one, the
    weight-stationary experts' one) of the step's levers: ``seq_shard``
    splits the residual's sequence over 'model' wherever the step runs
    tensor parallelism (``tp`` not None); ``moe_ff2d`` gathers the
    dispatch buffer over 'data' where the expert leaves' specs split
    their hidden dim over ('data', 'model') (``specs``), and where they
    fall back to whole (the hidden dim does not divide) the experts run
    whole on every rank."""
    sp = ff2d = None
    if seq_shard and tp is not None:
        sp = flags.SeqParallel(tp.group, tp.size, tp.index)
    if moe_ff2d and cfg.n_experts:
        spec = next(leaf_spec for (path, _), leaf_spec in zip(
            tree.with_paths(lm.init_params(0, cfg, device="meta")),
            sharding.spec_leaves(specs), strict=True)
            if path[-2:] == ("moe", "w_up"))
        if isinstance(spec[-1], tuple):
            data, n, i = _axis(mesh, "data")
            ff2d = flags.FF2DContext(data, n, i)
        elif tp is not None:
            tp = dataclasses.replace(tp, moe=False)
    return tp, sp, ff2d


def train_specs(cfg: ArchConfig, mesh, *, master: bool = False,
                moe_ff2d: bool = False) -> tuple[Any, dict]:
    """(parameter specs, optimizer-state specs) of ``cfg`` on ``mesh``
    (``moe_ff2d``: the weight-stationary expert rules)."""
    meta = lm.init_params(0, cfg, device="meta")
    pspec = sharding.train_param_specs(cfg, meta, mesh, moe_ff2d=moe_ff2d)
    return pspec, sharding.opt_specs(pspec, master=master)


def shard_train_state(params: Any, opt_state: dict, mesh, *,
                      cfg: ArchConfig, moe_ff2d: bool = False
                      ) -> tuple[Any, dict]:
    """This rank's blocks of the full ``params`` and ``opt_state``
    (``local_tree`` by ``train_param_specs`` / ``opt_specs``)."""
    pspec, ospec = train_specs(cfg, mesh, master="master" in opt_state,
                               moe_ff2d=moe_ff2d)
    local_opt = {k: (sharding.local_tree(v, ospec[k], mesh)
                     if k != "step" else v.clone())
                 for k, v in opt_state.items()}
    return sharding.local_tree(params, pspec, mesh), local_opt


def shard_batch(batch: dict, mesh, accum: int = 1) -> dict:
    """This rank's rows of the global ``batch``.  The reference cuts
    microbatch i as the global rows ``i·B/a … (i+1)·B/a``
    (``src/repro/train/train_loop.py``) and GSPMD splits each over the
    batch ranks; so this rank holds, of each microbatch, its r-th of
    those rows, the microbatches in order (contiguous ``B/n`` rows would
    give a microbatch other tokens, and a MoE layer other capacities and
    drops)."""
    _, n, r = batch_ranks(mesh)
    b = next(iter(batch.values())).shape[0]
    if b % (n * max(accum, 1)):
        raise ValueError(f"batch {b} does not split into {accum} "
                         f"microbatches over {n} batch ranks")
    a = max(accum, 1)
    mb, per = b // a, b // (a * n)
    rows = [i * mb + r * per + j for i in range(a) for j in range(per)]
    return {k: v[torch.tensor(rows, device=v.device)].contiguous()
            for k, v in batch.items()}


def global_norm(grads: list[torch.Tensor], specs: list, mesh
                ) -> torch.Tensor:
    """The norm of the whole gradient from this rank's blocks: each
    leaf's f32 sum of squares, summed over the axes its spec splits it
    on, so that every element counts once (a leaf replicated over
    'model' is not counted once per model rank, nor a replicated segment
    of a split leaf: ``sharding.split_parts``).  With nothing split it
    is ``adamw.global_norm``."""
    classes: dict[tuple[str, ...], list[torch.Tensor]] = {}
    for g, spec in zip(grads, specs, strict=True):
        for part, axes in sharding.split_parts(g, spec, mesh):
            classes.setdefault(axes, []).append(part)
    if set(classes) <= {()}:
        return adamw.global_norm(grads)
    total = None
    for axes, gs in classes.items():
        norms = torch._foreach_norm([g.float() for g in gs])
        sq = torch.linalg.vector_norm(torch.stack(norms)).square().reshape(1)
        for a in axes:
            collectives.all_reduce(sq, mesh.groups[a])
        total = sq if total is None else total + sq
    return total.sqrt()[0]


def make_sharded_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                            mesh, *, accum: int = 1,
                            attn_impl: str = "chunked", remat: bool = True,
                            accum_dtype: str = "float32",
                            lr_fn: Callable | None = None,
                            split_at_one: bool = False,
                            seq_shard: bool = False,
                            moe_ff2d: bool = False) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, metrics)`` run
    by every rank of ``mesh`` on its blocks (``shard_train_state``) and
    rows (``shard_batch``); the blocks are updated in place, as
    ``make_train_step`` updates whole tensors.  ``metrics["loss"]`` is
    the global batch's mean loss, ``metrics["grad_norm"]`` the whole
    gradient's norm, on every rank.  ``split_at_one``: at a 'model'
    extent of 1 the blocks still run their tensor-parallel paths, with
    one-rank collectives (the vocab gather copies the logits), which
    checks those paths on one card; off, the step pays none of them.
    ``seq_shard`` and ``moe_ff2d``: the levers of the module docstring
    (``lever_contexts``; ``shard_train_state`` with the same
    ``moe_ff2d``)."""
    pspec, _ = train_specs(cfg, mesh, moe_ff2d=moe_ff2d)
    specs = sharding.spec_leaves(pspec)
    reductions = [sharding.grad_reduction(s, mesh) for s in specs]
    tp, fsdp = contexts(cfg, mesh, pspec, split_at_one=split_at_one)
    tp, sp, ff2d = lever_contexts(cfg, mesh, pspec, tp, seq_shard=seq_shard,
                                  moe_ff2d=moe_ff2d)
    loss_fn = train_loop.make_loss_fn(cfg, attn_impl=attn_impl, remat=remat)
    adt = getattr(torch, accum_dtype)
    n = fsdp.batch_size

    def step(params, opt_state, batch):
        with flags.tensor_parallel(tp), flags.fsdp(fsdp), \
                flags.sequence_parallel(sp), flags.moe_ff2d(ff2d):
            loss, grads = train_loop.loss_and_grads(loss_fn, params, batch,
                                                    accum, adt)
        grads = list(grads)
        for g, how in zip(grads, reductions, strict=True):
            for op, axis in how:
                if op == "all-reduce":
                    collectives.all_reduce(g, mesh.groups[axis])
        if n > 1:
            torch._foreach_div_(grads, float(n))
            loss = collectives.all_reduce(loss.reshape(1).clone(),
                                          fsdp.batch)[0] / n
        gnorm = global_norm(grads, specs, mesh)
        lr = lr_fn(opt_state["step"]) if lr_fn is not None else None
        params, opt_state, metrics = adamw.update(
            tree.unflatten(params, grads), opt_state, params, opt_cfg,
            lr=lr, grad_norm=gnorm)
        return params, opt_state, dict(metrics, loss=loss)

    return step
