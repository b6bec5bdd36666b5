"""Explicit data-parallel training with int8 gradient compression and
error feedback (the counterpart of ``repro.train.grad_compress``).

The plain data-parallel step would all-reduce f32 gradients; this one
makes the sync explicit so it can be compressed:

  1. local f32 grads + this rank's error-feedback buffer,
  2. per-leaf int8 quantisation (scale = max |g| over the group / 127:
     an ``all_reduce(MAX)``, the reference's ``pmax``),
  3. ``all_to_all_single`` (int8) → local reduction → requantise →
     ``all_gather`` (int8): a quantised reduce-scatter + all-gather
     ring, ~4× fewer wire bytes than an f32 all-reduce,
  4. the residual ``g - dequantised(Q(g))`` carried to the next step.

The second-stage quantisation (of the reduced sum) is not error-fed;
its error is bounded by 1/127 of the max summed gradient.

The reference runs the step under ``shard_map`` with the error feedback
and the batch sharded over the data axis; here every rank runs it
(SPMD) on its own blocks: ``ef`` leaves of shape ``(1,) + p.shape``
(the rank's row of ``init_error_feedback``'s ``(n_dev,) + p.shape``,
``launch.sharding.local_tree`` with spec ``("data",)``) and its rows of
the batch.  Params and optimizer state are replicated and stay equal on
every rank: every rank applies the same synced gradient.  Gradients come
from ``lm.loss_fn`` (kernel 1's backward on the card).

A quantisation group is a leaf of the reference's tree: the reference
stacks the layers at one position of the block pattern (one leaf over
every whole group of layers), so the port quantises those layers' leaves
together, concatenated in layer order (``_groups``), under one scale.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .. import tree
from ..collectives import all_gather_into, all_reduce, all_to_all_into
from ..configs.base import ArchConfig
from ..optim import adamw
from . import train_loop


def _quantize(g: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 values and the group-wide scale (max |g| over every rank,
    / 127, floored at 1e-12)."""
    scale = g.abs().max().float().reshape(1)
    all_reduce(scale, group, op=dist.ReduceOp.MAX)
    scale = torch.clamp(scale / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _int8_allreduce_mean(q: torch.Tensor, scale: torch.Tensor, group,
                         n_dev: int) -> torch.Tensor:
    """Quantised ring all-reduce of a flat int8 vector; the f32 mean."""
    n = q.shape[0]
    pad = (-n) % n_dev
    if pad:
        q = torch.cat([q, q.new_zeros(pad)])
    # reduce-scatter stage: rank j's i-th piece goes to rank i (int8 wire)
    shards = torch.empty_like(q)
    all_to_all_into(shards, q, group)
    local_sum = shards.reshape(n_dev, -1).to(torch.int32).sum(0)
    # requantise the reduced piece for the int8 gather stage
    s2 = local_sum.abs().max().float().reshape(1)
    all_reduce(s2, group, op=dist.ReduceOp.MAX)
    s2 = torch.clamp(s2 / 127.0, min=1e-12)
    q2 = torch.clamp(torch.round(local_sum.float() / s2), -127,
                     127).to(torch.int8)
    gathered = torch.empty(n_dev * q2.shape[0], dtype=torch.int8,
                           device=q2.device)
    all_gather_into(gathered, q2, group=group)
    out = gathered.float() * s2 * scale / n_dev
    return out[:n]


def _groups(cfg: ArchConfig, params) -> list[list[int]]:
    """Leaf indices (``tree.leaves`` order) per quantisation group: the
    leaves at one path of the layers at one pattern position, over every
    whole pattern group (the reference's stacked ``blocks/pos{i}``
    leaf); every other leaf alone."""
    period = len(cfg.block_pattern)
    stacked = (cfg.n_layers // period) * period
    groups: dict = {}
    for i, (path, _) in enumerate(tree.with_paths(params)):
        if path[0] == "layers" and path[1] < stacked:
            key = ("blocks", path[1] % period) + tuple(path[2:])
        else:
            key = path
        groups.setdefault(key, []).append(i)
    return list(groups.values())


def make_compressed_dp_train_step(cfg: ArchConfig,
                                  opt_cfg: adamw.AdamWConfig, mesh, *,
                                  axis: str = "data",
                                  attn_impl: str = "chunked",
                                  remat: bool = True) -> Callable:
    """(params, opt_state, ef, batch) → (params, opt_state, ef, metrics),
    run by every rank of ``mesh``'s ``axis`` group on its own ``ef``
    block and batch rows; params and optimizer state replicated (updated
    in place, as ``make_train_step`` does).  ``metrics["loss"]`` is the
    mean loss over the group."""
    loss_fn = train_loop.make_loss_fn(cfg, attn_impl=attn_impl, remat=remat)
    group = mesh.groups[axis]
    n_dev = mesh.shape[axis]

    def step(params, opt_state, ef, batch):
        flat, tparams = train_loop._trainable(params)
        loss = loss_fn(tparams, batch)
        grads = train_loop._grad(loss, flat)
        efs = tree.leaves(ef)
        synced: list = [None] * len(grads)
        ef_new: list = [None] * len(grads)
        for idx in _groups(cfg, params):
            g = torch.cat([(grads[i].float() + efs[i][0]).reshape(-1)
                           for i in idx])
            q, scale = _quantize(g, group)
            res = g - q.float() * scale
            mean = _int8_allreduce_mean(q, scale, group, n_dev)
            at = 0
            for i in idx:
                n = grads[i].numel()
                shape = grads[i].shape
                ef_new[i] = res[at:at + n].reshape((1,) + shape)
                synced[i] = mean[at:at + n].reshape(shape)
                at += n
        params, opt_state, metrics = adamw.update(
            tree.unflatten(params, synced), opt_state, params, opt_cfg)
        loss = loss.detach().float().reshape(1)
        all_reduce(loss, group)
        return (params, opt_state, tree.unflatten(ef, ef_new),
                dict(metrics, loss=(loss / n_dev)[0]))

    return step


def init_error_feedback(params, n_dev: int):
    """Per-rank residual buffers of the whole group: leading dim = the
    axis extent, as the reference's (take a rank's row with
    ``launch.sharding.local_tree(ef, ("data",), mesh)``)."""
    return tree.map_leaves(
        lambda p: torch.zeros((n_dev,) + tuple(p.shape), dtype=torch.float32,
                              device=p.device), params)
