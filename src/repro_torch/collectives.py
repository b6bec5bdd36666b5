"""Collectives shared by the port's layers (models, serving, training,
the algorithms), below ``launch``, which builds the meshes whose process
groups they run over.

Every collective of the port goes through this module, so that a cost
count sees it: while a sink is listed in ``collective_sinks``
(``analysis/roofline.count_costs``), each call reports its kind (the
reference's HLO names: "all-reduce", "all-gather", "reduce-scatter",
"all-to-all", "collective-permute", and "broadcast"), the bytes of its
result buffer (what the reference's ``collective_bytes`` reads off the
partitioned HLO) and the size of its group.

The differentiable ones carry the tensor-parallel and FSDP training
step (``models/common.py``, ``models/lm.py``, ``models/moe.py``):

* ``copy_to_model`` (Megatron's *f*): identity forward, ``all_reduce``
  of the gradient over the model group backward — on the input of every
  column-parallel product, whose ranks each hold part of the input's
  gradient;
* ``reduce_from_model`` (*g*): ``all_reduce`` forward, identity
  backward — on the output of every row-parallel product;
* ``gather_last``: the ``all_gather`` of the last dim forward, this
  rank's slice backward — the vocabulary-parallel logits;
* ``fsdp_gather``: a leaf's 'data' blocks gathered forward, the
  gradient ``reduce_scatter``-ed (summed) backward; the same pair
  (``gather_rows``) gathers the K/V columns of a ``"kv_shared"``
  attention block over 'model' and the weight-stationary experts'
  dispatch buffer over 'data';
* ``scatter_rows_sum``: ``reduce_scatter`` forward (this rank's block
  of the sum), ``all_gather`` of the gradient backward — the
  weight-stationary experts' partial output back to its rows;
* under sequence parallelism (Megatron-SP, ``models/common.py``):
  ``gather_seq`` (ḡ: the residual rows of every model rank gathered on
  the sequence dim; the gradient reduce-scattered, or, for a reader
  that runs whole, this rank's rows of it), ``scatter_seq_sum`` (the
  row-parallel sum reduce-scattered on the sequence dim, in place of
  *g*; backward ``all_gather``) and ``keep_seq`` (this rank's rows of a
  whole block's output; backward ``all_gather``);
* ``sum_over``: ``all_reduce`` forward and backward — a sum over the
  batch ranks inside the loss (the MoE aux loss's global means), whose
  every rank's loss reads it: the step sums the ranks' gradients, so
  each rank's share is the sum of every rank's.

Each enters its collective only where autograd records the call; with no
grad (serving) the plain collective runs, in place where it was, so the
serve path's bits and its captured graphs are as they were.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

# Active collective counts: each is called with (kind, result bytes,
# group size) once per collective while it is listed.
collective_sinks: list[Callable[[str, int, int], None]] = []


def _note(kind: str, t: torch.Tensor, group) -> None:
    if collective_sinks:
        nbytes = t.numel() * t.element_size()
        size = dist.get_world_size(group)
        for sink in list(collective_sinks):
            sink(kind, nbytes, size)


# ---------------------------------------------------------------------------
# plain collectives
# ---------------------------------------------------------------------------

def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group``, in place; returns ``t``."""
    _note("all-reduce", t, group)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """Every rank's ``t`` of ``group`` into ``out``, concatenated along
    dim 0 in rank order: ``dist.all_gather_single`` where this PyTorch
    has it, else its older name ``all_gather_into_tensor``."""
    _note("all-gather", out, group)
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, t, group=group)


def reduce_scatter_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """The sum over ``group`` of ``t``'s dim-0 block ``rank`` into
    ``out`` (``dist.reduce_scatter_single``, or its older name)."""
    _note("reduce-scatter", out, group)
    scatter = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    scatter(out, t, group=group)


def all_to_all_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    _note("all-to-all", out, group)
    dist.all_to_all_single(out, t, group=group)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    _note("broadcast", t, group)
    dist.broadcast(t, src=src, group=group)
    return t


def send_recv(send: torch.Tensor, dst: int, recv: torch.Tensor, src: int,
              group) -> None:
    """``send`` to global rank ``dst`` and ``recv`` from ``src`` in one
    batch (the reference's ``ppermute``)."""
    _note("collective-permute", recv, group)
    ops = [dist.P2POp(dist.isend, send, dst, group=group),
           dist.P2POp(dist.irecv, recv, src, group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def gather_dim(t: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim`` in rank
    order (one ``all_gather``; a copy when ``dim`` is not 0)."""
    t = t.contiguous()
    out = torch.empty((size * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    all_gather_into(out, t, group)
    if dim == 0 or size == 1:
        return out
    return torch.cat(out.chunk(size), dim=dim)


def gather_stack(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` stacked along a new dim 0 in rank
    order (one ``all_gather``): the blocks of a sequence-split decode's
    attention and softmax statistics, which ``models/attention.
    merge_blocks`` merges."""
    return gather_dim(t, group, size, 0).view((size,) + tuple(t.shape))


def scatter_dim(t: torch.Tensor, group, size: int, dim: int
                ) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``group`` of
    ``t`` (one ``reduce_scatter``)."""
    if dim != 0:
        t = torch.cat(t.chunk(size, dim=dim), dim=0)
    t = t.contiguous()
    out = torch.empty((t.shape[0] // size,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    reduce_scatter_into(out, t, group)
    return out


# ---------------------------------------------------------------------------
# differentiable collectives (the module docstring)
# ---------------------------------------------------------------------------

def _records(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.clone(memory_format=torch.contiguous_format),
                          ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.clone(), ctx.group), None


class _ScatterDim(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward; backward, the gradient's
    blocks gathered along ``dim``."""

    @staticmethod
    def forward(ctx, x, group, size, dim):
        ctx.group, ctx.size, ctx.dim = group, size, dim
        return scatter_dim(x, group, size, dim)

    @staticmethod
    def backward(ctx, dy):
        return gather_dim(dy, ctx.group, ctx.size, ctx.dim), None, None, None


class _KeepBlock(torch.autograd.Function):
    """This rank's block along ``dim`` forward (no collective); backward,
    every rank's gradient block gathered along ``dim``."""

    @staticmethod
    def forward(ctx, x, group, size, index, dim):
        ctx.group, ctx.size, ctx.dim = group, size, dim
        return x.chunk(size, dim=dim)[index].contiguous()

    @staticmethod
    def backward(ctx, dy):
        return (gather_dim(dy, ctx.group, ctx.size, ctx.dim), None, None,
                None, None)


class _GatherDim(torch.autograd.Function):
    """Gather along ``dim`` forward; backward: this rank's block of the
    gradient (``reduce`` False) or its block of the sum over the group
    (``reduce`` True, the FSDP gather)."""

    @staticmethod
    def forward(ctx, x, group, size, index, dim, reduce):
        ctx.group, ctx.size, ctx.index = group, size, index
        ctx.dim, ctx.reduce = dim, reduce
        return gather_dim(x, group, size, dim)

    @staticmethod
    def backward(ctx, dy):
        if ctx.reduce:
            dx = scatter_dim(dy, ctx.group, ctx.size, ctx.dim)
        else:
            dx = dy.chunk(ctx.size, dim=ctx.dim)[ctx.index]
        return dx, None, None, None, None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """*f*: ``x`` itself; its gradient summed over ``group``."""
    return _CopyToModel.apply(x, group) if _records(x) else x


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """*g*: ``x`` summed over ``group`` (in place with no grad); its
    gradient passed through."""
    if _records(x):
        return _ReduceFromModel.apply(x, group)
    return all_reduce(x, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` into a new tensor; its gradient summed
    over ``group`` too."""
    if _records(x):
        return _SumOver.apply(x, group)
    return all_reduce(x.clone(), group)


def gather_last(x: torch.Tensor, group, size: int, index: int
                ) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along the last dim;
    backward, this rank's slice."""
    dim = x.dim() - 1
    if _records(x):
        return _GatherDim.apply(x, group, size, index, dim, False)
    return gather_dim(x, group, size, dim)


def gather_rows(x: torch.Tensor, group, size: int, index: int, dim: int
                ) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim``;
    backward, the gradient's block ``index`` summed over the group."""
    if _records(x):
        return _GatherDim.apply(x, group, size, index, dim, True)
    return gather_dim(x, group, size, dim)


# A leaf's 'data' blocks, gathered where the FSDP step reads it.
fsdp_gather = gather_rows


def scatter_rows_sum(x: torch.Tensor, group, size: int, dim: int
                     ) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over ``group``
    (one ``reduce_scatter``); backward, the gradient's blocks gathered."""
    if _records(x):
        return _ScatterDim.apply(x, group, size, dim)
    return scatter_dim(x, group, size, dim)


def gather_seq(x: torch.Tensor, group, size: int, index: int, *,
               reduce: bool = True) -> torch.Tensor:
    """SP's ḡ: the model ranks' rows of ``x`` (B, S/n, ...) gathered on
    the sequence dim (1) in rank order.  Backward: with ``reduce`` the
    gradient reduce-scattered (its readers are column-parallel: each rank
    holds part of it), else this rank's rows of it (a reader that runs
    whole on every rank, whose gradient each rank holds complete)."""
    if _records(x):
        return _GatherDim.apply(x, group, size, index, 1, reduce)
    return gather_dim(x, group, size, 1)


def scatter_seq_sum(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """SP's row-parallel sum: this rank's rows (dim 1) of the sum of
    ``x`` over ``group``, one ``reduce_scatter``; backward ``all_gather``
    (in place of *g*)."""
    return scatter_rows_sum(x, group, size, 1)


def keep_seq(x: torch.Tensor, group, size: int, index: int
             ) -> torch.Tensor:
    """This rank's rows (dim 1) of ``x``, which every model rank computed
    whole; backward, the ranks' row gradients gathered, so that the whole
    computation sees all of its gradient on every rank."""
    if _records(x):
        return _KeepBlock.apply(x, group, size, index, 1)
    return x.chunk(size, dim=1)[index].contiguous()
