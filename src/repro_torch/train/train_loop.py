"""Training step with acc-planned gradient-accumulation microbatching
(the counterpart of ``repro.train.train_loop``).

The global batch is the workload and one microbatch one chunk:
``autotune.choose_plan`` applies the paper's Eq. 10 to pick how many
microbatches a step is split into.  ``make_train_step`` builds
``(params, opt_state, batch) -> (params, opt_state, metrics)``; the
parameters and the optimizer state are updated in place
(``optim.adamw``) and returned.  The step reads nothing back to the
host: the loss and the gradient norm in ``metrics`` are 0-d device
tensors.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import tree
from ..configs.base import ArchConfig
from ..models import lm
from ..optim import adamw


def make_loss_fn(cfg: ArchConfig, *, attn_impl: str = "chunked",
                 remat: bool = True) -> Callable:
    def loss(params, batch):
        return lm.loss_fn(params, batch, cfg, attn_impl=attn_impl,
                          remat=remat)
    return loss


def _trainable(params) -> tuple[list[torch.Tensor], dict]:
    """Leaves that require grad, sharing the parameters' storage, and the
    parameter tree over them: the step differentiates with respect to
    these, and the optimizer then writes the parameters in place."""
    flat = [p.detach().requires_grad_() for p in tree.leaves(params)]
    return flat, tree.unflatten(params, flat)


def _grad(loss: torch.Tensor, flat: list[torch.Tensor]) -> list:
    """d loss / d each leaf; a leaf the loss does not read (zamba2's
    ``shared_attn`` layers keep an ``ln1`` that, as in the reference,
    nothing reads) gets zeros, as ``jax.grad`` gives it."""
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(flat, grads, strict=True)]


def loss_and_grads(loss_fn: Callable, params, batch: dict, accum: int,
                   accum_dtype: torch.dtype
                   ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """(loss, the gradient of every leaf of ``params`` in ``tree``'s
    order): over the whole batch, or as the mean of ``accum``
    microbatches (the batch's rows cut in ``accum`` contiguous parts, in
    order), their gradients summed in ``accum_dtype``."""
    flat, tparams = _trainable(params)
    if accum <= 1:
        loss = loss_fn(tparams, batch)
        return loss.detach(), _grad(loss, flat)
    # `accum` microbatches (chunks) in order, gradients summed in
    # `accum_dtype` (f32 default; bf16 halves the buffer).
    b = batch["tokens"].shape[0]
    if b % accum:
        raise ValueError(f"batch {b} does not split into {accum} "
                         f"microbatches")
    micro = [dict(zip(batch, parts)) for parts in
             zip(*(t.chunk(accum) for t in batch.values()))]
    loss = torch.zeros((), dtype=torch.float32,
                       device=batch["tokens"].device)
    g_acc = [torch.zeros_like(p, dtype=accum_dtype) for p in flat]
    for mb in micro:
        l_mb = loss_fn(tparams, mb)
        g = _grad(l_mb, flat)
        torch._foreach_add_(g_acc, [x.to(accum_dtype) for x in g])
        loss = loss + l_mb.detach()
    return loss / accum, torch._foreach_div([x.float() for x in g_acc],
                                            accum)


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig, *,
                    accum: int = 1, attn_impl: str = "chunked",
                    remat: bool = True, lr_fn: Callable | None = None,
                    accum_dtype: str = "float32") -> Callable:
    loss_fn = make_loss_fn(cfg, attn_impl=attn_impl, remat=remat)
    adt = getattr(torch, accum_dtype)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(loss_fn, params, batch, accum, adt)
        lr = lr_fn(opt_state["step"]) if lr_fn is not None else None
        params, opt_state, metrics = adamw.update(
            tree.unflatten(params, list(grads)), opt_state, params, opt_cfg,
            lr=lr)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def make_eval_step(cfg: ArchConfig, *, attn_impl: str = "chunked"
                   ) -> Callable:
    loss_fn = make_loss_fn(cfg, attn_impl=attn_impl, remat=False)

    @torch.no_grad()
    def eval_step(params, batch):
        return loss_fn(params, batch)

    return eval_step
