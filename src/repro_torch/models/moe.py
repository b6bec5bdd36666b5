"""Mixture-of-Experts: a top-k router with capacity-bounded dispatch (the
counterpart of ``repro.models.moe``: global and group-local dispatch).

Point for point as the reference computes it:

* the router in f32 (``x.float() @ w.float()``), softmax, top-k, the
  gate weights renormalised by their clipped sum;
* the load-balancing aux loss ``E · Σ_e mean(top-1 one-hot)_e ·
  mean(probs)_e``;
* capacity ``int(max(ceil(t·k/E)·capacity_factor, min(t, 16)))`` from
  the static token count ``t`` (pad rows and idle lanes included);
* each choice's place in its expert's buffer from the exclusive cumsum
  of the one-hot in token-major order (choice (t, c) at row t·k + c), a
  choice past the capacity sent to the trash row ``E·capacity``;
* the experts as batched products over the stacked (E, d, ff) weights
  in the compute dtype, and the combine as a gather weighted by
  ``gate_w · keep``, summed over k in the compute dtype;
* with ``flags.MOE_DISPATCH_GROUPS`` g above 1, group-local dispatch:
  the call's tokens cut into g groups in token order, each with its own
  capacity (from its own count) and places (the reference's ``vmap``).

On a training mesh (``flags.FSDP``, ``train/sharded.py``) a rank holds
its rows of the batch, which are a contiguous block of the global token
order (``train/sharded.shard_batch``).  Global dispatch then takes the
capacity from the global count, and a choice's place is its expert's
exclusive count over the global order: this rank's local cumsum plus the
choices of the lower batch ranks, which one ``all_gather`` of the
per-expert counts gives.  Each rank computes its own tokens' rows only,
in a buffer of min(capacity, local choices) rows an expert.  The aux
loss's two means are over the global tokens: their sums are summed over
the batch ranks (``collectives.sum_over``) before the product.
Group-local dispatch needs g a multiple of the batch ranks' count (each
rank's tokens form g / n groups); any other g raises ``ValueError``, as
does a token count g does not divide (the reference then falls back to
global dispatch; ROADMAP.md, Divergences).  Under tensor parallelism
(``flags.TP`` with ``moe``) the experts' hidden dim is split over
'model': the dispatched tokens go through *f*, the down product ends in
*g*; the router is replicated.

Under sequence parallelism (``flags.SP``) the block gathers every model
rank's rows first (``collectives.gather_seq``; the router runs whole on
every rank, so the backward keeps this rank's rows), so capacity and
places come from the same count as without it, and each rank keeps its
rows of the combined output (``common.keep_rows``, whose backward
gathers the rows' gradients: the router's gate weights read the
experts' summed output, so every rank needs all of the gradient).  With the weight-stationary experts (``flags.MOE_FF2D``, the
sharded step's ``moe_ff2d``) a rank holds its block of every expert's
hidden dim over ('data', 'model') and the weights are never gathered:
the dispatch buffer, this rank's rows, is gathered over 'data' in rank
order, the rank's hidden slice computes the partial outputs of every
data rank's rows, which a reduce-scatter over 'data' sums and sends back
to their rank, and *g* sums them over 'model'
(``collectives.gather_rows`` / ``scatter_rows_sum``).

The body runs inside a captured CUDA graph, so it reads nothing back to
the host and has no data-dependent shape: the one-hot is a comparison
with ``arange(E)`` (``F.one_hot`` checks its indices on the host), and
the dispatch is an ``index_copy_`` whose destinations are unique but for
the trash row, which is discarded (``index_add_``'s float atomics on the
card have no fixed order, and graphs must equal eager bit for bit).
"""
from __future__ import annotations

from typing import Any

import torch

from .. import collectives
from ..configs.base import ArchConfig
from . import common as cm
from . import flags


def capacity(t: int, cfg: ArchConfig) -> int:
    """Places per expert for ``t`` tokens: the statistical capacity,
    floored so that a batch of at most 16 tokens never drops."""
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = max(-(-t * k // e) * cfg.capacity_factor, 1.0)
    return int(max(cap, min(t, 16)))


def _batch_ranks() -> tuple[Any, int, int]:
    """(group, count, this rank's index) of the batch ranks on a
    training mesh; (None, 1, 0) elsewhere."""
    ctx = flags.FSDP
    if ctx is None or ctx.batch_size == 1:
        return None, 1, 0
    return ctx.batch, ctx.batch_size, ctx.batch_index


def route(p: dict, tokens: torch.Tensor, cfg: ArchConfig
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens (T, d) -> (gate_w (T, k) f32, gate_idx (T, k) long, aux
    0-d f32, over the batch ranks' tokens on a training mesh)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    logits = tokens.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, k, dim=-1)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp(min=1e-9)
    experts = torch.arange(e, device=tokens.device)
    assign = (gate_idx[:, :1] == experts).float()
    group, n, _ = _batch_ranks()
    if group is None:
        aux = e * torch.sum(assign.mean(0) * probs.mean(0))
    else:
        t = n * tokens.shape[0]
        sums = collectives.sum_over(
            torch.cat([assign.sum(0), probs.sum(0)]), group)
        aux = e * torch.sum((sums[:e] / t) * (sums[e:] / t))
    return gate_w, gate_idx, aux


def buffer_rows(capacity: int, n_choices: int,
                batch: tuple[Any, int, int] = (None, 1, 0)) -> int:
    """Rows an expert's dispatch buffer holds: the capacity, or on a
    training mesh at most this rank's ``n_choices``."""
    return capacity if batch[0] is None else min(capacity, n_choices)


def placement(gate_idx: torch.Tensor, cfg: ArchConfig, capacity: int,
              batch: tuple[Any, int, int] = (None, 1, 0)
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each choice's row in the (E·rows + 1, d) dispatch buffer
    (``buffer_rows``), in token-major order, and whether it was kept:
    (dest (T·k,) long, keep (T·k,) bool).  A dropped choice's row is the
    trash row.  ``batch`` (group, count, index): the batch ranks whose
    tokens precede and follow this rank's in the global order (module
    docstring)."""
    e = cfg.n_experts
    expert = gate_idx.reshape(-1)
    oh = (expert[:, None] == torch.arange(e, device=expert.device)).to(
        torch.int32)
    pos = torch.cumsum(oh, dim=0) - oh
    group, n, index = batch
    rows = buffer_rows(capacity, expert.shape[0], batch)
    if group is not None:
        counts = collectives.gather_dim(oh.sum(0)[None], group, n, 0)
        below = counts[:index].sum(0)
        # The place over the global order, then this rank's row.
        pos = pos + below[None, :]
    my_pos = (pos * oh).sum(-1)
    keep = my_pos < capacity
    if group is not None:
        my_pos = my_pos - below[expert]
    dest = torch.where(keep, expert * rows + my_pos,
                       torch.full_like(expert, e * rows))
    return dest, keep


def _dispatch_compute_combine(tokens: torch.Tensor, gate_idx: torch.Tensor,
                              gate_w: torch.Tensor, p: dict,
                              cfg: ArchConfig, capacity: int,
                              batch: tuple[Any, int, int] = (None, 1, 0)
                              ) -> torch.Tensor:
    """Capacity dispatch, the expert FFNs and the weighted combine for
    one token group: tokens (T, d) -> (T, d) in the compute dtype."""
    t, d = tokens.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cd = getattr(torch, cfg.compute_dtype)
    tp = flags.TP
    split = tp is not None and tp.moe
    dest, keep = placement(gate_idx, cfg, capacity, batch)
    rows = buffer_rows(capacity, t * k, batch)
    kept = keep[:, None].to(cd)
    # Token-major: choice (t, c) at row t·k + c.
    x = cm.column_input(tokens, split).to(cd)
    src = x[:, None, :].expand(t, k, d).reshape(t * k, d) * kept
    buf = torch.zeros((e * rows + 1, d), dtype=cd, device=tokens.device)
    buf = buf.index_copy(0, dest, src)
    dispatched = buf[:-1].view(e, rows, d)
    ff2d = flags.MOE_FF2D
    if ff2d is not None:
        # Every data rank's rows, for this rank's slice of the experts.
        dispatched = collectives.gather_rows(dispatched, ff2d.group,
                                             ff2d.size, ff2d.index, 1)

    act = cm.act_fn(cfg.act)
    up = torch.bmm(dispatched, cm._cast(p["w_up"], cd))
    if cfg.ffn_gated:
        up = act(torch.bmm(dispatched, cm._cast(p["w_gate"], cd))) * up
    else:
        up = act(up)
    eout = torch.bmm(up, cm._cast(p["w_down"], cd))
    if ff2d is not None:
        eout = collectives.scatter_rows_sum(eout, ff2d.group, ff2d.size, 1)
    if split:
        eout = collectives.reduce_from_model(eout, tp.group)

    flat = torch.cat([eout.reshape(e * rows, d),
                      torch.zeros((1, d), dtype=cd, device=tokens.device)])
    per_choice = torch.index_select(flat, 0, dest) * (
        gate_w.reshape(-1, 1).to(cd) * kept)
    return per_choice.view(t, k, d).sum(dim=1)


def _local_groups(t: int) -> int:
    """How many dispatch groups this rank's ``t`` tokens form under
    ``flags.MOE_DISPATCH_GROUPS`` (module docstring); raises
    ``ValueError`` for a count the tokens or the batch ranks do not
    fit."""
    g = int(flags.MOE_DISPATCH_GROUPS)
    _, n, _ = _batch_ranks()
    if g % n:
        raise ValueError(f"{g} MoE dispatch groups do not split over "
                         f"{n} batch ranks")
    local = g // n
    if t % local:
        raise ValueError(f"{t} tokens do not split into {local} MoE "
                         f"dispatch groups")
    return local


def apply(p: dict, x: torch.Tensor, cfg: ArchConfig
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d) in the compute dtype, aux 0-d f32).
    ``p``: ``router`` {"w" (d, E)}, ``w_up`` / ``w_gate`` (E, d, ff),
    ``w_down`` (E, ff, d) (this rank's hidden columns under tensor
    parallelism).  Under sequence parallelism ``x`` and the output hold
    this rank's rows (module docstring)."""
    sp = flags.SP
    if sp is not None:
        x = collectives.gather_seq(x, sp.group, sp.size, sp.index,
                                   reduce=False)
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    gate_w, gate_idx, aux = route(p, tokens, cfg)
    if (flags.MOE_DISPATCH_GROUPS or 1) > 1:
        g = _local_groups(t)
        tl = t // g
        cap = capacity(tl, cfg)
        out = torch.cat([
            _dispatch_compute_combine(tokens[i * tl:(i + 1) * tl],
                                      gate_idx[i * tl:(i + 1) * tl],
                                      gate_w[i * tl:(i + 1) * tl], p, cfg,
                                      cap)
            for i in range(g)])
    else:
        batch = _batch_ranks()
        args = (tokens, gate_idx, gate_w, p, cfg, capacity(batch[1] * t, cfg))
        out = _dispatch_compute_combine(*args) if batch[0] is None \
            else _dispatch_compute_combine(*args, batch=batch)
    return cm.keep_rows(out.view(b, s, d)), aux
