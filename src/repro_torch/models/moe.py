"""Mixture-of-Experts: a top-k router with capacity-bounded dispatch (the
counterpart of ``repro.models.moe``, global dispatch only).

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
  ``gate_w · keep``, summed over k in the compute dtype.

The body runs inside a captured CUDA graph, so it reads nothing back to
the host and has no data-dependent shape: the one-hot is a comparison
with ``arange(E)`` (``F.one_hot`` checks its indices on the host), and
the dispatch is an ``index_copy_`` whose destinations are unique but for
the trash row, which is discarded (``index_add_``'s float atomics on the
card have no fixed order, and graphs must equal eager bit for bit).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from . import common as cm


def capacity(t: int, cfg: ArchConfig) -> int:
    """Places per expert for ``t`` tokens: the statistical capacity,
    floored so that a batch of at most 16 tokens never drops."""
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = max(-(-t * k // e) * cfg.capacity_factor, 1.0)
    return int(max(cap, min(t, 16)))


def route(p: dict, tokens: torch.Tensor, cfg: ArchConfig
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens (T, d) -> (gate_w (T, k) f32, gate_idx (T, k) long, aux
    0-d f32)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    logits = tokens.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, k, dim=-1)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp(min=1e-9)
    experts = torch.arange(e, device=tokens.device)
    assign = (gate_idx[:, :1] == experts).float()
    aux = e * torch.sum(assign.mean(0) * probs.mean(0))
    return gate_w, gate_idx, aux


def placement(gate_idx: torch.Tensor, cfg: ArchConfig, capacity: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each choice's row in the (E·capacity + 1, d) dispatch buffer, in
    token-major order, and whether it was kept: (dest (T·k,) long, keep
    (T·k,) bool).  A dropped choice's row is the trash row."""
    e = cfg.n_experts
    expert = gate_idx.reshape(-1)
    oh = (expert[:, None] == torch.arange(e, device=expert.device)).to(
        torch.int32)
    pos = torch.cumsum(oh, dim=0) - oh
    my_pos = (pos * oh).sum(-1)
    keep = my_pos < capacity
    dest = torch.where(keep, expert * capacity + my_pos,
                       torch.full_like(expert, e * capacity))
    return dest, keep


def _dispatch_compute_combine(tokens: torch.Tensor, gate_idx: torch.Tensor,
                              gate_w: torch.Tensor, p: dict,
                              cfg: ArchConfig, capacity: int
                              ) -> torch.Tensor:
    """Capacity dispatch, the expert FFNs and the weighted combine for
    one token group: tokens (T, d) -> (T, d) in the compute dtype."""
    t, d = tokens.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cd = getattr(torch, cfg.compute_dtype)
    dest, keep = placement(gate_idx, cfg, capacity)
    kept = keep[:, None].to(cd)
    # Token-major: choice (t, c) at row t·k + c.
    src = tokens.to(cd)[:, None, :].expand(t, k, d).reshape(t * k, d) * kept
    buf = torch.zeros((e * capacity + 1, d), dtype=cd, device=tokens.device)
    buf = buf.index_copy(0, dest, src)
    dispatched = buf[:-1].view(e, capacity, d)

    act = cm.act_fn(cfg.act)
    up = torch.bmm(dispatched, cm._cast(p["w_up"], cd))
    if cfg.ffn_gated:
        up = act(torch.bmm(dispatched, cm._cast(p["w_gate"], cd))) * up
    else:
        up = act(up)
    eout = torch.bmm(up, cm._cast(p["w_down"], cd))

    flat = torch.cat([eout.reshape(e * capacity, d),
                      torch.zeros((1, d), dtype=cd, device=tokens.device)])
    per_choice = torch.index_select(flat, 0, dest) * (
        gate_w.reshape(-1, 1).to(cd) * kept)
    return per_choice.view(t, k, d).sum(dim=1)


def apply(p: dict, x: torch.Tensor, cfg: ArchConfig
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d) in the compute dtype, aux 0-d f32).
    ``p``: ``router`` {"w" (d, E)}, ``w_up`` / ``w_gate`` (E, d, ff),
    ``w_down`` (E, ff, d)."""
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    gate_w, gate_idx, aux = route(p, tokens, cfg)
    out = _dispatch_compute_combine(tokens, gate_idx, gate_w, p, cfg,
                                    capacity(tokens.shape[0], cfg))
    return out.view(b, s, d), aux
