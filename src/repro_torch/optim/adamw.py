"""AdamW with f32 update math (the counterpart of ``repro.optim.adamw``).

The same state tree as the reference: ``m``, ``v`` (in ``moment_dtype``),
``step`` (a 0-d int32 tensor) and, with ``master_weights``, an f32
``master`` copy of the parameters; the same arithmetic, each operation
rounded in f32 in the reference's order.  Two differences of form:

* the update is **in place**: the parameter, moment and master tensors
  passed in are overwritten and returned (the reference returns new
  arrays), which keeps one copy of a 0.6B-parameter state on the card;
* the per-leaf arithmetic runs as ``torch._foreach_*`` ops over all
  leaves at once (a few dozen launches, not a dozen per leaf).

Nothing is read back to the host: the global-norm clip, the bias
correction and the learning rate stay 0-d tensors on the device, so a
train step holds under strict mode.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # bf16 moments halve the optimizer's memory; the update math stays
    # f32 (moments are cast at rest only).
    moment_dtype: str = "float32"
    # Working parameters in their own (e.g. bf16) dtype plus an f32
    # master copy in the state; the update runs on the master.
    master_weights: bool = False


def init_state(params: Any, cfg: AdamWConfig | None = None) -> dict:
    dt = getattr(torch, cfg.moment_dtype) if cfg else torch.float32
    first = tree.leaves(params)[0]
    state = {"m": tree.map_leaves(lambda p: torch.zeros_like(p, dtype=dt),
                                  params),
             "v": tree.map_leaves(lambda p: torch.zeros_like(p, dtype=dt),
                                  params),
             "step": torch.zeros((), dtype=torch.int32, device=first.device)}
    if cfg is not None and cfg.master_weights:
        state["master"] = tree.map_leaves(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    norms = torch._foreach_norm([g.float() for g in tree.leaves(grads)])
    return torch.linalg.vector_norm(torch.stack(norms))


# Leaves updated together: the update's temporaries (the new moments, the
# denominator, the step) are a few copies of the group, not of the model.
GROUP_BYTES = 1 << 30


def _groups(leaves: list[torch.Tensor]) -> list[list[int]]:
    """Leaf indices in order, cut into groups of at most ``GROUP_BYTES``
    of f32 (a larger leaf alone)."""
    groups, cur, size = [], [], 0
    for i, p in enumerate(leaves):
        if cur and size + 4 * p.numel() > GROUP_BYTES:
            groups.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += 4 * p.numel()
    return groups + ([cur] if cur else [])


@torch.no_grad()
def update(grads: Any, state: dict, params: Any, cfg: AdamWConfig,
           lr: torch.Tensor | float | None = None, *,
           grad_norm: torch.Tensor | None = None
           ) -> tuple[Any, dict, dict]:
    """One AdamW step in place.  Returns (params, state, metrics), the
    first two the objects passed in, updated; ``metrics["grad_norm"]`` is
    the pre-clip global norm (a 0-d device tensor).  The leaves are
    updated in groups of ``GROUP_BYTES`` (the same arithmetic per
    element), so the update's temporaries stay a few GB for a model of
    any size.  ``grad_norm``: the global norm, where ``grads`` are one
    rank's blocks of a sharded gradient (``train/sharded.py`` computes it
    over the ranks); by default ``global_norm(grads)``."""
    lr = cfg.lr if lr is None else lr
    step = state["step"] + 1
    p_leaves = tree.leaves(params)
    g_leaves = tree.leaves(grads)
    m_leaves, v_leaves = tree.leaves(state["m"]), tree.leaves(state["v"])
    if not len(p_leaves) == len(g_leaves) == len(m_leaves) == len(v_leaves):
        raise ValueError("params, grads and moments differ in structure")
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip else None

    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    masters = tree.leaves(state["master"]) if "master" in state else None
    for idx in _groups(p_leaves):
        ps = [p_leaves[i] for i in idx]
        ms = [m_leaves[i] for i in idx]
        vs = [v_leaves[i] for i in idx]
        gf = [g_leaves[i].float() for i in idx]
        if scale is not None:
            gf = torch._foreach_mul(gf, scale)
        m_new = torch._foreach_add(
            torch._foreach_mul([m.float() for m in ms], b1),
            torch._foreach_mul(gf, 1 - b1))
        v_new = torch._foreach_add(
            torch._foreach_mul([v.float() for v in vs], b2),
            torch._foreach_mul(torch._foreach_mul(gf, 1 - b2), gf))
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(v_new, bc2)), cfg.eps)
        delta = torch._foreach_div(torch._foreach_div(m_new, bc1), denom)
        del denom
        base = [masters[i] for i in idx] if masters is not None \
            else [p.float() for p in ps]
        delta = torch._foreach_add(delta, torch._foreach_mul(
            base, cfg.weight_decay))
        new_master = torch._foreach_sub(base, torch._foreach_mul(delta, lr))
        del delta
        torch._foreach_copy_(ps, new_master)
        torch._foreach_copy_(ms, m_new)
        torch._foreach_copy_(vs, v_new)
        if masters is not None:
            torch._foreach_copy_(base, new_master)
    new_state = dict(state, step=step)
    return params, new_state, {"grad_norm": gnorm}
