"""Chunked gated linear attention, the engine of the Mamba2 (SSD) block
(the counterpart of ``repro.models.gla``).

    y_i = sum_{j<=i} (q_i · k_j) * exp(cum_i - cum_j + g_j) * v_j
    cum = inclusive cumsum of the per-step log-decay

computed chunk-parallel in f32: an intra-chunk quadratic term plus an
inter-chunk state S (B, H, N, P) carried chunk by chunk (the reference's
``lax.scan``; here a Python loop over chunks).  A per-chunk max keeps the
exponentials in f32 range; chunks of 64 bound the underflow of the
decayed queries.

``gla_step`` is the O(1) recurrent step of one token, which the serve
path runs token by token, as the reference does.  Plain PyTorch: the
reference's GLA is plain ``jnp`` and reaches no Pallas kernel.
"""
from __future__ import annotations

import torch

DEFAULT_CHUNK = 64


def chunked_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor,
                log_gain: torch.Tensor | None = None, *,
                chunk: int = DEFAULT_CHUNK,
                initial_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k: (B, L, H, N); v: (B, L, H, P); log_decay / log_gain: (B, L,
    H); L a multiple of ``chunk``.  Returns (y (B, L, H, P) f32, the final
    state (B, H, N, P) f32)."""
    b, length, h, n = q.shape
    p = v.shape[-1]
    if length % chunk:
        raise ValueError(f"sequence length {length} is not a multiple of "
                         f"the chunk {chunk}")
    nc = length // chunk

    qf = q.float().reshape(b, nc, chunk, h, n)
    kf = k.float().reshape(b, nc, chunk, h, n)
    vf = v.float().reshape(b, nc, chunk, h, p)
    ld = log_decay.float().reshape(b, nc, chunk, h)
    g = torch.zeros_like(ld) if log_gain is None \
        else log_gain.float().reshape(b, nc, chunk, h)

    lcum = torch.cumsum(ld, dim=2)                 # within-chunk cumsum
    total = lcum[:, :, -1, :]                      # (b, nc, h)
    a = g - lcum                                   # the source exponent
    m = a.amax(dim=2, keepdim=True).detach()       # (b, nc, 1, h)
    ks = kf * torch.exp(a - m)[..., None]          # stabilised keys
    qd = qf * torch.exp(lcum)[..., None]           # decayed queries

    # intra-chunk: att[i, j] = qd_i · ks_j for i >= j, times exp(m)
    att = torch.einsum("bcihn,bcjhn->bchij", qd, ks)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=q.device))
    att = torch.where(mask, att, torch.zeros((), device=q.device))
    y_intra = torch.einsum("bchij,bcjhp->bcihp", att, vf) \
        * torch.exp(m)[..., None]

    # each chunk's own end state: exp(total + m) * sum_j ks_j ⊗ v_j
    s_loc = torch.einsum("bcjhn,bcjhp->bchnp", ks, vf) \
        * torch.exp(total + m[:, :, 0, :])[..., None, None]

    # across chunks: S_c = exp(total_c) * S_{c-1} + S_loc_c
    decay_c = torch.exp(total)                     # (b, nc, h)
    s = torch.zeros((b, h, n, p), dtype=torch.float32, device=q.device) \
        if initial_state is None else initial_state.float()
    prevs = []
    for c in range(nc):
        prevs.append(s)
        s = s * decay_c[:, c, :, None, None] + s_loc[:, c]
    s_prevs = torch.stack(prevs, dim=1)            # (b, nc, h, n, p)

    # inter-chunk: y_i += exp(lcum_i) * q_i · S_{c-1}
    y_inter = torch.einsum("bcihn,bchnp->bcihp", qd, s_prevs)
    return (y_intra + y_inter).reshape(b, length, h, p), s


def gla_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_decay: torch.Tensor, log_gain: torch.Tensor | None,
             state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One token: q, k (B, H, N); v (B, H, P); log_decay / log_gain (B,
    H); state (B, H, N, P) f32.  Returns (y (B, H, P), the new state)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    ld = log_decay.float()
    gain = torch.zeros_like(ld) if log_gain is None else log_gain.float()
    s_new = state * torch.exp(ld)[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", kf * torch.exp(gain)[..., None], vf)
    y = torch.einsum("bhn,bhnp->bhp", qf, s_new)
    return y, s_new


def gla_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_decay: torch.Tensor,
                  log_gain: torch.Tensor | None = None) -> torch.Tensor:
    """The O(L²) oracle, for tests."""
    length = q.shape[1]
    cum = torch.cumsum(log_decay.float(), dim=1)
    g = torch.zeros_like(cum) if log_gain is None else log_gain.float()
    w = cum[:, :, None, :] - cum[:, None, :, :] + g[:, None, :, :]
    mask = torch.tril(torch.ones(length, length, dtype=torch.bool,
                                 device=q.device))
    w = torch.where(mask[None, :, :, None], torch.exp(w),
                    torch.zeros((), device=q.device))
    att = torch.einsum("bihn,bjhn->bijh", q.float(), k.float()) * w
    return torch.einsum("bijh,bjhp->bihp", att, v.float())
