"""Self-attention with a KV cache (the counterpart of
``repro.models.attention.self_attention`` and ``_cache_attention``).

The cache is updated in place: the new K/V rows are written at their
positions and attention runs over the cache through the flash-attention
kernel (``kernels/flash_attention.py``), whose per-lane ``kv_lens`` lets
one call serve a prefill chunk into one slot and a decode step over the
whole slot pool.  ``jax.lax.dynamic_update_slice`` clamps a write that
would run past the cache; here such a write raises instead.

Not ported yet (ROADMAP.md): the sliding-window ring cache
(``_ring_attention``), cross-attention, and the cache-free full-sequence
path (``attention_chunked``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attention import flash_attention
from . import common as cm


@dataclasses.dataclass(frozen=True)
class CacheWrite:
    """Where one forward writes its K/V and how far each lane attends.

    ``pos`` is an int (every row writes ``L`` rows from ``pos``) or a
    (B,) long tensor of per-lane positions (``L == 1``: the decode step);
    ``rows`` (with per-lane positions) selects the lanes that write at
    all — the host knows which decode lanes are active, so inactive
    lanes' cache rows are left untouched instead of merged back; ``kv_lens`` (B,)
    int32 is the attention length of each lane after the write.
    """

    pos: int | torch.Tensor
    rows: torch.Tensor | None
    kv_lens: torch.Tensor


def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.view(b, s, n, hd)


def self_attention(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                   rope: tuple[torch.Tensor, torch.Tensor],
                   window: int | None, cache: dict,
                   write: CacheWrite) -> torch.Tensor:
    """x: (B, L, d); rope: the (cos, sin) of the positions, (B, L, D/2)
    each, computed once per forward; cache {"k","v"}: (B, Hkv, S, D)."""
    if window is not None:
        raise NotImplementedError(
            "sliding-window (ring) KV caches are not ported yet "
            "(ROADMAP.md, remaining architectures)")
    b, length, _ = x.shape
    hd = cfg.head_dim_
    q = _heads(cm.linear(p["wq"], x), cfg.n_heads, hd)
    k = _heads(cm.linear(p["wk"], x), cfg.n_kv_heads, hd)
    v = _heads(cm.linear(p["wv"], x), cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = cm.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = cm.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    cos, sin = rope
    q = cm.apply_rope(q, cos, sin)
    k = cm.apply_rope(k, cos, sin)

    ck, cv = cache["k"], cache["v"]
    kt = k.transpose(1, 2).to(ck.dtype)        # (B, Hkv, L, D)
    vt = v.transpose(1, 2).to(cv.dtype)
    if isinstance(write.pos, int):
        if write.pos < 0 or write.pos + length > ck.shape[2]:
            raise ValueError(
                f"cache write of {length} rows at {write.pos} runs past "
                f"the cache length {ck.shape[2]}")
        ck[:, :, write.pos:write.pos + length] = kt
        cv[:, :, write.pos:write.pos + length] = vt
    else:
        if length != 1:
            raise NotImplementedError(
                "per-lane cache positions take one token per lane")
        rows = write.rows
        at = write.pos[rows]
        ck[rows, :, at] = kt[rows, :, 0]
        cv[rows, :, at] = vt[rows, :, 0]
    out = flash_attention(q.transpose(1, 2).contiguous(), ck, cv,
                                 write.kv_lens, causal=True)
    out = out.transpose(1, 2).reshape(b, length, cfg.n_heads * hd)
    return cm.linear(p["wo"], out)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               window: int | None, dtype: torch.dtype,
               device: torch.device) -> dict:
    s = min(window, max_len) if window is not None else max_len
    shape = (batch, cfg.n_kv_heads, s, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
