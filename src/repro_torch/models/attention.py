"""Self-attention with a KV cache (the counterpart of
``repro.models.attention.self_attention`` and ``_cache_attention``).

The cache is updated in place: the new K/V rows are written at their
positions and attention runs over the cache through a flash-attention
kernel (``kernels/flash_attention.py``).  Two cache layouts:

* contiguous (the slot pool): per layer ``{"k","v"}`` of shape
  ``(B, Hkv, S, D)``; attention through ``flash_attention``, whose
  per-lane ``kv_lens`` lets one call serve a prefill chunk into one slot
  and a decode step over the whole slot pool;
* paged (``PagedKVCachePool``): per layer flat token-major stores
  ``(n_pages * ps, Hkv, D)`` read through a page table; the new rows land
  with one ``index_copy_`` per store and attention runs through
  ``paged_flash_attention`` straight off the pages (no contiguous view
  is gathered).

``jax.lax.dynamic_update_slice`` clamps a write that would run past the
cache; here such a write raises instead.

Not ported yet (ROADMAP.md): the sliding-window ring cache
(``_ring_attention``), cross-attention, and the cache-free full-sequence
path (``attention_chunked``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attention import flash_attention, paged_flash_attention
from . import common as cm


@dataclasses.dataclass(frozen=True)
class CacheWrite:
    """Where one forward writes its K/V and how far each lane attends.

    ``pos`` is an int (every row writes ``L`` rows from ``pos``) or a
    (B,) long tensor of per-lane positions (lane ``b`` writes its ``L``
    rows from ``pos[b]``: the decode step with ``L == 1``, the
    speculative verify with ``L == d``); ``rows`` (with per-lane
    positions) selects the lanes that write at all (None: every lane);
    ``keep`` (R,) bool on the device, where given, drops the writes of
    lanes whose activity only the device knows — the decode graphs run
    every lane and keep only the active ones: a dropped lane's rows are
    read back and written unchanged (contiguous) or go to the scratch
    page (paged); ``kv_lens`` (B,) int32 is the attention length of each
    lane after the write.

    For a paged cache, ``page_table`` (B, n_blocks) int32 and
    ``page_size`` address the stores, and ``flat`` holds the store row of
    every written (lane, step) in that order, computed once per forward
    (``page_rows``).  For a contiguous cache with per-lane positions,
    ``lanes`` (R, 1) and ``at`` (R, L) are the written lanes and their
    positions, also computed once per forward.
    """

    pos: int | torch.Tensor
    rows: torch.Tensor | None
    kv_lens: torch.Tensor
    keep: torch.Tensor | None = None
    page_table: torch.Tensor | None = None
    page_size: int = 0
    flat: torch.Tensor | None = None
    lanes: torch.Tensor | None = None
    at: torch.Tensor | None = None


def page_rows(page_table: torch.Tensor, lanes: torch.Tensor,
              positions: torch.Tensor, page_size: int,
              keep: torch.Tensor | None = None) -> torch.Tensor:
    """Store rows of logical ``positions`` (R, L) of ``lanes`` (R,):
    ``table[lane, p // ps] * ps + p % ps``, flattened in (lane, step)
    order.  Rows of lanes with ``keep`` False go to the scratch page 0,
    which no table maps for a live position, so they write nothing that
    is ever read."""
    ps = int(page_size)
    blk = (positions // ps).clamp(max=page_table.shape[1] - 1)
    flat = page_table[lanes[:, None], blk].long() * ps + positions % ps
    if keep is not None:
        flat = torch.where(keep[:, None], flat, positions % ps)
    return flat.reshape(-1)


def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.view(b, s, n, hd)


def self_attention(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                   rope: tuple[torch.Tensor, torch.Tensor],
                   window: int | None, cache: dict,
                   write: CacheWrite) -> torch.Tensor:
    """x: (B, L, d); rope: the (cos, sin) of the positions, (B, L, D/2)
    each, computed once per forward; cache {"k","v"}: (B, Hkv, S, D),
    or the paged stores (n_pages * ps, Hkv, D) when ``write.page_table``
    is set."""
    if window is not None:
        raise NotImplementedError(
            "sliding-window (ring) KV caches are not ported yet "
            "(ROADMAP.md, remaining architectures)")
    b, length, _ = x.shape
    hd = cfg.head_dim_
    q = _heads(cm.linear(p["wq"], x), cfg.n_heads, hd)
    k = _heads(cm.linear(p["wk"], x), cfg.n_kv_heads, hd)
    v = _heads(cm.linear(p["wv"], x), cfg.n_kv_heads, hd)
    cos, sin = rope
    if cfg.qk_norm:
        q, k = cm.qk_norm_rope(p["q_norm"], p["k_norm"], q, k, cos, sin,
                               cfg.norm_eps)
    else:
        q = cm.apply_rope(q, cos, sin)
        k = cm.apply_rope(k, cos, sin)

    ck, cv = cache["k"], cache["v"]
    qt = q.transpose(1, 2).contiguous()
    if write.page_table is not None:
        # k, v are (B, L, Hkv, D): token-major, the stores' layout.
        if write.rows is not None:
            k, v = k[write.rows], v[write.rows]
        hkv = k.shape[2]
        ck.index_copy_(0, write.flat, k.reshape(-1, hkv, hd).to(ck.dtype))
        cv.index_copy_(0, write.flat, v.reshape(-1, hkv, hd).to(cv.dtype))
        out = paged_flash_attention(qt, ck, cv, write.page_table,
                                    write.kv_lens,
                                    page_size=write.page_size, causal=True)
    else:
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
            r2, at = write.lanes, write.at               # (R, 1), (R, L)
            if write.rows is not None:
                kt, vt = kt[write.rows], vt[write.rows]
            new_k = kt.transpose(1, 2)                   # (R, L, Hkv, D)
            new_v = vt.transpose(1, 2)
            if write.keep is not None:
                # Lanes the device dropped keep their old rows.
                k4 = write.keep[:, None, None, None]
                new_k = torch.where(k4, new_k, ck[r2, :, at])
                new_v = torch.where(k4, new_v, cv[r2, :, at])
            ck[r2, :, at] = new_k
            cv[r2, :, at] = new_v
        out = flash_attention(qt, ck, cv, write.kv_lens, causal=True)
    out = out.transpose(1, 2).reshape(b, length, cfg.n_heads * hd)
    return cm.linear(p["wo"], out)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               window: int | None, dtype: torch.dtype,
               device: torch.device) -> dict:
    s = min(window, max_len) if window is not None else max_len
    shape = (batch, cfg.n_kv_heads, s, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
