"""The language model: embedding → attention blocks → head (the
counterpart of ``repro.models.lm`` for the ``attn`` block kind, its
feed-forward dense or mixture-of-experts).

Two entry points, as in the reference:

* ``forward`` — full sequence (train / one-shot prefill), with
  ``loss_fn`` on top of it and ``remat`` per layer;
* ``forward_cached`` — the serve path, with per-layer KV caches.

Parameters are a plain dict: ``embed``, ``final_norm``, an optional
``lm_head`` and ``layers``, one dict per layer (the JAX package stacks
the layers over pattern groups for ``lax.scan``; here the layer loop is a
Python loop, so they are kept apart).  Weights are made once from a
seeded ``torch.Generator``, in the compute dtype for serving or in the
parameter dtype (f32 masters) for training; ``bridge.py`` loads the JAX
package's parameters instead.  A MoE layer holds ``moe`` (``router``,
kept in the parameter dtype like the norm gains, and the stacked expert
weights) in place of ``ffn``; ``forward`` sums the layers' aux losses,
which ``loss_fn`` weights in, and ``forward_cached`` drops them.

Not ported yet (ROADMAP.md A.4): the other block kinds (Mamba2, xLSTM,
shared and cross attention).
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import attention, common as cm, ffn, moe

AUX_LOSS_WEIGHT = 0.01
_PORTED_KINDS = ("attn",)
# Parameter nodes held in the parameter dtype whatever the compute dtype:
# the norm gains (``g``), which the norm computes in, and the MoE routers,
# whose f32 logits top-k ranks as the reference's do.
KEEP_PARAM_DTYPE = ("g", "router")


def check_ported(cfg: ArchConfig) -> None:
    """Raise unless every layer of ``cfg`` is a kind the port serves."""
    kinds = set(cfg.layer_kinds())
    if not kinds <= set(_PORTED_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(kinds)} are not ported yet "
            f"(ROADMAP.md, remaining architectures); the port serves "
            f"{_PORTED_KINDS} blocks")


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(seed: int, cfg: ArchConfig, *,
                device: str | torch.device = "cuda",
                dtype: torch.dtype | None = None) -> dict:
    """Random weights from ``seed`` on ``device``, in ``dtype``: the
    compute dtype by default (serving), or ``param_dtype(cfg)`` for f32
    master weights (training).  Norm gains and MoE routers are in the
    parameter dtype (a router rounded to bf16 would rank other experts
    than the reference's).  Drawn on the CPU one tensor at a time, so the
    same seed gives the same weights on every device."""
    check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    cd, pd = dtype or compute_dtype(cfg), param_dtype(cfg)

    def normal(shape, scale, dtype=cd):
        t = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
        return t.to(device=dev, dtype=dtype)

    def lin(d_in, d_out, bias=False):
        p = {"w": normal((d_in, d_out), d_in ** -0.5)}
        if bias:
            p["b"] = torch.zeros(d_out, dtype=cd, device=dev)
        return p

    def norm(d):
        return {"g": torch.ones(d, dtype=pd, device=dev)}

    d, hd = cfg.d_model, cfg.head_dim_
    params: dict[str, Any] = {
        "embed": {"table": normal((cfg.vocab_size, d), 0.02)},
        "final_norm": norm(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = lin(d, cfg.vocab_size)
    layers = []
    for _ in range(cfg.n_layers):
        attn = {"wq": lin(d, cfg.n_heads * hd, cfg.qkv_bias),
                "wk": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                "wv": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                "wo": lin(cfg.n_heads * hd, d)}
        if cfg.qk_norm:
            attn["q_norm"] = norm(hd)
            attn["k_norm"] = norm(hd)
        layer = {"ln1": norm(d), "attn": attn, "ln2": norm(d)}
        if cfg.n_experts:
            # The reference's scales: d^-0.5 for the router and for
            # every expert weight, w_down too.
            e, ff = cfg.n_experts, cfg.d_ff
            layer["moe"] = {"router": {"w": normal((d, e), d ** -0.5, pd)},
                            "w_up": normal((e, d, ff), d ** -0.5),
                            "w_down": normal((e, ff, d), d ** -0.5)}
            if cfg.ffn_gated:
                layer["moe"]["w_gate"] = normal((e, d, ff), d ** -0.5)
        elif cfg.d_ff:
            layer["ffn"] = {"w_up": lin(d, cfg.d_ff),
                            "w_down": lin(cfg.d_ff, d)}
            if cfg.ffn_gated:
                layer["ffn"]["w_gate"] = lin(d, cfg.d_ff)
        layers.append(layer)
    params["layers"] = layers
    return params


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _apply_block(kind: str, p: dict, x: torch.Tensor, h: torch.Tensor,
                 cfg: ArchConfig, *, next_norm: dict | None,
                 rope: tuple[torch.Tensor, torch.Tensor],
                 window: int | None, cache: dict | None = None,
                 write: attention.CacheWrite | None = None,
                 impl: str = "chunked"
                 ) -> tuple[torch.Tensor, torch.Tensor | None,
                            torch.Tensor | None]:
    """One block on the residual stream ``x`` whose ln1 norm ``h`` the
    caller made.  Each residual add runs in one launch with the norm
    that follows it (``add_rmsnorm``): the attention residual with ln2,
    the FFN (or MoE) residual with ``next_norm`` (the next block's ln1,
    or the final norm).  Returns the residual after the block, its
    ``next_norm`` norm and the MoE aux loss (None without experts); with
    ``next_norm`` None (the serve path's last block) a plain add and
    None: the final norm reads only the rows whose logits are taken.
    Without a cache, attention runs over the full sequence by ``impl``."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    out = attention.self_attention(
        p["attn"], h, cfg, rope=rope, window=window, cache=cache,
        write=write, impl=impl)
    aux = None
    if cfg.d_ff:
        x, h = cm.add_rmsnorm(p["ln2"], x, out, cfg.norm_eps)
        if cfg.n_experts:
            out, aux = moe.apply(p["moe"], h, cfg)
        else:
            out = ffn.apply(p["ffn"], h, cfg)
    if next_norm is None:
        return x + out, None, aux
    return (*cm.add_rmsnorm(next_norm, x, out, cfg.norm_eps), aux)


def _head(params: dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Logits of the final-normed rows ``h``, in the compute dtype."""
    cd = compute_dtype(cfg)
    if cfg.tie_embeddings:
        return h.to(cd) @ params["embed"]["table"].to(cd).t()
    return cm.linear(params["lm_head"], h, cd)


def _logits(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return _head(params, cfg, cm.rmsnorm(params["final_norm"], x,
                                         cfg.norm_eps))


# ---------------------------------------------------------------------------
# full-sequence forward (train / one-shot prefill)
# ---------------------------------------------------------------------------

def forward(params: dict, batch: dict, cfg: ArchConfig, *,
            attn_impl: str = "chunked", window: int | None = None,
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (B, S) long}.  Returns (logits (B, S, V) in the
    compute dtype, aux loss (0-d f32: the MoE layers' sum, 0 without
    experts)).

    Every norm runs kernel 1 (forward and, under autograd, backward):
    layer 0's ln1, then per layer the fused q/k-norm + rope and two
    fused residual adds, the last of them with the final norm.  With
    ``remat`` each layer runs under ``torch.utils.checkpoint`` (the
    counterpart of ``jax.checkpoint(group_body)``): only its inputs are
    kept, and it runs again in the backward."""
    check_ported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    window = window if window is not None else cfg.attn_window
    x = cm.embed(params["embed"], tokens, compute_dtype(cfg))
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    rope = cm.rope_angles(positions, cfg.head_dim_, cfg.rope_theta)
    layers = params["layers"]
    h = cm.rmsnorm(layers[0]["ln1"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer, kind in enumerate(cfg.layer_kinds()):
        nxt = layers[layer + 1]["ln1"] if layer + 1 < len(layers) \
            else params["final_norm"]
        body = functools.partial(_apply_block, kind, layers[layer],
                                 cfg=cfg, next_norm=nxt, rope=rope,
                                 window=window, impl=attn_impl)
        if remat:
            x, h, a = checkpoint(body, x, h, use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            x, h, a = body(x, h)
        if a is not None:
            aux = aux + a
    return _head(params, cfg, h), aux


def loss_fn(params: dict, batch: dict, cfg: ArchConfig, *,
            attn_impl: str = "chunked", remat: bool = False) -> torch.Tensor:
    """Mean next-token NLL over the batch, in f32 (logsumexp minus the
    label's logit), plus ``AUX_LOSS_WEIGHT`` times the aux loss."""
    logits, aux = forward(params, batch, cfg, attn_impl=attn_impl,
                          remat=remat)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = lf.gather(-1, batch["labels"][..., None]).squeeze(-1)
    return torch.mean(lse - picked) + AUX_LOSS_WEIGHT * aux


# ---------------------------------------------------------------------------
# cached forward (serve: chunked prefill + decode)
# ---------------------------------------------------------------------------

def forward_cached(params: dict, tokens: torch.Tensor, caches: list, pos,
                   cfg: ArchConfig, *, window: int | None = None,
                   logit_index: int | None = None,
                   write_rows: torch.Tensor | None = None,
                   write_keep: torch.Tensor | None = None,
                   all_logits: bool = False,
                   page_table: torch.Tensor | None = None,
                   page_size: int | None = None
                   ) -> tuple[torch.Tensor, list]:
    """tokens: (B, L) on the params' device; caches: per-layer
    {"k","v"}, **updated in place** (the returned list is ``caches``
    itself): contiguous ``(B, Hkv, S, D)``, or, with ``page_table`` (B,
    n_blocks) int32 and ``page_size``, the paged pool's flat stores
    ``(n_pages * page_size, Hkv, D)``.  ``pos``: an int, the count of
    tokens already cached in every row, or a (B,) long tensor of per-lane
    counts; then ``write_rows`` may restrict which lanes write their K/V
    and ``write_keep`` (bool, one per written lane, on the device) drops
    the writes of lanes only the device knows to be done.  Under a
    sliding window the contiguous caches are rings (see
    ``models/attention.py``): ``pos`` still counts positions, a row lands
    at ``pos % S``, per-lane calls take one new row, and a chunk never
    crosses the ring's end.  Returns
    (logits (B, 1, V) of the last position or of ``logit_index``, or (B,
    L, V) of every position with ``all_logits``, caches)."""
    window = window if window is not None else cfg.attn_window
    x = cm.embed(params["embed"], tokens, compute_dtype(cfg))
    b, length = tokens.shape
    dev = tokens.device
    steps = torch.arange(length, device=dev)
    per_lane = isinstance(pos, torch.Tensor)
    # Under a window a contiguous cache is a ring of this many rows
    # (``attention.init_cache``); 0: rows are positions.
    ring = caches[0]["k"].shape[2] \
        if window is not None and page_table is None else 0
    if per_lane:
        if ring and length != 1:
            raise ValueError(
                f"a ring cache (window={window}) takes one new row per "
                f"lane, got {length}")
        positions = pos[:, None] + steps[None, :]
        kv_lens = pos + length
        if ring:
            kv_lens = kv_lens.clamp(max=ring)
        kv_lens = kv_lens.to(torch.int32)
    else:
        pos = int(pos)
        positions = (pos + steps)[None, :].expand(b, length)
        kv = pos + length
        if ring and kv > ring:
            # Past the wrap a chunk attends the ring and itself
            # (``attention._cached_attention``).
            kv = ring + length
        kv_lens = torch.full((b,), kv, dtype=torch.int32, device=dev)
    rows = write_rows if per_lane else None
    if per_lane or page_table is not None:
        # The written lanes and their positions (ring rows), once per
        # forward.
        lanes = rows if rows is not None else torch.arange(b, device=dev)
        at = positions if rows is None else positions[rows]
        if ring:
            at = at % ring
    if page_table is not None:
        ps = int(page_size)
        if not per_lane and (
                pos < 0 or pos + length > page_table.shape[1] * ps):
            raise ValueError(
                f"cache write of {length} rows at {pos} runs past the "
                f"page table's {page_table.shape[1] * ps} rows")
        flat = attention.page_rows(page_table, lanes, at, ps, write_keep)
        write = attention.CacheWrite(pos, rows, kv_lens, None, page_table,
                                     ps, flat)
    elif per_lane:
        if write_keep is not None:
            # A dropped lane may sit at the end of its cache: its rows
            # are read back and written unchanged at in-range positions.
            at = at.clamp(max=caches[0]["k"].shape[2] - 1)
        write = attention.CacheWrite(pos, rows, kv_lens, write_keep,
                                     lanes=lanes[:, None], at=at)
    else:
        write = attention.CacheWrite(pos, rows, kv_lens)
    # Rotary angles depend only on the positions: once per forward, not
    # once per layer (XLA dedupes the per-layer copies; eager would not).
    rope = cm.rope_angles(positions, cfg.head_dim_, cfg.rope_theta)
    layers = params["layers"]
    h = cm.rmsnorm(layers[0]["ln1"], x, cfg.norm_eps)
    for layer, kind in enumerate(cfg.layer_kinds()):
        nxt = layers[layer + 1]["ln1"] if layer + 1 < len(layers) else None
        x, h, _ = _apply_block(kind, layers[layer], x, h, cfg,
                               next_norm=nxt, rope=rope, window=window,
                               cache=caches[layer], write=write)
    if all_logits:
        xs = x
    elif logit_index is None:
        xs = x[:, -1:]
    else:
        xs = x[:, logit_index:logit_index + 1]
    return _logits(params, cfg, xs), caches


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *,
                window: int | None = None, dtype: torch.dtype | None = None,
                device: str | torch.device = "cuda") -> list:
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)
    window = window if window is not None else cfg.attn_window
    return [attention.init_cache(cfg, batch, max_len, window=window,
                                 dtype=dtype, device=dev)
            for _ in cfg.layer_kinds()]
