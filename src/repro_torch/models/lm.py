"""The language model's serve path: embedding → attention blocks → head
(the counterpart of ``repro.models.lm`` for the ``attn`` block kind).

Parameters are a plain dict: ``embed``, ``final_norm``, an optional
``lm_head`` and ``layers``, one dict per layer (the JAX package stacks
the layers over pattern groups for ``lax.scan``; here the layer loop is a
Python loop, so they are kept apart).  Weights are made once, in the
compute dtype, from a seeded ``torch.Generator``; ``bridge.py`` loads the
JAX package's parameters instead.

Not ported yet (ROADMAP.md): the other block kinds (MoE, Mamba2, xLSTM,
shared and cross attention), the full-sequence ``forward`` and the loss.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import attention, common as cm, ffn

_PORTED_KINDS = ("attn",)


def check_ported(cfg: ArchConfig) -> None:
    """Raise unless every layer of ``cfg`` is a kind the port serves."""
    kinds = set(cfg.layer_kinds())
    if not kinds <= set(_PORTED_KINDS) or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(kinds)}"
            f"{' with MoE' if cfg.n_experts else ''} are not ported yet "
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
                device: str | torch.device = "cuda") -> dict:
    """Random weights from ``seed``, in the compute dtype on ``device``
    (norm gains in the parameter dtype).  Drawn on the CPU, so the same
    seed gives the same weights on every device."""
    check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    cd, pd = compute_dtype(cfg), param_dtype(cfg)

    def normal(shape, scale):
        t = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
        return t.to(device=dev, dtype=cd)

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
        if cfg.d_ff:
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

def _apply_block(kind: str, p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                 rope: tuple[torch.Tensor, torch.Tensor],
                 window: int | None, cache: dict,
                 write: attention.CacheWrite) -> torch.Tensor:
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    h = cm.rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attention.self_attention(
        p["attn"], h, cfg, rope=rope, window=window, cache=cache,
        write=write)
    if cfg.d_ff:
        h = cm.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + ffn.apply(p["ffn"], h, cfg)
    return x


def _logits(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = cm.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        table = params["embed"]["table"]
        return x.to(table.dtype) @ table.t()
    return cm.linear(params["lm_head"], x)


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
    the writes of lanes only the device knows to be done.  Returns
    (logits (B, 1, V) of the last position or of ``logit_index``, or (B,
    L, V) of every position with ``all_logits``, caches)."""
    window = window if window is not None else cfg.attn_window
    x = cm.embed(params["embed"], tokens)
    b, length = tokens.shape
    dev = tokens.device
    steps = torch.arange(length, device=dev)
    if isinstance(pos, torch.Tensor):
        positions = pos[:, None] + steps[None, :]
        rows = write_rows if write_rows is not None \
            else torch.arange(b, device=dev)
        kv_lens = (pos + length).to(torch.int32)
    else:
        pos = int(pos)
        positions = (pos + steps)[None, :].expand(b, length)
        rows = None
        kv_lens = torch.full((b,), pos + length, dtype=torch.int32,
                             device=dev)
    if page_table is not None:
        ps = int(page_size)
        if not isinstance(pos, torch.Tensor) and (
                pos < 0 or pos + length > page_table.shape[1] * ps):
            raise ValueError(
                f"cache write of {length} rows at {pos} runs past the "
                f"page table's {page_table.shape[1] * ps} rows")
        lanes = rows if rows is not None else torch.arange(b, device=dev)
        flat = attention.page_rows(page_table, lanes, positions[lanes], ps,
                                   write_keep)
        write = attention.CacheWrite(pos, rows, kv_lens, None, page_table,
                                     ps, flat)
    else:
        write = attention.CacheWrite(pos, rows, kv_lens, write_keep)
    # Rotary angles depend only on the positions: once per forward, not
    # once per layer (XLA dedupes the per-layer copies; eager would not).
    rope = cm.rope_angles(positions, cfg.head_dim_, cfg.rope_theta)
    for layer, kind in enumerate(cfg.layer_kinds()):
        x = _apply_block(kind, params["layers"][layer], x, cfg,
                         rope=rope, window=window,
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
