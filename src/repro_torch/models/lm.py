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

The hybrid family (zamba2) adds two kinds.  A ``mamba2`` layer holds
``ln1`` and ``mamba`` (``models/mamba2.py``; its ``a_log``, ``dt_bias``,
``d_skip`` and conv weights stay in the parameter dtype, as the
reference computes with them in f32).  A ``shared_attn`` layer holds its
per-use ``proj`` (and an ``ln1`` that, as in the reference, nothing
reads): the block itself (``ln1``, ``attn``, ``ln2``, ``ffn``) is
``params["shared_block"]``, held once.  A ``mamba2`` layer's cache is
its recurrent state ``{"ssm", "conv"}``; attention layers keep ``{"k",
"v"}``.

The xLSTM family (xlstm-350m) adds ``mlstm`` and ``slstm`` layers
(``models/xlstm.py``): ``ln1`` and the block, no feed-forward; their
caches are the recurrent states ``{"mem"}`` and ``{"c", "n", "m"}``.

The vision family (llama-3.2-vision-11b) adds ``cross_attn`` layers:
``ln1``, ``xattn`` (``attention.cross_attention``, with ``kv_norm`` on
the frontend features), ``ln2`` and the feed-forward.  They attend the
batch's ``frontend_feats`` (B, T, d), which ``forward``, ``loss_fn`` and
``forward_cached`` take; their cache entry is None, because the K/V are
recomputed from the features at every step, as in the reference.

On a training mesh (``flags.FSDP``, ``train/sharded.py``) the
parameters are this rank's blocks: each layer gathers its leaves' 'data'
blocks at its start, inside its ``torch.utils.checkpoint`` region, so
remat gathers them again in the backward and the gathered weights of
two layers are never alive at once; the embedding and the head gather
theirs where they are read.  ``forward_cached`` reads the same context,
so prefill and decode run over FSDP weights too (the dry run's).
Tensor parallelism (``flags.TP``) splits heads, hidden dims and the
vocabulary inside the blocks (``models/common.py``), for every block
kind: attention (a ``shared_attn`` layer's shared block too, its
per-layer ``proj`` whole on every rank), cross-attention, Mamba2 and the
xLSTM blocks, each by its own flag of the plan; a cache holds the local
heads and channels (``init_caches(..., tp=...)``); an attention block
lies over 'model' by its plan's rule ("split", "kv_shared", "head_dim"
or "whole", ``models/attention.py``).  Under a sequence split of the
caches (``flags.SEQ``) a K/V cache holds one block of the rows and
decode merges the ranks' blocks (``models/attention.py``).  Under
sequence parallelism (``flags.SP``, the training step's Megatron-SP)
``forward`` keeps the residual's rows of this rank between blocks.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import attention, common as cm, ffn, flags, mamba2, moe, xlstm

AUX_LOSS_WEIGHT = 0.01
_PORTED_KINDS = ("attn", "mamba2", "shared_attn", "mlstm", "slstm",
                 "cross_attn")
# The kinds whose cache is K/V rows ({"k", "v"}); any other carries a
# recurrent state.
ATTN_KINDS = ("attn", "shared_attn")
# Parameter nodes held in the parameter dtype whatever the compute dtype:
# the norm gains (``g``), which the norm computes in, the MoE routers,
# whose f32 logits top-k ranks as the reference's do, and the Mamba2
# block's per-head and conv parameters, which the reference computes with
# in f32 from its f32 parameters.
KEEP_PARAM_DTYPE = ("g", "router", "a_log", "dt_bias", "d_skip", "conv_w",
                    "conv_b")


def check_ported(cfg: ArchConfig) -> None:
    """Raise unless every layer of ``cfg`` is a kind the port has."""
    kinds = set(cfg.layer_kinds())
    if not kinds <= set(_PORTED_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(kinds)} are not in the port "
            f"(ROADMAP.md, where the port stands); it has "
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
                dtype: torch.dtype | None = None,
                draw_on_device: bool = False) -> dict:
    """Random weights from ``seed`` on ``device``, in ``dtype``: the
    compute dtype by default (serving), or ``param_dtype(cfg)`` for f32
    master weights (training).  The nodes of ``KEEP_PARAM_DTYPE`` (norm
    gains, MoE routers, the Mamba2 block's per-head and conv parameters)
    are in the parameter dtype (a router rounded to bf16 would rank other
    experts than the reference's).  Drawn on the CPU one tensor at a
    time, so the same seed gives the same weights on every device; with
    ``draw_on_device`` drawn by a generator on ``device`` instead (the
    card's stream of numbers, not the CPU's: no f32 copy of a large
    model passes through the host).  ``device="meta"`` gives the shapes
    and dtypes alone, drawing nothing (the sharding rules read them)."""
    check_ported(cfg)
    meta = str(device) == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    gen = torch.Generator(device=dev if draw_on_device and not meta
                          else "cpu")
    gen.manual_seed(int(seed))
    cd, pd = dtype or compute_dtype(cfg), param_dtype(cfg)

    def normal(shape, scale, dtype=cd):
        if meta:
            return torch.empty(shape, dtype=dtype, device=dev)
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * scale
        return t.to(device=dev, dtype=dtype)

    def lin(d_in, d_out, bias=False):
        p = {"w": normal((d_in, d_out), d_in ** -0.5)}
        if bias:
            p["b"] = torch.zeros(d_out, dtype=cd, device=dev)
        return p

    def norm(d):
        return {"g": torch.ones(d, dtype=pd, device=dev)}

    d, hd = cfg.d_model, cfg.head_dim_

    def attn(cross=False):
        p = {"wq": lin(d, cfg.n_heads * hd, cfg.qkv_bias),
             "wk": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
             "wv": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
             "wo": lin(cfg.n_heads * hd, d)}
        if cfg.qk_norm:
            p["q_norm"] = norm(hd)
            p["k_norm"] = norm(hd)
        if cross:
            p["kv_norm"] = norm(d)
        return p

    def dense_ffn():
        p = {"w_up": lin(d, cfg.d_ff), "w_down": lin(cfg.d_ff, d)}
        if cfg.ffn_gated:
            p["w_gate"] = lin(d, cfg.d_ff)
        return p

    def mamba():
        # The reference's shapes and scales (``repro.models.mamba2.init``):
        # A = -exp(0) = -1, Δ's bias 0, the skip 1.
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        ch = di + 2 * n
        return {"in_proj": lin(d, 2 * di + 2 * n + h),
                "conv_w": normal((cfg.conv_width, ch), 0.2, pd),
                "conv_b": torch.zeros(ch, dtype=pd, device=dev),
                "a_log": torch.zeros(h, dtype=pd, device=dev),
                "dt_bias": torch.zeros(h, dtype=pd, device=dev),
                "d_skip": torch.ones(h, dtype=pd, device=dev),
                "out_proj": lin(di, d)}

    def mlstm():
        di, h = cfg.d_inner, cfg.ssm_heads
        return {"wq": lin(d, di), "wk": lin(d, di), "wv": lin(d, di),
                "w_if": lin(d, 2 * h), "w_o": lin(d, di),
                "out_proj": lin(di, d)}

    def slstm():
        di = cfg.d_inner
        return {"w_zifo": lin(d, 4 * di), "out_proj": lin(di, d)}

    params: dict[str, Any] = {
        "embed": {"table": normal((cfg.vocab_size, d), 0.02)},
        "final_norm": norm(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = lin(d, cfg.vocab_size)
    kinds = cfg.layer_kinds()
    if "shared_attn" in kinds:
        # Held once, applied at every shared_attn layer.
        params["shared_block"] = {"ln1": norm(d), "attn": attn(),
                                  "ln2": norm(d), "ffn": dense_ffn()}
    layers = []
    for kind in kinds:
        if kind == "shared_attn":
            # Its ln1 is the reference's too, and unused there as here:
            # the shared block's own ln1 normalises the layer's input.
            layers.append({"ln1": norm(d), "proj": lin(d, d)})
            continue
        if kind == "mamba2":
            layers.append({"ln1": norm(d), "mamba": mamba()})
            continue
        if kind == "mlstm":
            layers.append({"ln1": norm(d), "mlstm": mlstm()})
            continue
        if kind == "slstm":
            layers.append({"ln1": norm(d), "slstm": slstm()})
            continue
        if kind == "cross_attn":
            layer = {"ln1": norm(d), "xattn": attn(cross=True),
                     "ln2": norm(d)}
            if cfg.d_ff:
                layer["ffn"] = dense_ffn()
            layers.append(layer)
            continue
        layer = {"ln1": norm(d), "attn": attn(), "ln2": norm(d)}
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
            layer["ffn"] = dense_ffn()
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
                 impl: str = "chunked", shared: dict | None = None,
                 feats: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor | None,
                            torch.Tensor | None]:
    """One block on the residual stream ``x`` whose ln1 norm ``h`` the
    caller made (for ``shared_attn``, the shared block's ln1).  Each
    residual add runs in one launch with the norm that follows it
    (``add_rmsnorm``): the attention residual with ln2, the block's last
    residual with ``next_norm`` (the next block's ln1, or the final
    norm).  Returns the residual after the block, its ``next_norm`` norm
    and the MoE aux loss (None without experts); with ``next_norm`` None
    (the serve path's last block) a plain add and None: the final norm
    reads only the rows whose logits are taken.  Without a cache,
    attention runs over the full sequence by ``impl`` and a ``mamba2``
    block chunk-parallel; with one, a ``mamba2`` block steps its state
    token by token, in place, keeping the lanes ``write`` drops; the
    xLSTM blocks alike.  A ``cross_attn`` block attends ``feats`` (the
    batch's frontend features): through ``impl`` without a cache, through
    kernel 2 on the serve path.

    ``shared_attn`` is the reference's ``_apply_shared`` with the
    ``shared`` block: its inner residual starts from ``h``, not ``x``
    (``h + attn`` with ln2, then ``+ ffn``), and the layer returns ``x +
    proj(h)``."""
    aux = None
    keep = None if write is None else write.keep
    rows = None if write is None else write.rows
    if kind == "mamba2":
        out = mamba2.apply(p["mamba"], h, cfg, state=cache, keep=keep,
                           rows=rows)
    elif kind == "mlstm":
        out = xlstm.mlstm_apply(p["mlstm"], h, cfg, state=cache, keep=keep,
                                rows=rows)
    elif kind == "slstm":
        out = xlstm.slstm_apply(p["slstm"], h, cfg, state=cache, keep=keep,
                                rows=rows)
    elif kind == "cross_attn":
        if feats is None:
            raise ValueError("a cross_attn block needs frontend_feats")
        out = attention.cross_attention(
            p["xattn"], h, feats, cfg,
            impl="flash" if write is not None else impl)
        if cfg.d_ff:
            x, h = cm.add_rmsnorm(cm.row_params(p["ln2"]), x, out,
                                  cfg.norm_eps)
            out = ffn.apply(p["ffn"], h, cfg)
    elif kind == "shared_attn":
        a = attention.self_attention(
            shared["attn"], h, cfg, rope=rope, window=window, cache=cache,
            write=write, impl=impl)
        inner, h2 = cm.add_rmsnorm(cm.row_params(shared["ln2"]), h, a,
                                   cfg.norm_eps)
        inner = inner + ffn.apply(shared["ffn"], h2, cfg)
        out = cm.linear(cm.row_params(p["proj"]), inner, compute_dtype(cfg))
    elif kind == "attn":
        out = attention.self_attention(
            p["attn"], h, cfg, rope=rope, window=window, cache=cache,
            write=write, impl=impl)
        if cfg.d_ff:
            x, h = cm.add_rmsnorm(cm.row_params(p["ln2"]), x, out,
                                  cfg.norm_eps)
            if cfg.n_experts:
                out, aux = moe.apply(p["moe"], h, cfg)
            else:
                out = ffn.apply(p["ffn"], h, cfg)
    else:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    if next_norm is None:
        return x + out, None, aux
    return (*cm.add_rmsnorm(cm.row_params(next_norm), x, out, cfg.norm_eps),
            aux)


def _ln1(params: dict, cfg: ArchConfig, layer: int) -> dict:
    """The norm a layer's input goes through: its own ln1, or the shared
    block's for a ``shared_attn`` layer (whose own ln1, as in the
    reference, nothing reads)."""
    if cfg.layer_kinds()[layer] == "shared_attn":
        return params["shared_block"]["ln1"]
    return params["layers"][layer]["ln1"]


def _next_norm(params: dict, cfg: ArchConfig, layer: int,
               last: dict | None) -> dict | None:
    """The norm after ``layer``: the next layer's ln1, or ``last``."""
    if layer + 1 < cfg.n_layers:
        return _ln1(params, cfg, layer + 1)
    return last


def _gathered(params: dict, name: str):
    """``params[name]`` with its 'data' blocks gathered under an FSDP
    context (``common.fsdp_params``)."""
    ctx = flags.FSDP
    if ctx is None:
        return params[name]
    return cm.fsdp_params(params[name], ctx.specs[name])


def _layer_block(params: dict, layer: int, kind: str, x: torch.Tensor,
                 h: torch.Tensor, **kw):
    """``_apply_block`` of layer ``layer``, its parameters (and the
    shared block's, for a ``shared_attn`` layer) gathered first under an
    FSDP context: inside the layer's checkpoint region, when there is
    one."""
    p, shared = params["layers"][layer], params.get("shared_block")
    ctx = flags.FSDP
    if ctx is not None:
        p = cm.fsdp_params(p, ctx.specs["layers"][layer])
        if kind == "shared_attn":
            shared = cm.fsdp_params(shared, ctx.specs["shared_block"])
    return _apply_block(kind, p, x, h, shared=shared, **kw)


def _head(params: dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Logits of the final-normed rows ``h``, in the compute dtype; under
    sequence parallelism every rank's rows gathered first."""
    cd = compute_dtype(cfg)
    tp = flags.TP
    h = cm.block_input(h, tp is not None and tp.vocab)
    if cfg.tie_embeddings:
        table = _gathered(params, "embed")["table"]
        return cm.gather_vocab(h.to(cd) @ table.to(cd).t())
    return cm.gather_vocab(cm.linear(_gathered(params, "lm_head"), h, cd))


def _logits(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return _head(params, cfg, cm.rmsnorm(params["final_norm"], x,
                                         cfg.norm_eps))


# ---------------------------------------------------------------------------
# full-sequence forward (train / one-shot prefill)
# ---------------------------------------------------------------------------

def forward(params: dict, batch: dict, cfg: ArchConfig, *,
            attn_impl: str = "chunked", window: int | None = None,
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (B, S) long, and for an arch with
    ``cross_attn`` layers "frontend_feats" (B, T, d)}.  Returns (logits
    (B, S, V) in the compute dtype, aux loss (0-d f32: the MoE layers'
    sum, 0 without experts)).

    Every norm runs kernel 1 (forward and, under autograd, backward):
    layer 0's ln1, then per attention layer the fused q/k-norm + rope
    (with qk-norm) and two fused residual adds, per ``mamba2`` layer one,
    per ``shared_attn`` layer two (the inner one with the shared ln2),
    per xLSTM layer one, per ``cross_attn`` layer three (``kv_norm`` and
    two fused adds); the last add carries the final norm.  With
    ``remat`` each layer runs under ``torch.utils.checkpoint`` (the
    counterpart of ``jax.checkpoint(group_body)``): only its inputs are
    kept, and it runs again in the backward (an FSDP layer's gather
    with it).  Under sequence parallelism (``flags.SP``, the sharded
    step's ``seq_shard``) the residual ``x`` and its norm ``h`` hold this
    rank's S / n rows between blocks (the embedding reduce-scatters them,
    every norm runs on them); each block gathers its input's rows and
    gives back its own (``models/common.py``), and the head gathers them
    all; RoPE reads the gathered rows' positions.  S must divide by n."""
    check_ported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    sp = flags.SP
    if sp is not None and s % sp.size:
        raise ValueError(f"sequence parallelism over {sp.size} model ranks "
                         f"needs the sequence ({s}) to divide by them")
    window = window if window is not None else cfg.attn_window
    x = cm.embed(_gathered(params, "embed"), tokens, compute_dtype(cfg))
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    rope = cm.rope_angles(positions, cfg.head_dim_, cfg.rope_theta)
    h = cm.rmsnorm(cm.row_params(_ln1(params, cfg, 0)), x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer, kind in enumerate(cfg.layer_kinds()):
        nxt = _next_norm(params, cfg, layer, params["final_norm"])
        body = functools.partial(_layer_block, params, layer, kind,
                                 cfg=cfg, next_norm=nxt, rope=rope,
                                 window=window, impl=attn_impl,
                                 feats=batch.get("frontend_feats"))
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
    picked = lf.gather(-1, batch["labels"][..., None].long()).squeeze(-1)
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
                   page_size: int | None = None,
                   frontend_feats: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, list]:
    """tokens: (B, L) on the params' device; caches: per-layer, **updated
    in place** (the returned list is ``caches`` itself): an attention
    layer's {"k","v"}, contiguous ``(B, Hkv, S, D)``, or, with
    ``page_table`` (B, n_blocks) int32 and ``page_size``, the paged
    pool's flat stores ``(n_pages * page_size, Hkv, D)``; a recurrent
    layer's state (``mamba2`` {"ssm","conv"}, ``mlstm`` {"mem"},
    ``slstm`` {"c","n","m"}) of B rows in either case; None for a
    ``cross_attn`` layer, which attends ``frontend_feats`` (B, T, d).  ``pos``: an
    int, the count of tokens already cached in every row, or a (B,) long
    tensor of per-lane counts; then ``write_rows`` may restrict which
    lanes write their K/V and state, and ``write_keep`` (bool, one per
    written lane, on the device) drops the writes of lanes only the
    device knows to be done.  Under a
    sliding window the contiguous caches are rings (see
    ``models/attention.py``): ``pos`` still counts positions, a row lands
    at ``pos % S``, per-lane calls take one new row, and a chunk never
    crosses the ring's end.  Returns
    (logits (B, 1, V) of the last position or of ``logit_index``, or (B,
    L, V) of every position with ``all_logits``, caches)."""
    window = window if window is not None else cfg.attn_window
    x = cm.embed(_gathered(params, "embed"), tokens, compute_dtype(cfg))
    b, length = tokens.shape
    dev = tokens.device
    steps = torch.arange(length, device=dev)
    per_lane = isinstance(pos, torch.Tensor)
    # The first attention layer's K/V store (None in an arch with no
    # attention): under a window a contiguous cache is a ring of its
    # rows (``attention.init_cache``); ring 0: rows are positions.
    store = next((caches[i]["k"] for i, kind in enumerate(cfg.layer_kinds())
                  if kind in ATTN_KINDS), None)
    # Under a sequence split a cache holds one block of the ring's rows.
    ring = store.shape[2] * (flags.SEQ.size if flags.SEQ is not None
                             else 1) \
        if window is not None and page_table is None and store is not None \
        else 0
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
        write = attention.CacheWrite(pos, rows, kv_lens, write_keep,
                                     page_table, ps, flat)
    elif per_lane:
        if write_keep is not None and store is not None:
            # A dropped lane may sit at the end of its cache: its rows
            # are read back and written unchanged at in-range positions.
            at = at.clamp(max=store.shape[2] - 1)
        write = attention.CacheWrite(pos, rows, kv_lens, write_keep,
                                     lanes=lanes[:, None], at=at)
    else:
        write = attention.CacheWrite(pos, rows, kv_lens)
    # Rotary angles depend only on the positions: once per forward, not
    # once per layer (XLA dedupes the per-layer copies; eager would not).
    rope = cm.rope_angles(positions, cfg.head_dim_, cfg.rope_theta)
    h = cm.rmsnorm(_ln1(params, cfg, 0), x, cfg.norm_eps)
    for layer, kind in enumerate(cfg.layer_kinds()):
        x, h, _ = _layer_block(params, layer, kind, x, h, cfg=cfg,
                               next_norm=_next_norm(params, cfg, layer, None),
                               rope=rope, window=window,
                               cache=caches[layer], write=write,
                               feats=frontend_feats)
    if all_logits:
        xs = x
    elif logit_index is None:
        xs = x[:, -1:]
    else:
        xs = x[:, logit_index:logit_index + 1]
    # One row of each of B > 1 lanes of a chunk is a strided view; kernel
    # 1 reads contiguous rows (a no-op for a decode step or one lane).
    xs = xs.contiguous()
    return _logits(params, cfg, xs), caches


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *,
                window: int | None = None, dtype: torch.dtype | None = None,
                device: str | torch.device = "cuda", tp=None,
                seq_blocks: int = 1) -> list:
    """Per layer: ``{"k", "v"}`` for attention (``attention.init_cache``),
    a recurrent layer's state (``init_state``), None for ``cross_attn``
    (its K/V come from the features at every step).  The local layout of
    a mesh rank: ``tp`` (a ``launch/sharding.TPPlan`` or
    ``flags.TensorParallel``) gives this rank's kv heads, where the
    attention heads split, and its block of each recurrent state's heads
    or channels; ``seq_blocks`` cuts the K/V rows into that many
    contiguous blocks, of which this rank holds one (``flags.SEQ``).
    ``device="meta"`` gives the shapes alone (the dry run's)."""
    check_ported(cfg)
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    dtype = dtype or compute_dtype(cfg)
    window = window if window is not None else cfg.attn_window
    return [attention.init_cache(cfg, batch, max_len, window=window,
                                 dtype=dtype, device=dev, tp=tp,
                                 seq_blocks=seq_blocks)
            if kind in ATTN_KINDS
            else None if kind == "cross_attn"
            else init_state(kind, cfg, batch, dtype, dev, tp=tp)
            for kind in cfg.layer_kinds()]


def init_state(kind: str, cfg: ArchConfig, batch: int, dtype: torch.dtype,
               device: torch.device, tp=None) -> dict:
    """The recurrent state of a ``mamba2`` (``{"ssm", "conv"}``, the conv
    carry in ``dtype``), ``mlstm`` (``{"mem"}``) or ``slstm`` (``{"c",
    "n", "m"}``) layer, B rows, as its module initialises it: this
    rank's heads or channels under a plan ``tp`` that splits them."""
    if kind == "mamba2":
        return mamba2.init_state(cfg, batch, dtype, device, tp=tp)
    if kind == "mlstm":
        return xlstm.mlstm_init_state(cfg, batch, device, tp=tp)
    if kind == "slstm":
        return xlstm.slstm_init_state(cfg, batch, device, tp=tp)
    raise ValueError(f"block kind {kind!r} has no recurrent state")
