"""The Mamba2 (SSD) block on the gated-linear-attention engine
(``models/gla.py``; the counterpart of ``repro.models.mamba2``): q = C,
k = B, v = x, log-decay = Δ·A, log-gain = log Δ.

Without a state (training, ``lm.forward``) the sequence runs through
``chunked_gla``, padded to its chunk.  With a state (serving) the new
tokens run one ``gla_step`` each, as the reference's serve path does,
and the state ``{"ssm": (B, H, N, P) f32, "conv": (B, W-1, C)}`` is
updated **in place** (``copy_`` into the tensors given): the pools hold
it at fixed addresses, which the decode graphs replay against.  A lane
whose ``keep`` flag is False (a spent lane of a decode step), or that
``rows`` leaves out, keeps its state as it was.

Under tensor parallelism (``flags.TP.mamba``) a rank holds its block of
the heads: its z, x and Δ columns of ``in_proj``, its x conv channels,
its ``a_log``/``dt_bias``/``d_skip`` and its rows of the row-parallel
``out_proj``, whose partial products one ``all_reduce`` sums.  B and C
are shared by every head, so every rank holds their columns and conv
channels whole (``launch/sharding.Segments``) and computes them; their
gradient goes through *f* (``common.replicated_segment``).  The states
hold the local heads and channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import common as cm
from . import flags, gla


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d in f32, SiLU after the bias.  x: (B, L,
    C); w: (W, C); ``state``: the (B, W-1, C) carry-in.  Returns (out in
    x's dtype, the new carry)."""
    bsz, length, c = x.shape
    wlen = w.shape[0]
    if state is None:
        state = torch.zeros((bsz, wlen - 1, c), dtype=x.dtype,
                            device=x.device)
    ext = torch.cat([state.to(x.dtype), x], dim=1)
    out = ext[:, :length].float() * w[0].float()
    for i in range(1, wlen):
        out = out + ext[:, i:i + length].float() * w[i].float()
    new_state = ext[:, -(wlen - 1):] if wlen > 1 else state
    return F.silu(out + b.float()).to(x.dtype), new_state


def _project(p: dict, xin: torch.Tensor, cfg: ArchConfig, di: int,
             split: bool):
    """``in_proj`` split into z (the gate), x, B, C and the raw Δ, over
    ``di`` inner channels (this rank's); B and C are the replicated
    columns (``common.replicated_segment``)."""
    n = cfg.ssm_state
    w = cm.replicated_segment(p["in_proj"]["w"], 2 * di, 2 * di + 2 * n,
                              split)
    zxbcdt = cm.linear({"w": w}, cm.block_input(xin, split),
                       getattr(torch, cfg.compute_dtype))
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di],
            zxbcdt[..., 2 * di:2 * di + n],
            zxbcdt[..., 2 * di + n:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _store(dst: torch.Tensor, new: torch.Tensor,
           keep: torch.Tensor | None) -> None:
    """``dst`` ← ``new`` in place, lanes with ``keep`` False unchanged."""
    new = new.to(dst.dtype)
    if keep is not None:
        new = torch.where(keep.view((-1,) + (1,) * (dst.dim() - 1)), new,
                          dst)
    dst.copy_(new)


def _lane_mask(b: int, rows: torch.Tensor | None,
               keep: torch.Tensor | None,
               device: torch.device) -> torch.Tensor | None:
    """The (B,) bool of lanes whose state is written: ``keep`` over the
    lanes, or, with ``rows``, those lanes (filtered by ``keep``, one flag
    per row)."""
    if rows is None:
        return keep
    mask = torch.zeros(b, dtype=torch.bool, device=device)
    mask[rows] = True if keep is None else keep
    return mask


def apply(p: dict, xin: torch.Tensor, cfg: ArchConfig, *,
          state: dict | None = None, keep: torch.Tensor | None = None,
          rows: torch.Tensor | None = None) -> torch.Tensor:
    """xin: (B, L, d).  Returns the block's output (B, L, d) in the
    compute dtype.  With ``state`` the L new tokens run one recurrent
    step each from it, and it is updated in place (``keep`` / ``rows``:
    the lanes that write, see the module docstring)."""
    # The heads this rank holds: all of them, or its block under tensor
    # parallelism (``flags.TP.mamba``), whose parameters are its blocks.
    h, n, hd = p["a_log"].shape[0], cfg.ssm_state, cfg.ssm_head_dim
    di = h * hd
    cd = getattr(torch, cfg.compute_dtype)
    tp = flags.TP
    split = tp is not None and tp.mamba
    z, x, b_, c_, dt_raw = _project(p, xin, cfg, di, split)

    conv_in = torch.cat([x, b_, c_], dim=-1)
    conv_out, new_conv = _causal_conv(
        conv_in, cm.replicated_segment(p["conv_w"], di, di + 2 * n, split),
        cm.replicated_segment(p["conv_b"], di, di + 2 * n, split),
        None if state is None else state["conv"])
    x = conv_out[..., :di]
    b_ = conv_out[..., di:di + n]
    c_ = conv_out[..., di + n:]

    bsz, length, _ = z.shape        # the gathered rows under SP
    a = -torch.exp(p["a_log"].float())                           # (h,)
    delta = F.softplus(dt_raw.float() + p["dt_bias"].float())    # (B,L,h)
    log_decay = delta * a
    log_gain = torch.log(delta + 1e-9)

    xh = x.reshape(bsz, length, h, hd)
    qh = c_[:, :, None, :].expand(bsz, length, h, n)
    kh = b_[:, :, None, :].expand(bsz, length, h, n)

    if state is None:
        pad = (-length) % gla.DEFAULT_CHUNK
        if pad:
            def padf(t):
                return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

            qh, kh, xh_p = padf(qh), padf(kh), padf(xh)
            log_decay, log_gain = padf(log_decay), padf(log_gain)
        else:
            xh_p = xh
        y, _ = gla.chunked_gla(qh, kh, xh_p, log_decay, log_gain)
        y = y[:, :length]
    else:
        s = state["ssm"]
        ys = []
        for t in range(length):
            yt, s = gla.gla_step(qh[:, t], kh[:, t], xh[:, t],
                                 log_decay[:, t], log_gain[:, t], s)
            ys.append(yt)
        y = torch.stack(ys, dim=1)
        mask = _lane_mask(bsz, rows, keep, xin.device)
        _store(state["ssm"], s, mask)
        _store(state["conv"], new_conv, mask)

    y = y + p["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(bsz, length, di).to(cd)
    y = y * F.silu(z.float()).to(cd)
    return cm.linear_rows(p["out_proj"], y, cd, split=split)


def init_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
               device: torch.device, tp=None) -> dict:
    """``ssm`` (B, H, N, P) f32 and the conv carry (B, W-1, C) in
    ``dtype``, zeroed; under a tensor-parallel plan ``tp`` that splits
    the heads, this rank's H / size heads and their x channels (B and C
    whole)."""
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    h = cfg.ssm_heads // tp.size if tp is not None and tp.mamba \
        else cfg.ssm_heads
    conv_ch = h * hd + 2 * n
    return {"ssm": torch.zeros((batch, h, n, hd), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                                dtype=dtype, device=device)}
