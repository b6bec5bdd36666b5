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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import common as cm
from . import gla


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


def _project(p: dict, xin: torch.Tensor, cfg: ArchConfig):
    """``in_proj`` split into z (the gate), x, B, C and the raw Δ."""
    di, n = cfg.d_inner, cfg.ssm_state
    zxbcdt = cm.linear(p["in_proj"], xin, getattr(torch, cfg.compute_dtype))
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
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hd = cfg.ssm_head_dim
    cd = getattr(torch, cfg.compute_dtype)
    z, x, b_, c_, dt_raw = _project(p, xin, cfg)

    conv_in = torch.cat([x, b_, c_], dim=-1)
    conv_out, new_conv = _causal_conv(
        conv_in, p["conv_w"], p["conv_b"],
        None if state is None else state["conv"])
    x = conv_out[..., :di]
    b_ = conv_out[..., di:di + n]
    c_ = conv_out[..., di + n:]

    bsz, length, _ = xin.shape
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
    return cm.linear(p["out_proj"], y, cd)


def init_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
               device: torch.device) -> dict:
    """``ssm`` (B, H, N, P) f32 and the conv carry (B, W-1, C) in
    ``dtype``, zeroed."""
    h, n, hd = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    conv_ch = cfg.d_inner + 2 * n
    return {"ssm": torch.zeros((batch, h, n, hd), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                                dtype=dtype, device=device)}
