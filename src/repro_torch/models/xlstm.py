"""xLSTM blocks (the counterpart of ``repro.models.xlstm``): mLSTM, a
matrix memory run on the gated-linear-attention engine
(``models/gla.py``), and sLSTM, a scalar memory with stabilised
exponential gating.

mLSTM keeps the reference's sum normaliser: v gets a ones-column, so
the state is (B, H, P, P + 1) f32 and its last output channel is the
denominator n·q, floored at 1 (``max(|den|, 1)``).  Without a state
(training, ``lm.forward``) the sequence runs through ``chunked_gla``,
padded to its chunk; with one (serving) the new tokens run one
``gla_step`` each, as the reference's serve path does.

sLSTM steps token by token on both paths, as the reference's
``lax.scan`` does: ``m`` is the running max of the log gates, ``c`` and
``n`` the cell and normaliser, ``h = c / max(n, 1e-6)``.  A fresh state
starts ``m`` at -1e30 (``slstm_init_state``, and ``lm.forward``); the
pools zero every state row on acquire (``serve/kv_cache.py``), so a
served sequence starts ``m`` at 0 (ROADMAP.md, faults of the reference).

A state is updated **in place** (``copy_`` into the tensors given), the
lanes ``keep`` drops or ``rows`` leaves out unchanged, as
``models/mamba2.py`` does.

Under tensor parallelism a rank holds its block of the mLSTM heads
(``flags.TP.mlstm``: its columns of ``wq``/``wk``/``wv``/``w_o``, its
heads' i and f columns of ``w_if``, the ones-column normaliser per head)
or of the sLSTM channels (``flags.TP.slstm``: its block of each of
``w_zifo``'s four gates); the input goes through *f*, ``out_proj`` is
row-parallel (one ``all_reduce``), and the states hold the local heads
or channels.  Plain PyTorch: the reference's xLSTM is
plain ``jnp`` and reaches no Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import common as cm
from . import flags, gla
from .mamba2 import _lane_mask, _store

SLSTM_M0 = -1e30


def _pad(t: torch.Tensor, pad: int) -> torch.Tensor:
    """t (B, L, ...) padded with zeros along L."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_apply(p: dict, xin: torch.Tensor, cfg: ArchConfig, *,
                state: dict | None = None, keep: torch.Tensor | None = None,
                rows: torch.Tensor | None = None) -> torch.Tensor:
    """xin: (B, L, d).  Returns the block's output (B, L, d) in the
    compute dtype; with ``state`` {"mem"} the L tokens step it, in
    place."""
    # The heads this rank holds (all, or its block: ``flags.TP.mlstm``).
    h, hd = p["w_if"]["w"].shape[-1] // 2, cfg.ssm_head_dim
    di = h * hd
    cd = getattr(torch, cfg.compute_dtype)
    tp = flags.TP
    split = tp is not None and tp.mlstm
    xin = cm.block_input(xin, split)
    bsz, length, _ = xin.shape
    q = cm.linear(p["wq"], xin, cd).view(bsz, length, h, hd) * (hd ** -0.5)
    k = cm.linear(p["wk"], xin, cd).view(bsz, length, h, hd)
    v = cm.linear(p["wv"], xin, cd).view(bsz, length, h, hd)
    gates = cm.linear(p["w_if"], xin, cd).float()
    log_i = F.logsigmoid(gates[..., :h])           # bounded input gate
    log_f = F.logsigmoid(gates[..., h:])           # forget in (0, 1)
    o = torch.sigmoid(cm.linear(p["w_o"], xin, cd).float())
    # The ones-column: the extra channel is the normaliser n·q.
    v1 = torch.cat([v.float(), torch.ones((bsz, length, h, 1),
                                          device=xin.device)], dim=-1)

    if state is None:
        pad = (-length) % gla.DEFAULT_CHUNK
        if pad:
            q, k, v1 = _pad(q, pad), _pad(k, pad), _pad(v1, pad)
            log_f, log_i = _pad(log_f, pad), _pad(log_i, pad)
        y1, _ = gla.chunked_gla(q, k, v1, log_f, log_i)
        y1 = y1[:, :length]
    else:
        s = state["mem"]
        ys = []
        for t in range(length):
            yt, s = gla.gla_step(q[:, t], k[:, t], v1[:, t], log_f[:, t],
                                 log_i[:, t], s)
            ys.append(yt)
        y1 = torch.stack(ys, dim=1)
        _store(state["mem"], s, _lane_mask(bsz, rows, keep, xin.device))

    num, den = y1[..., :hd], y1[..., hd:]
    yh = num / torch.clamp(den.abs(), min=1.0)
    y = (o.view(bsz, length, h, hd) * yh).reshape(bsz, length, di).to(cd)
    return cm.linear_rows(p["out_proj"], y, cd, split=split)


def mlstm_init_state(cfg: ArchConfig, batch: int, device: torch.device,
                     tp=None) -> dict:
    """``mem`` (B, H, P, P + 1) f32, zeroed (this rank's H / size heads
    under a plan ``tp`` that splits them)."""
    hd = cfg.ssm_head_dim
    h = cfg.ssm_heads // tp.size if tp is not None and tp.mlstm \
        else cfg.ssm_heads
    return {"mem": torch.zeros((batch, h, hd, hd + 1), dtype=torch.float32,
                               device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_apply(p: dict, xin: torch.Tensor, cfg: ArchConfig, *,
                state: dict | None = None, keep: torch.Tensor | None = None,
                rows: torch.Tensor | None = None) -> torch.Tensor:
    """xin: (B, L, d).  Returns the block's output (B, L, d) in the
    compute dtype; with ``state`` {"c", "n", "m"} the L tokens step from
    it and it is updated in place, else they step from a fresh state."""
    # The channels this rank holds (all, or its block: ``flags.TP.slstm``);
    # the recurrence is per channel, so none is read across ranks.
    di = p["w_zifo"]["w"].shape[-1] // 4
    cd = getattr(torch, cfg.compute_dtype)
    tp = flags.TP
    split = tp is not None and tp.slstm
    xin = cm.block_input(xin, split)
    bsz, length, _ = xin.shape
    zifo = cm.linear(p["w_zifo"], xin, cd).float()
    z = torch.tanh(zifo[..., :di])
    i_raw = zifo[..., di:2 * di]
    log_f = F.logsigmoid(zifo[..., 2 * di:3 * di])
    o = torch.sigmoid(zifo[..., 3 * di:])

    if state is None:
        c = torch.zeros((bsz, di), dtype=torch.float32, device=xin.device)
        n = torch.zeros_like(c)
        m = torch.full_like(c, SLSTM_M0)
    else:
        c, n, m = state["c"], state["n"], state["m"]
    hs = []
    for t in range(length):
        it, lf = i_raw[:, t], log_f[:, t]
        m_new = torch.maximum(lf + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(lf + m - m_new)
        c = f_p * c + i_p * z[:, t]
        n = f_p * n + i_p
        m = m_new
        hs.append(c / torch.clamp(n, min=1e-6))
    if state is not None:
        mask = _lane_mask(bsz, rows, keep, xin.device)
        for name, new in (("c", c), ("n", n), ("m", m)):
            _store(state[name], new, mask)
    h = torch.stack(hs, dim=1) * o
    return cm.linear_rows(p["out_proj"], h.to(cd), cd, split=split)


def slstm_init_state(cfg: ArchConfig, batch: int, device: torch.device,
                     tp=None) -> dict:
    """``c``, ``n`` (B, d_inner) f32 zeroed, ``m`` at -1e30 (this rank's
    d_inner / size channels under a plan ``tp`` that splits them)."""
    di = cfg.d_inner // tp.size if tp is not None and tp.slstm \
        else cfg.d_inner
    return {"c": torch.zeros((batch, di), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, di), dtype=torch.float32,
                             device=device),
            "m": torch.full((batch, di), SLSTM_M0, dtype=torch.float32,
                            device=device)}
