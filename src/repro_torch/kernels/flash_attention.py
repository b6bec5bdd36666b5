"""Flash attention: the CUDA kernel's wrapper and its plain PyTorch version.

Port of ``repro.kernels.flash_attention.flash_attention_pallas`` (the
Pallas TPU kernel) with its scalar ``kv_len`` generalised to a per-lane
``kv_lens`` vector, so one kernel serves both the chunked prefill into a
slot and the fused decode over the whole slot pool.  A scalar ``kv_len``
is ``B`` equal entries, so the function is the TPU kernel's.  The kernel
lives in ``csrc/flash_attention.cu``.  ``flash_attention`` launches it
for CUDA tensors and runs ``attention_ref`` for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

launches = build.LaunchCounter("flash_attention")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_lens: torch.Tensor | None = None, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """Masked full-softmax attention in f32.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), Hq % Hkv == 0 (GQA by head
    index, no repeat); ``kv_lens`` (B,): keys at or past a lane's length
    are padding.  Queries are end-aligned per lane (row r of lane b sits
    at ``kv_lens[b] - Sq + r``); ``window`` keeps keys with
    ``qi - kj < window``.  A row with no visible key gives 0, as the
    flash kernel does.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if kv_lens is None:
        lens = torch.full((b,), skv, dtype=torch.long, device=q.device)
    else:
        lens = kv_lens.to(device=q.device, dtype=torch.long)
    qg = q.reshape(b, hkv, group, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    kj = torch.arange(skv, device=q.device)
    qi = lens[:, None] - sq + torch.arange(sq, device=q.device)[None, :]
    mask = (kj[None, None, :] < lens[:, None, None]).expand(b, sq, skv)
    if causal:
        mask = mask & (qi[:, :, None] >= kj[None, None, :])
    if window is not None:
        mask = mask & ((qi[:, :, None] - kj[None, None, :]) < window)
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    o = torch.where(l == 0, torch.zeros_like(o), o / torch.where(
        l == 0, torch.ones_like(l), l))
    return o.reshape(b, hq, sq, d).to(q.dtype)


@functools.cache
def _fn():
    fn = build.library("flash_attention").repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, kv_lens):
    b, hq, sq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if hq % k.shape[1]:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={k.shape[1]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; all float32 or all bfloat16")
    if d % 8 or d > 128:
        raise ValueError(f"flash_attention: head dim {d} must be a "
                         f"multiple of 8 and at most 128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous, "
                             f"16-byte aligned and on {q.device}")
    if kv_lens.shape != (b,) or kv_lens.dtype != torch.int32 \
            or kv_lens.device != q.device or not kv_lens.is_contiguous():
        raise ValueError("flash_attention: kv_lens must be a contiguous "
                         f"(B,) int32 tensor on {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_lens: torch.Tensor | None = None, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); kv_lens (B,) int32
    (default: every lane at Skv).  Returns (B, Hq, Sq, D) in q's type."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, kv_lens, causal=causal, window=window,
                             scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, hq, sq, d = q.shape
    if kv_lens is None:
        kv_lens = torch.full((b,), k.shape[2], dtype=torch.int32,
                             device=q.device)
    _check(q, k, v, kv_lens)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(),
                out.data_ptr(), b, hq, k.shape[1], sq, k.shape[2], d,
                float(scale), int(causal),
                0 if window is None else int(window), _DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    launches.add()
    return out
