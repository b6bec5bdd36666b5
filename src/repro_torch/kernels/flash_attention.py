"""Flash attention: the CUDA kernels' wrappers and their plain PyTorch
versions.

``flash_attention`` ports
``repro.kernels.flash_attention.flash_attention_pallas`` (the Pallas TPU
kernel) with its scalar ``kv_len`` generalised to a
per-lane ``kv_lens`` vector, so one kernel serves both the chunked
prefill into a slot and the fused decode over the whole slot pool.  A
scalar ``kv_len`` is ``B`` equal entries, so the function is the TPU
kernel's.  Its kernel lives in ``csrc/flash_attention.cu``.

``paged_flash_attention`` ports ``paged_flash_attention_pallas``: the
same loop with K/V read through a page table from the paged pool's flat
stores (``csrc/paged_attention.cu``; both kernels instantiate the one
template in ``csrc/flash_attention.cuh``, so they agree bit for bit over
the same K/V).  It is every attention of the paged serve path.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (``attention_ref``, ``paged_attention_ref``) for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

launches = build.LaunchCounter("flash_attention")
paged_launches = build.LaunchCounter("paged_flash_attention")

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


# ---------------------------------------------------------------------------
# paged flash attention (kernel 3)
# ---------------------------------------------------------------------------

def gather_pages(store: torch.Tensor, page_table: torch.Tensor,
                 page_size: int) -> torch.Tensor:
    """Each lane's pages of a flat ``(n_pages * ps, Hkv, D)`` store laid
    out contiguously: ``(B, Hkv, n_blocks * ps, D)``."""
    ps = int(page_size)
    rows = (page_table.long()[:, :, None] * ps
            + torch.arange(ps, device=store.device)).reshape(
                page_table.shape[0], -1)
    return store[rows].permute(0, 2, 1, 3)


def paged_attention_ref(q: torch.Tensor, k_store: torch.Tensor,
                        v_store: torch.Tensor, page_table: torch.Tensor,
                        kv_lens: torch.Tensor, *, page_size: int,
                        causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """The plain version: gather each lane's pages into a contiguous
    view and run ``attention_ref`` over it."""
    return attention_ref(q, gather_pages(k_store, page_table, page_size),
                         gather_pages(v_store, page_table, page_size),
                         kv_lens, causal=causal, scale=scale)


@functools.cache
def _paged_fn():
    fn = build.library("paged_attention").repro_paged_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_paged(q, k_store, v_store, page_table, kv_lens, page_size):
    """Shapes, types, devices and layout; on a CPU table also its
    entries.  A card table is not read here (that would synchronise):
    the page pool checks its entries on the host copy before the upload
    (``PagedKVCachePool.page_table_array``), and the kernel traps on an
    entry outside the store as the last guard."""
    b, hq, _, d = q.shape
    if k_store.dim() != 3 or k_store.shape != v_store.shape \
            or k_store.shape[2] != d:
        raise ValueError(f"paged_flash_attention: q {tuple(q.shape)}, "
                         f"stores {tuple(k_store.shape)} / "
                         f"{tuple(v_store.shape)} do not fit")
    rows, hkv, _ = k_store.shape
    if hq % hkv:
        raise ValueError(f"paged_flash_attention: Hq={hq} is not a "
                         f"multiple of Hkv={hkv}")
    ps = int(page_size)
    if ps < 1 or rows % ps:
        raise ValueError(f"paged_flash_attention: store rows {rows} are "
                         f"not whole pages of {ps}")
    if q.dtype not in _DTYPES or k_store.dtype != q.dtype \
            or v_store.dtype != q.dtype:
        raise TypeError(f"paged_flash_attention: dtypes {q.dtype}/"
                        f"{k_store.dtype}/{v_store.dtype}; all float32 or "
                        f"all bfloat16")
    if d % 8 or d > 128:
        raise ValueError(f"paged_flash_attention: head dim {d} must be a "
                         f"multiple of 8 and at most 128")
    for name, t in (("q", q), ("k_store", k_store), ("v_store", v_store)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_flash_attention: {name} must be "
                             f"contiguous, 16-byte aligned and on {q.device}")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or page_table.shape[1] < 1 or page_table.dtype != torch.int32 \
            or page_table.device != q.device \
            or not page_table.is_contiguous():
        raise ValueError("paged_flash_attention: page_table must be a "
                         f"contiguous (B, n_blocks) int32 tensor on "
                         f"{q.device}")
    if kv_lens.shape != (b,) or kv_lens.dtype != torch.int32 \
            or kv_lens.device != q.device or not kv_lens.is_contiguous():
        raise ValueError("paged_flash_attention: kv_lens must be a "
                         f"contiguous (B,) int32 tensor on {q.device}")
    if page_table.device.type == "cpu" and page_table.numel() and (
            int(page_table.min()) < 0 or int(page_table.max()) >= rows // ps):
        raise ValueError(f"paged_flash_attention: page_table entries must "
                         f"lie in [0, {rows // ps})")


def paged_flash_attention(q: torch.Tensor, k_store: torch.Tensor,
                          v_store: torch.Tensor, page_table: torch.Tensor,
                          kv_lens: torch.Tensor, *, page_size: int,
                          causal: bool = True,
                          scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D), end-aligned per lane; k_store, v_store:
    (n_pages * page_size, Hkv, D); page_table (B, n_blocks) int32 (lane
    b's key kj sits at store row ``page_table[b, kj // ps] * ps + kj %
    ps``); kv_lens (B,) int32.  Returns (B, Hq, Sq, D) in q's type."""
    _check_paged(q, k_store, v_store, page_table, kv_lens, page_size)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_store, v_store, page_table, kv_lens,
                                   page_size=page_size, causal=causal,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_attention: unsupported device "
                         f"{q.device}")
    b, hq, sq, d = q.shape
    ps = int(page_size)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    err = _paged_fn()(
        q.data_ptr(), k_store.data_ptr(), v_store.data_ptr(),
        page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(), b, hq,
        k_store.shape[1], sq, page_table.shape[1], ps,
        k_store.shape[0] // ps, d, float(scale), int(causal),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_flash_attention")
    paged_launches.add()
    return out
