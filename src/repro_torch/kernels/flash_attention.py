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

Both kernels run one of two schedules, which ``attention_plan`` picks
from (B, Hq, Hkv, Sq, dtype) alone: split-KV decode for at most
``SPLIT_ROWS`` packed query rows per kv head (decode and verify), the
tile path above it (prefill chunks; tensor cores in bf16).  The C side
(``csrc/flash_attention.cuh``, ``use_split`` and its constants) makes the
same choice.  ``attention_plan`` is the analytic prior; a wrapper may be
given another plan of the same path (``plan=``: a measured one,
``autotune.KernelTuner.plan_attention``): the split path's keys per
split, or the tile path's schedule, which the wrapper checks, passes to
the C call and sizes the split path's scratch from.  The default plan
gives the bits the kernels gave before plans were measured.

Kernel 2 may also return each query row's log-sum-exp (``return_lse``):
the partial softmax statistics by which the blocks of a cache cut over
ranks merge (``models/attention.merge_blocks``).

Both take every head dim that is a multiple of 8 up to ``MAX_D`` (256,
the widest N of ``wgmma``), as the TPU kernel takes any; the kernels are
instantiated for two classes, ``head_dim_class``: a head dim runs
zero-padded to 128 (``NARROW_D``) or to 256.  ``check_head_dim`` is the
rule, on any device.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (``attention_ref``, ``paged_attention_ref``) for CPU tensors.
Kernel 2's counter keys each launch by (B, Sq, Skv, window or 0, dtype
code), kernel 3's by (B, Sq, page size, dtype code).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
import threading

import torch

from . import build

launches = build.LaunchCounter("flash_attention")
# Kernel 2's calls with the softmax statistics out (a subset of
# ``launches``): the sequence-split decode's.
lse_launches = build.LaunchCounter("flash_attention_lse")
paged_launches = build.LaunchCounter("paged_flash_attention")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The schedule's constants, as in csrc/flash_attention.cuh.
SPLIT_ROWS = 16        # kSplitRows: packed rows of a split-path block
# Keys per split by default, at absolute multiples (Vec<T>::kChunk): bf16
# reads half the bytes a key and takes longer splits.  A plan's chunk is
# any positive multiple of the split tile (kv_tile: Vec<T>::kKeys).
SPLIT_CHUNK = {torch.bfloat16: 256, torch.float32: 128}
TILE_ROWS = 64         # kTileRows: packed rows of a tensor-core block
NARROW_D = 128         # kNarrowD: the narrow head-dim class
MAX_D = 256            # kMaxD: the wide class, and the widest head dim


def check_head_dim(name: str, d: int) -> None:
    """Raise unless the kernels take head dim ``d``: a multiple of 8 from
    8 to ``MAX_D``."""
    if d < 8 or d % 8 or d > MAX_D:
        raise ValueError(f"{name}: head dim {d} must be a multiple of 8 "
                         f"from 8 to {MAX_D}")


def head_dim_class(d: int) -> int:
    """The padded width the kernels run head dim ``d`` at: ``NARROW_D``
    up to it, ``MAX_D`` above (``check_head_dim`` first)."""
    check_head_dim("head_dim_class", d)
    return NARROW_D if d <= NARROW_D else MAX_D


def part_bytes(d: int) -> int:
    """One split's partials at head dim ``d``: (m, l) and the padded
    accumulator row of each of its rows, f32."""
    return 4 * SPLIT_ROWS * (head_dim_class(d) + 2)


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """How one attention call runs.  ``path`` is ``"split"`` (split-KV
    decode: grid of kv chunks of ``chunk`` keys at absolute multiples of
    it, partials merged in split order) or ``"tile"`` (blocks of
    ``block_rows`` packed rows over the whole kv range: ``TILE_ROWS``,
    the wgmma warpgroup, in bf16 only (``tensor_cores``), or
    ``SPLIT_ROWS``, the split kernel's loop, mma.sync in bf16 and the
    CUDA cores in f32).  ``rows`` = Sq * group packed rows per kv head."""

    path: str
    b: int
    hkv: int
    rows: int
    block_rows: int
    kv_tile: int
    chunk: int | None
    tensor_cores: bool

    def n_splits(self, skv: int) -> int:
        """Splits of a kv extent ``skv`` (1 on the tile path)."""
        return -(-skv // self.chunk) if self.path == "split" else 1

    def splits(self, skv: int) -> list[tuple[int, int]]:
        """The key ranges of the splits over ``[0, skv)``."""
        if self.path != "split":
            return [(0, skv)]
        return [(s * self.chunk, min((s + 1) * self.chunk, skv))
                for s in range(self.n_splits(skv))]

    def scratch_bytes(self, skv: int, d: int) -> int:
        """Bytes of partials the split path writes for a kv extent
        ``skv`` (kernel 2: the cache length; kernel 3: n_blocks * ps) at
        head dim ``d``."""
        if self.path != "split":
            return 0
        return self.b * self.hkv * self.n_splits(skv) * part_bytes(d)


@functools.lru_cache(maxsize=256)
def attention_plan(b: int, hq: int, hkv: int, sq: int,
                   dtype: torch.dtype) -> AttentionPlan:
    """The schedule of one call, from its batch, heads, query rows and
    dtype only: never from the kv extent, the page size or the layout,
    so kernels 2 and 3 always get the same plan for the same call."""
    rows = sq * (hq // hkv)
    bf16 = dtype == torch.bfloat16
    kv_tile = 64 if bf16 else 32
    if rows <= SPLIT_ROWS:
        return AttentionPlan("split", b, hkv, rows, SPLIT_ROWS, kv_tile,
                             SPLIT_CHUNK[dtype], False)
    return AttentionPlan("tile", b, hkv, rows,
                         TILE_ROWS if bf16 else SPLIT_ROWS, kv_tile, None,
                         bf16)


def tile_schedules(dtype: torch.dtype) -> tuple[int, ...]:
    """The tile path's schedules (block rows) a dtype runs, the prior's
    first: bf16 the wgmma warpgroup and the 16-row loop, f32 the loop."""
    return (TILE_ROWS, SPLIT_ROWS) if dtype == torch.bfloat16 \
        else (SPLIT_ROWS,)


def with_value(prior: AttentionPlan, value: int) -> AttentionPlan:
    """``prior`` with its path's tunable set to ``value``: the keys per
    split on the split path, the block rows (the schedule) on the tile
    path."""
    if prior.path == "split":
        return dataclasses.replace(prior, chunk=int(value))
    return dataclasses.replace(prior, block_rows=int(value),
                               tensor_cores=int(value) == TILE_ROWS)


def check_plan(name: str, plan: AttentionPlan, b: int, hq: int, hkv: int,
               sq: int, dtype: torch.dtype) -> AttentionPlan:
    """Raise unless ``plan`` is one the kernels run for this call: the
    path ``attention_plan`` gives (the C side picks it from the shapes
    too), and on it a chunk that is a positive multiple of the split
    tile, or a tile schedule the dtype has."""
    prior = attention_plan(b, hq, hkv, sq, dtype)
    if plan is prior:
        return plan
    same = (plan.path, plan.b, plan.hkv, plan.rows, plan.kv_tile) == (
        prior.path, prior.b, prior.hkv, prior.rows, prior.kv_tile)
    if plan.path == "split":
        ok = same and plan.block_rows == SPLIT_ROWS \
            and not plan.tensor_cores and plan.chunk is not None \
            and plan.chunk > 0 and plan.chunk % plan.kv_tile == 0
    else:
        ok = same and plan.chunk is None \
            and plan.block_rows in tile_schedules(dtype) \
            and plan.tensor_cores == (plan.block_rows == TILE_ROWS)
    if not ok:
        raise ValueError(f"{name}: plan {plan} is not legal for B={b} "
                         f"Hq={hq} Hkv={hkv} Sq={sq} {dtype} (prior "
                         f"{prior})")
    return plan


_scratch: dict = {}
_bound = threading.local()


@contextlib.contextmanager
def scratch_buffer(buf: torch.Tensor):
    """Give the attention calls inside the block ``buf`` as their scratch,
    in place of the per-stream buffer.  A CUDA graph bakes the scratch
    address into every attention it captures, so whoever captures owns a
    buffer sized for its largest call and holds it as long as its graphs
    (``serve/graphs.DecodeGraphs``)."""
    prev = getattr(_bound, "buf", None)
    _bound.buf = buf
    try:
        yield buf
    finally:
        _bound.buf = prev


def _scratch_ptr(plan: AttentionPlan, skv: int, d: int,
                 device: torch.device, stream: int) -> int:
    """Address of the scratch for ``plan`` at head dim ``d`` (0 when the
    plan needs none):
    the buffer bound by ``scratch_buffer``, which must be large enough,
    or else a grow-only buffer per ``device`` and ``stream`` (the kernels
    of one call, and calls on one stream, run in order).  A graph
    capture must run on a bound buffer: growing a per-stream one would
    free an address an earlier capture baked in."""
    need = plan.scratch_bytes(skv, d)
    if need == 0:
        return 0
    bound = getattr(_bound, "buf", None)
    if bound is not None:
        if bound.numel() < need:
            raise RuntimeError(
                f"attention scratch: the bound buffer holds "
                f"{bound.numel()} bytes, the call needs {need}")
        return bound.data_ptr()
    if build.capturing():
        raise RuntimeError("attention scratch: a graph capture must bind "
                           "its own buffer (scratch_buffer)")
    key = (device.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.empty(need, dtype=torch.uint8, device=device)
        _scratch[key] = buf
    return buf.data_ptr()


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_lens: torch.Tensor | None = None, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None, return_lse: bool = False):
    """Masked full-softmax attention in f32.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), Hq % Hkv == 0 (GQA by head
    index, no repeat); ``kv_lens`` (B,): keys at or past a lane's length
    are padding.  Queries are end-aligned per lane (row r of lane b sits
    at ``kv_lens[b] - Sq + r``); ``window`` keeps keys with
    ``qi - kj < window``.  A row with no visible key gives 0, as the
    flash kernel does.  With ``return_lse`` returns (out, lse): lse (B,
    Hq, Sq) f32 the log-sum-exp of each row's scaled visible scores,
    -inf for a row with none.
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
    out = o.reshape(b, hq, sq, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0, float("-inf"), m + torch.log(l))
    return out, lse.reshape(b, hq, sq)


def _require_card(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def _work(q: torch.Tensor, hkv: int, skv: int, kv_lens, causal: bool,
          window: int | None, extra_bytes: int = 0) -> build.Work:
    """The work this call's data needs: q read and the output written
    once, each kv head's visible keys' K and V read once, the lengths
    (and ``extra_bytes``), 4 * D operations per visible (query row, key):
    on the tensor cores in bf16, on the CUDA cores in f32.  Reads the
    lengths on the host; meta lengths hold no values, and count as every
    lane at Skv (the dry run's decode at its cache's last position)."""
    b, hq, sq, d = q.shape
    lens = torch.full((b,), skv, dtype=torch.long) \
        if kv_lens is None or kv_lens.device.type == "meta" \
        else kv_lens.detach().to("cpu", torch.long)
    # Row r of a lane sits at position qi = len - Sq + r and sees the
    # keys lo..hi: below the length, causal, within the window.  Each
    # row's keys are one interval, and the rows' intervals overlap, so a
    # lane reads the keys from its least lo to its largest hi.
    qi = lens[:, None] - sq + torch.arange(sq)[None]
    hi = torch.minimum(qi, lens[:, None] - 1) if causal \
        else (lens[:, None] - 1).expand(b, sq)
    lo = (qi - window + 1).clamp(min=0) if window is not None \
        else torch.zeros_like(qi)
    n = (hi - lo + 1).clamp(min=0)
    seen = n > 0
    big = torch.iinfo(torch.long).max
    first = torch.where(seen, lo, big).amin(dim=1)
    last = torch.where(seen, hi, -1).amax(dim=1)
    visible = int(n.sum()) * hq
    keys_read = int(torch.where(seen.any(dim=1), last - first + 1,
                                0).sum()) * hkv
    item = q.element_size()
    flops = 4 * d * visible
    return build.Work(
        tensor_flops=flops if q.dtype == torch.bfloat16 else 0,
        other_flops=0 if q.dtype == torch.bfloat16 else flops,
        bytes=(2 * q.numel() + 2 * keys_read * d) * item + 4 * b
        + extra_bytes)


def flash_attention_work(q, k, v, kv_lens=None, *, causal=True,
                         window=None, return_lse=False, **_) -> build.Work:
    """Kernel 2's work for one call (``_work``); with ``return_lse`` the
    rows' f32 statistics written too."""
    b, hq, sq, _ = q.shape
    return _work(q, k.shape[1], k.shape[2], kv_lens, causal, window,
                 extra_bytes=4 * b * hq * sq if return_lse else 0)


def paged_flash_attention_work(q, k_store, v_store, page_table, kv_lens, *,
                               page_size, causal=True, **_) -> build.Work:
    """Kernel 3's: kernel 2's over the gathered view, plus the table
    entries of the pages each lane reads."""
    ps = int(page_size)
    skv = page_table.shape[1] * ps
    lens = kv_lens.detach().to("cpu", torch.long)
    pages = int(((lens.clamp(max=skv) + ps - 1) // ps).sum())
    return _work(q, k_store.shape[1], skv, lens, causal, None,
                 extra_bytes=4 * pages)


@functools.cache
def _fn():
    fn = build.library("flash_attention").repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
    check_head_dim("flash_attention", d)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous, "
                             f"16-byte aligned and on {q.device}")
    if kv_lens.shape != (b,) or kv_lens.dtype != torch.int32 \
            or kv_lens.device != q.device or not kv_lens.is_contiguous():
        raise ValueError("flash_attention: kv_lens must be a contiguous "
                         f"(B,) int32 tensor on {q.device}")


def _plan_of(name: str, plan: AttentionPlan | None, q: torch.Tensor,
             hkv: int) -> AttentionPlan:
    b, hq, sq, _ = q.shape
    if plan is None:
        return attention_plan(b, hq, hkv, sq, q.dtype)
    return check_plan(name, plan, b, hq, hkv, sq, q.dtype)


@build.counted("flash_attention", flash_attention_work)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_lens: torch.Tensor | None = None, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None,
                    plan: AttentionPlan | None = None,
                    return_lse: bool = False):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); kv_lens (B,) int32
    (default: every lane at Skv).  Returns (B, Hq, Sq, D) in q's type, or
    with ``return_lse`` (out, lse): lse (B, Hq, Sq) f32, each row's
    log-sum-exp of its scaled visible scores (-inf for a row with none),
    stored by the kernel that writes the row (``out``'s bits are the
    same either way).  ``plan``: the schedule (default
    ``attention_plan``'s), checked."""
    if build.plain(q):
        if plan is not None and k.dim() == 4:
            _plan_of("flash_attention", plan, q, k.shape[1])
        return attention_ref(q, k, v, kv_lens, causal=causal, window=window,
                             scale=scale, return_lse=return_lse)
    _require_card("flash_attention", q)
    b, hq, sq, d = q.shape
    if kv_lens is None:
        kv_lens = torch.full((b,), k.shape[2], dtype=torch.int32,
                             device=q.device)
    _check(q, k, v, kv_lens)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    hkv, skv = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    plan = _plan_of("flash_attention", plan, q, hkv)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(),
                out.data_ptr(), None if lse is None else lse.data_ptr(),
                _scratch_ptr(plan, skv, d, q.device, stream), b,
                hq, hkv, sq, skv, d, float(scale), int(causal),
                0 if window is None else int(window), _DTYPES[q.dtype],
                plan.chunk or 0, plan.block_rows, stream)
    build.check(err, "flash_attention")
    launches.add((b, sq, skv, 0 if window is None else int(window),
                  _DTYPES[q.dtype]))
    if lse is None:
        return out
    lse_launches.add((b, sq, skv, _DTYPES[q.dtype]))
    return out, lse


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
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
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
    check_head_dim("paged_flash_attention", d)
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


@build.counted("paged_flash_attention", paged_flash_attention_work)
def paged_flash_attention(q: torch.Tensor, k_store: torch.Tensor,
                          v_store: torch.Tensor, page_table: torch.Tensor,
                          kv_lens: torch.Tensor, *, page_size: int,
                          causal: bool = True,
                          scale: float | None = None,
                          plan: AttentionPlan | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D), end-aligned per lane; k_store, v_store:
    (n_pages * page_size, Hkv, D); page_table (B, n_blocks) int32 (lane
    b's key kj sits at store row ``page_table[b, kj // ps] * ps + kj %
    ps``); kv_lens (B,) int32.  Returns (B, Hq, Sq, D) in q's type.
    ``plan`` as for ``flash_attention``: the same call takes the same
    plan in both kernels, so they give the same bits."""
    _check_paged(q, k_store, v_store, page_table, kv_lens, page_size)
    plan = _plan_of("paged_flash_attention", plan, q, k_store.shape[1])
    if build.plain(q):
        return paged_attention_ref(q, k_store, v_store, page_table, kv_lens,
                                   page_size=page_size, causal=causal,
                                   scale=scale)
    _require_card("paged_flash_attention", q)
    b, hq, sq, d = q.shape
    ps = int(page_size)
    hkv, n_blocks = k_store.shape[1], page_table.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    err = _paged_fn()(
        q.data_ptr(), k_store.data_ptr(), v_store.data_ptr(),
        page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        _scratch_ptr(plan, n_blocks * ps, d, q.device, stream), b, hq, hkv,
        sq, n_blocks, ps, k_store.shape[0] // ps, d, float(scale),
        int(causal), _DTYPES[q.dtype], plan.chunk or 0, plan.block_rows,
        stream)
    build.check(err, "paged_flash_attention")
    paged_launches.add((b, sq, ps, _DTYPES[q.dtype]))
    return out
