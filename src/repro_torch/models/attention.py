"""Self-attention (the counterpart of ``repro.models.attention``):
full causal self-attention for training and one-shot prefill, and the
serve path's attention with a KV cache (``self_attention``'s cached
branch, the counterpart of ``_cache_attention``).

Without a cache, q, k and v of the whole sequence go through ``sdpa``,
whose three implementations share one signature:

* ``chunked`` — ``attention_chunked``: online softmax over kv blocks in
  plain PyTorch (f32 inside), differentiable by autograd; what training
  runs, as in the reference;
* ``naive`` — full softmax (``kernels.flash_attention.attention_ref``);
* ``flash`` — kernel 2 (``kernels.flash_attention.flash_attention``),
  forward only: the CUDA kernel has no backward, as ``pallas_call`` has
  no autodiff rule, so it raises under grad for an input that requires
  grad.

With a cache, the cache is updated in place: the new K/V rows are
written at their positions and attention runs over the cache through a
flash-attention kernel (``kernels/flash_attention.py``, called through
``kernels/ops.py``: with a kernel tuner in ``flags.KERNEL_TUNER`` each
call's plan is measured on the call itself, with none the analytic
prior holds).  Two cache layouts:

* contiguous (the slot pool): per layer ``{"k","v"}`` of shape
  ``(B, Hkv, S, D)``; attention through ``flash_attention``, whose
  per-lane ``kv_lens`` lets one call serve a prefill chunk into one slot
  and a decode step over the whole slot pool;
* paged (``PagedKVCachePool``): per layer flat token-major stores
  ``(n_pages * ps, Hkv, D)`` read through a page table; the new rows land
  with one ``index_copy_`` per store and attention runs through
  ``paged_flash_attention`` straight off the pages (no contiguous view
  is gathered), except under the "head_dim" split below, whose rank
  holds D / n dims of every row: its lanes' rows are gathered through
  the table and attended by ``split_dim_attention``.

Under a sliding window ``W`` the contiguous cache is a ring of ``S =
min(W, max_len)`` rows (``init_cache``; the counterpart of the
reference's ring buffer): position ``p`` lives in row ``p % S``.  Three
cases, all through kernel 2:

* per-lane rows (the decode step, one row a lane): written at ``p % S``,
  then attention over the ``min(p + 1, S)`` rows the ring holds, which
  are exactly the window (no window mask: rows are not in position
  order);
* a chunk before the wrap (``p + L <= S``): rows are positions, so it is
  the plain path with the causal and window masks;
* a chunk after the wrap (``p >= S``): its queries must see the ring's
  oldest rows, which its own write would overwrite.  The ring's rows in
  position order (rolled by ``p % S``) and then the chunk's own K/V are
  gathered into a scratch buffer, attention runs over it causal,
  window ``W``, end-aligned, and only then is the chunk written.

A chunk never crosses the ring's end (the scheduler's ``_segment`` and
``engine.prefill_segments`` cut there); one that would raises.  The
reference's ``_ring_attention`` masks only the populated slots, with no
causal mask, so its chunked prefill lets a query see later positions of
its own chunk; here a chunk gives ``lm.forward``'s values (ROADMAP.md,
faults of the reference).  The paged pool refuses windows, as the
reference's does.

``jax.lax.dynamic_update_slice`` clamps a write that would run past the
cache; here such a write raises instead.

Under a sequence split (``flags.SEQ``: the reference's caches with their
sequence on 'data' when the batch does not split, or on 'model' under
``--cache-seq-model``) each rank holds one contiguous block of the rows
and a decode step runs ``_seq_split_attention``: the new row written on
its owner, kernel 2 over each block with its rows' log-sum-exp, the
ranks' results gathered and merged by ``merge_blocks``.

``cross_attention`` (the vision family's ``cross_attn`` layers) attends
the frontend features: ``kv_norm`` on them, K/V projected from them,
non-causal, no rotary embedding.  Without a cache it goes through
``sdpa(impl=...)`` (training: "chunked"); on the serve path
(``impl="flash"``) through kernel 2 with ``causal=False``.  No K/V are
cached: as in the reference, every step projects them from the features
again (ROADMAP.md, speed items).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .. import collectives
from ..configs.base import ArchConfig
from ..kernels import build
from ..kernels import ops as kops
from ..kernels.flash_attention import attention_ref
from . import common as cm
from . import flags


# ---------------------------------------------------------------------------
# full-sequence attention (train / one-shot prefill)
# ---------------------------------------------------------------------------

def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      kv_len: int | None = None, scale: float | None = None,
                      block_kv: int = 1024) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).

    Online softmax over kv blocks in f32 (peak memory O(Sq · block_kv)),
    GQA by head index without a repeat; ``kv_len`` masks slots at or past
    it, and q rows are end-aligned: row r sits at ``kv_len - Sq + r``.
    Differentiable by autograd; a block with no visible key for a row
    adds nothing to it (no NaN on the way forward or back).
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kv_len = skv if kv_len is None else kv_len
    block_kv = min(block_kv, skv)
    nblocks = -(-skv // block_kv)
    pad = nblocks * block_kv - skv
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    qg = q.reshape(b, hkv, group, sq, d).float() * scale
    qi = (kv_len - sq) + torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, group, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, hkv, group, sq), device=q.device)
    acc = torch.zeros((b, hkv, group, sq, d), device=q.device)
    for j in range(nblocks):
        kblk = k[:, :, j * block_kv:(j + 1) * block_kv].float()
        vblk = v[:, :, j * block_kv:(j + 1) * block_kv].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kblk)
        kj = j * block_kv + torch.arange(block_kv, device=q.device)
        mask = (kj[None, :] < kv_len).expand(sq, block_kv)
        if causal:
            mask = mask & (qi[:, None] >= kj[None, :])
        if window is not None:
            mask = mask & ((qi[:, None] - kj[None, :]) < window)
        s = s.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # A row with no visible key so far keeps m = -inf; shift it by 0.
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None])
        alpha = torch.exp(m - m_safe)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                    vblk)
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l_safe[..., None]).to(q.dtype)
    return out.reshape(b, hq, sq, d)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         impl: str = "chunked", causal: bool = True,
         window: int | None = None, kv_len: int | None = None,
         scale: float | None = None) -> torch.Tensor:
    """Full-sequence attention, q: (B, Hq, Sq, D), k, v: (B, Hkv, Skv, D),
    by ``impl``: "chunked", "naive" or "flash" (kernel 2, forward only)."""
    if impl == "chunked":
        return attention_chunked(q, k, v, causal=causal, window=window,
                                 kv_len=kv_len, scale=scale)
    if impl not in ("naive", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    lens = None if kv_len is None else torch.full(
        (q.shape[0],), kv_len, dtype=torch.int32, device=q.device)
    if impl == "naive":
        return attention_ref(q, k, v, lens, causal=causal, window=window,
                             scale=scale)
    build.refuse_grad("flash attention (kernel 2, forward only)",
                      "attn_impl='chunked' to train", q, k, v)
    return kops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), lens, causal=causal,
                                window=window, scale=scale,
                                tuner=flags.KERNEL_TUNER)


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


def _heads(x: torch.Tensor, hd: int) -> torch.Tensor:
    """(B, L, H·hd) → (B, L, H, hd); H is the heads this rank holds (all
    of them, or its block under tensor parallelism)."""
    b, s, width = x.shape
    return x.view(b, s, width // hd, hd)


def _rule(family: str) -> str:
    """The attention rule of ``family`` ("attn" or "xattn") under the
    tensor-parallel context: "whole" with none."""
    tp = flags.TP
    return "whole" if tp is None else getattr(tp, family)


def _out(p: dict, out: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """``wo`` of the heads' outputs (B, H, L, D) → (B, L, d); row-parallel
    under a tensor-parallel context that splits the block (a "head_dim"
    rank's D / n dims of every head meet its rows of ``wo``)."""
    b, h, length, hd = out.shape
    out = out.transpose(1, 2).reshape(b, length, h * hd)
    return cm.linear_rows(p["wo"], out, cd,
                          split=flags.heads_split(_rule("attn")))


def _shared_kv(p: dict, x: torch.Tensor, cd: torch.dtype, hd: int,
               n_kv: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The "kv_shared" K/V: this rank's contiguous columns of ``wk`` and
    ``wv`` (the reference's split), the ranks' columns gathered over
    'model' in one ``all_gather`` (backward: the gradient's block summed
    over the ranks, ``collectives.gather_rows``), and the one kv head
    this rank's q heads read, ``index · n_kv // size``, kept: (B, L, 1,
    D) each."""
    tp = flags.TP
    b, length, _ = x.shape
    k = cm.linear(p["wk"], x, cd)
    v = cm.linear(p["wv"], x, cd)
    cols = k.shape[-1]
    both = collectives.gather_rows(torch.cat([k, v], dim=-1), tp.group,
                                   tp.size, tp.index, -1)
    both = both.view(b, length, tp.size, 2, cols)
    head = tp.index * n_kv // tp.size
    k = both[:, :, :, 0].reshape(b, length, n_kv, hd)[:, :, head:head + 1]
    v = both[:, :, :, 1].reshape(b, length, n_kv, hd)[:, :, head:head + 1]
    return k, v


def _rope_block(cos: torch.Tensor, sin: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rotary angles of a "head_dim" rank's dims: its block of the
    D / 2 frequencies (its dims of each half of a head are the same
    block, ``launch/sharding._head_dim_spec``)."""
    tp = flags.TP
    w = cos.shape[-1] // tp.size
    lo = tp.index * w
    return cos[..., lo:lo + w], sin[..., lo:lo + w]


def self_attention(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                   rope: tuple[torch.Tensor, torch.Tensor],
                   window: int | None, cache: dict | None = None,
                   write: CacheWrite | None = None,
                   impl: str = "chunked") -> torch.Tensor:
    """x: (B, L, d); rope: the (cos, sin) of the positions, (B, L, D/2)
    each, computed once per forward (the counterpart of the reference's
    ``positions``).  Without a cache: full causal self-attention over the
    L positions through ``sdpa(impl=...)`` (train / one-shot prefill).
    With a cache {"k","v"}: (B, Hkv, S, D), or the paged stores
    (n_pages * ps, Hkv, D) when ``write.page_table`` is set, the new K/V
    are written as ``write`` says and attention runs over the cache.
    The head counts are the projections' widths over ``head_dim``: under
    a tensor-parallel context (``flags.TP``) that splits the block, ``x``
    goes through *f* (``common.block_input``), ``wo`` is row-parallel
    and, by the attention rule: "split", this rank's block of heads, its
    cache holding its block of kv heads; "kv_shared", its block of q
    heads and the one kv head they read (``_shared_kv``), its cache
    holding that head; "head_dim", its rotary-paired D / n dims of
    every head and cache row (``_head_dim_attention``)."""
    hd = cfg.head_dim_
    cd = getattr(torch, cfg.compute_dtype)
    rule = _rule("attn")
    split = flags.heads_split(rule)
    x = cm.block_input(x, split)
    cos, sin = rope
    if rule == "head_dim":
        # This rank's D / n dims of every head, in rotary pairs.
        hd = hd // flags.TP.size
        cos, sin = _rope_block(cos, sin)
    q = _heads(cm.linear(p["wq"], x, cd), hd)
    if rule == "kv_shared":
        k, v = _shared_kv(p, x, cd, hd, cfg.n_kv_heads)
    else:
        k = _heads(cm.linear(p["wk"], x, cd), hd)
        v = _heads(cm.linear(p["wv"], x, cd), hd)
    if cfg.qk_norm:
        # The q/k-norm gains are replicated: under split heads each model
        # rank holds part of their gradient (*f* sums it).
        q, k = cm.qk_norm_rope(
            {"g": cm.column_input(p["q_norm"]["g"], split)},
            {"g": cm.column_input(p["k_norm"]["g"], split)}, q, k, cos, sin,
            cfg.norm_eps)
    else:
        q = cm.apply_rope(q, cos, sin)
        k = cm.apply_rope(k, cos, sin)

    if cache is None:
        if rule == "head_dim":
            raise NotImplementedError(
                "the head_dim attention split runs on the cached path only; "
                "a full-sequence forward runs such a block whole "
                "(launch/sharding.tp_plan, cached=False)")
        out = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   impl=impl, causal=True, window=window)
        return _out(p, out, cd)

    ck, cv = cache["k"], cache["v"]
    qt = q.transpose(1, 2).contiguous()
    if write.page_table is not None and window is not None:
        raise ValueError("paged KV caches do not hold sliding-window (SWA) "
                         "rings; use the contiguous slot pool")
    if rule == "head_dim":
        if write.page_table is not None:
            _paged_write(k, v, ck, cv, write)
            out = _paged_head_dim_attention(qt, ck, cv, write,
                                            cfg.head_dim_)
        else:
            out = _head_dim_attention(qt, k.transpose(1, 2),
                                      v.transpose(1, 2), ck, cv, write,
                                      window, cfg.head_dim_)
        return _out(p, out, cd)
    if write.page_table is not None:
        _paged_write(k, v, ck, cv, write)
        out = kops.paged_flash_attention(
            qt, ck, cv, write.page_table, write.kv_lens,
            page_size=write.page_size, causal=True,
            tuner=flags.KERNEL_TUNER)
    else:
        out = _cached_attention(qt, k.transpose(1, 2), v.transpose(1, 2),
                                ck, cv, write, window)
    return _out(p, out, cd)


def _paged_write(k: torch.Tensor, v: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor, write: CacheWrite) -> None:
    """The new K/V rows, k, v (B, L, Hkv, D) token-major as the stores
    are, into the paged stores at ``write.flat`` (a dropped lane's rows
    to the scratch page 0)."""
    if write.rows is not None:
        k, v = k[write.rows], v[write.rows]
    hkv, hd = k.shape[2], k.shape[3]
    ck.index_copy_(0, write.flat, k.reshape(-1, hkv, hd).to(ck.dtype))
    cv.index_copy_(0, write.flat, v.reshape(-1, hkv, hd).to(cv.dtype))


def _paged_head_dim_attention(qt: torch.Tensor, ck: torch.Tensor,
                              cv: torch.Tensor, write: CacheWrite,
                              head_dim: int) -> torch.Tensor:
    """Attention over the paged stores under the "head_dim" rule: every
    store row holds this rank's D / n dims of every kv head (the K
    already rotated by the rank's block of the frequencies when it was
    written).  Each lane's rows are read through its page table into a
    (B, Hkv, n_blocks · ps, D / n) view, in position order, and attended
    through ``split_dim_attention``; rows at or past a lane's length
    (unmapped blocks read the scratch page 0) are masked.  Plain ops:
    kernel 3 reads whole heads."""
    ps = write.page_size
    table = write.page_table.long()
    b = table.shape[0]
    rows = (table[:, :, None] * ps
            + torch.arange(ps, device=table.device)).reshape(b, -1)
    k = ck[rows].transpose(1, 2)
    v = cv[rows].transpose(1, 2)
    return split_dim_attention(qt, k, v, write.kv_lens, None,
                               scale=1.0 / math.sqrt(head_dim),
                               group=flags.TP.group)


def merge_blocks(o: torch.Tensor, lse: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention over a cache cut into blocks, from each block's
    attention and its rows' log-sum-exp: o (n, B, Hq, Sq, D) in any
    float type, lse (n, B, Hq, Sq) f32, the blocks in order.  Returns
    (o (B, Hq, Sq, D) in o's type, lse (B, Hq, Sq) f32): each block's
    output weighted by ``exp(lse - max lse)`` and the weights' sum
    divided out, in f32, summed in block order (so every rank that
    merges the same blocks gets the same bits).  A block with no visible
    key (lse -inf) weighs 0; a row with none in any block gives 0 and
    -inf, as kernel 2 does."""
    top = lse.amax(dim=0)
    base = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lse - base)                       # 0 where lse is -inf
    num = (o.float() * w[..., None]).sum(dim=0)
    den = w.sum(dim=0)
    out = torch.where(den[..., None] > 0,
                      num / torch.where(den > 0, den, 1.0)[..., None], 0.0)
    return out.to(o.dtype), torch.where(den > 0, base + torch.log(den),
                                        float("-inf"))


def _seq_split_attention(qt: torch.Tensor, kt: torch.Tensor,
                         vt: torch.Tensor, ck: torch.Tensor,
                         cv: torch.Tensor, write: CacheWrite,
                         window: int | None, seq) -> torch.Tensor:
    """A decode step over a cache whose rows are cut into ``seq.size``
    contiguous blocks, this rank's ``ck``/``cv`` (B, Hkv, S_r, D) block
    ``seq.index`` (``flags.SEQ``): the new row is written on the rank
    that holds its global row (``pos``, or ``pos % S`` in a ring); each
    rank runs kernel 2 over its block with its own lengths, clamp(len -
    offset, 0, S_r), and the rows' log-sum-exp out; the ranks' (o, lse),
    packed in one f32 buffer, are gathered in rank order and merged
    (``merge_blocks``).  A ring holds exactly the window, so no window
    mask is applied, as on the per-lane path."""
    length, blk = qt.shape[2], ck.shape[2]
    if not isinstance(write.pos, int) or length != 1:
        raise NotImplementedError(
            "a cache with its sequence on a mesh axis takes one new row "
            "at one position for the whole batch (a decode step); prefill "
            "it row by row")
    total = blk * seq.size
    lo = seq.index * blk
    pos = write.pos
    at = pos % total if window is not None else pos
    if pos < 0 or at >= total:
        raise ValueError(f"cache write at {pos} runs past the cache length "
                         f"{total}")
    if lo <= at < lo + blk:
        ck[:, :, at - lo] = kt[:, :, 0].to(ck.dtype)
        cv[:, :, at - lo] = vt[:, :, 0].to(cv.dtype)
    filled = min(pos + 1, total)
    lens = torch.full((qt.shape[0],), min(max(filled - lo, 0), blk),
                      dtype=torch.int32, device=qt.device)
    o, lse = kops.flash_attention(qt, ck, cv, lens, causal=True,
                                  tuner=flags.KERNEL_TUNER, return_lse=True)
    # One gather a layer: o (exact in f32) and lse packed side by side.
    both = collectives.gather_stack(
        torch.cat([o.float(), lse[..., None]], dim=-1), seq.group, seq.size)
    return merge_blocks(both[..., :-1], both[..., -1])[0].to(o.dtype)


def _kernel2(qt: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lens: torch.Tensor, window: int | None) -> torch.Tensor:
    return kops.flash_attention(qt, k, v, lens, causal=True, window=window,
                                tuner=flags.KERNEL_TUNER)


def split_dim_attention(qt: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lens: torch.Tensor, window: int | None, *,
                        scale: float, group) -> torch.Tensor:
    """Causal attention over the ranks' blocks of every head's dims: qt
    (B, Hq, Sq, D_r), k, v (B, Hkv, Skv, D_r) this rank's dims, ``lens``
    (B,) the keys each lane attends, queries end-aligned (as kernel 2).
    The partial logits q_r · k_rᵀ in f32 summed over ``group`` (one
    ``all_reduce``), then the scale of the whole head dim, the length,
    causal and window masks and the softmax, as ``attention_ref``
    computes them; P · v_r gives this rank's dims of the output.  Plain
    ops: no kernel runs a contraction split across ranks."""
    b, hq, sq, dr = qt.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = qt.reshape(b, hkv, hq // hkv, sq, dr).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    s = collectives.reduce_from_model(s.contiguous(), group) * scale
    lens = lens.to(device=qt.device, dtype=torch.long)
    kj = torch.arange(skv, device=qt.device)
    qi = lens[:, None] - sq + torch.arange(sq, device=qt.device)[None, :]
    mask = (kj[None, None, :] < lens[:, None, None]) \
        & (qi[:, :, None] >= kj[None, None, :])
    if window is not None:
        mask = mask & ((qi[:, :, None] - kj[None, None, :]) < window)
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    top = s.amax(dim=-1, keepdim=True)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    pexp = torch.exp(s - top)
    den = pexp.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", pexp, v.float())
    o = torch.where(den == 0, torch.zeros_like(o),
                    o / torch.where(den == 0, torch.ones_like(den), den))
    return o.reshape(b, hq, sq, dr).to(qt.dtype)


def _head_dim_attention(qt: torch.Tensor, kt: torch.Tensor,
                        vt: torch.Tensor, ck: torch.Tensor,
                        cv: torch.Tensor, write: CacheWrite,
                        window: int | None, head_dim: int) -> torch.Tensor:
    """The contiguous cache's write and attention under the "head_dim"
    rule: every tensor holds this rank's D / n dims of every head, and
    ``_cached_attention``'s three cases (per-lane rows, a chunk in
    position order, a chunk past the ring's wrap, which reads the ring
    in position order) each attend through ``split_dim_attention``."""
    if flags.SEQ is not None:
        raise NotImplementedError(
            "a cache with its sequence on a mesh axis under the head_dim "
            "attention split")
    group = flags.TP.group

    def attend(q, k, v, lens, win):
        return split_dim_attention(q, k, v, lens, win,
                                   scale=1.0 / math.sqrt(head_dim),
                                   group=group)

    return _cached_attention(qt, kt, vt, ck, cv, write, window, attend)


def _cached_attention(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                      ck: torch.Tensor, cv: torch.Tensor, write: CacheWrite,
                      window: int | None, attend=_kernel2) -> torch.Tensor:
    """The contiguous cache's write and attention: qt (B, Hq, L, D); kt,
    vt (B, Hkv, L, D) the new rows; ck, cv (B, Hkv, S, D), a ring of S
    rows under ``window`` (the module docstring's three cases), or one
    block of the rows under a sequence split (``flags.SEQ``).
    ``attend(q, k, v, lens, window)``: the attention itself, kernel 2
    unless the caller gives another."""
    if flags.SEQ is not None:
        return _seq_split_attention(qt, kt, vt, ck, cv, write, window,
                                    flags.SEQ)
    length, s_cache = qt.shape[2], ck.shape[2]
    kt, vt = kt.to(ck.dtype), vt.to(cv.dtype)
    if not isinstance(write.pos, int):
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
        # No window mask: a ring (one row per lane) holds exactly the
        # window, and its rows are not in position order.
        return attend(qt, ck, cv, write.kv_lens, None)
    at = write.pos % s_cache if window is not None else write.pos
    if write.pos < 0 or at + length > s_cache:
        raise ValueError(
            f"cache write of {length} rows at {write.pos} runs past the "
            f"cache length {s_cache}"
            + (" (a chunk may not cross the ring's end)"
               if window is not None else ""))
    if write.pos + length <= s_cache:
        # Rows are positions (always so without a window).
        ck[:, :, at:at + length] = kt
        cv[:, :, at:at + length] = vt
        return attend(qt, ck, cv, write.kv_lens, window)
    # A chunk past the wrap: the ring in position order, then the chunk,
    # attended before the chunk overwrites the ring's oldest rows.
    order = (at + torch.arange(s_cache, device=ck.device)) % s_cache
    kbuf = torch.cat([ck.index_select(2, order), kt], dim=2)
    vbuf = torch.cat([cv.index_select(2, order), vt], dim=2)
    out = attend(qt, kbuf, vbuf, write.kv_lens, window)
    ck[:, :, at:at + length] = kt
    cv[:, :, at:at + length] = vt
    return out


def cross_attention(p: dict, x: torch.Tensor, kv_feats: torch.Tensor,
                    cfg: ArchConfig, *, impl: str = "chunked"
                    ) -> torch.Tensor:
    """x: (B, L, d) queries; kv_feats: (B, T, d) frontend embeddings.
    Non-causal, no rotary embedding; q/k-norm only if the config sets
    it.  ``impl``: ``sdpa``'s ("flash": kernel 2).  Under a
    tensor-parallel context that splits the heads (``flags.TP.xattn``)
    the projections are this rank's heads, ``kv_norm`` runs over the
    whole features on every rank and ``wo`` is row-parallel."""
    hd = cfg.head_dim_
    cd = getattr(torch, cfg.compute_dtype)
    rule = _rule("xattn")
    split = flags.heads_split(rule)
    # Every rank norms the whole features; its heads read them (*f*).
    feats = cm.column_input(
        cm.rmsnorm(p["kv_norm"], kv_feats.to(cd), cfg.norm_eps), split)
    x = cm.block_input(x, split)
    b, length, _ = x.shape
    q = _heads(cm.linear(p["wq"], x, cd), hd)
    if rule == "kv_shared":
        k, v = _shared_kv(p, feats, cd, hd, cfg.n_kv_heads)
    else:
        k = _heads(cm.linear(p["wk"], feats, cd), hd)
        v = _heads(cm.linear(p["wv"], feats, cd), hd)
    if cfg.qk_norm:
        q = cm.rmsnorm({"g": cm.column_input(p["q_norm"]["g"], split)}, q,
                       cfg.norm_eps)
        k = cm.rmsnorm({"g": cm.column_input(p["k_norm"]["g"], split)}, k,
                       cfg.norm_eps)
    out = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               impl=impl, causal=False)
    out = out.transpose(1, 2).reshape(b, length, q.shape[2] * hd)
    return cm.linear_rows(p["wo"], out, cd, split=split)


def local_kv(cfg: ArchConfig, tp) -> tuple[int, int]:
    """(kv heads, head dim) of this rank's K/V cache under ``tp`` (a
    ``launch/sharding.TPPlan`` or ``flags.TensorParallel``, or None):
    its Hkv / n heads ("split"), the one kv head its q heads read
    ("kv_shared"), D / n dims of every head ("head_dim"), or all of
    them."""
    hkv, d = cfg.n_kv_heads, cfg.head_dim_
    rule = "whole" if tp is None else tp.attn
    if rule == "split":
        return hkv // tp.size, d
    if rule == "kv_shared":
        return 1, d
    if rule == "head_dim":
        return hkv, d // tp.size
    return hkv, d


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               window: int | None, dtype: torch.dtype,
               device: torch.device, tp=None, seq_blocks: int = 1) -> dict:
    """Per-layer ``{"k","v"}`` of shape (B, Hkv, S, D): ``S = max_len``,
    or under a window the ring's ``min(window, max_len)`` rows.  On a
    mesh rank: ``tp`` (a plan that splits the attention heads) gives its
    kv heads and head dim (``local_kv``), and ``seq_blocks`` its S /
    seq_blocks rows."""
    s = min(window, max_len) if window is not None else max_len
    if s % seq_blocks:
        raise ValueError(f"{s} cache rows do not split into {seq_blocks} "
                         f"blocks")
    hkv, d = local_kv(cfg, tp)
    shape = (batch, hkv, s // seq_blocks, d)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
