"""Adaptive block selection for the 1-d kernels — the paper's chunking
model applied to the card's kernel grid.

The thread blocks of a kernel run in parallel on the card's SMs, several
resident on each.  The paper's quantities map as:

* "core"            → an SM.  The count is read from the device
  (``multi_processor_count``) by the caller and passed in, so the same
  plan can be made for another card, or for the CPU (one "SM");
* "chunk"           → one thread block's elements;
* C = ``DEFAULT_CHUNKS_PER_CORE`` blocks per SM: enough resident blocks
  to keep each SM's loads in flight, and a straggling block costs at most
  1/C of an SM's share (the paper's load-balance argument);
* T_m floor         → a block holds at least one tile: one full block of
  ``THREADS`` threads with 16 bytes a thread, so no thread idles and each
  warp's loads are whole transactions.  Blocks are whole tiles.

The TPU's VMEM budget bounds a block where a kernel stages the whole block
in fast memory (``max_block_1d`` in the reference).  The port's
counterpart is the scan's segment: the scan stages a segment in shared
memory, at most 32 KiB (``reduce_scan.scan_seg_max``, kScanSegMax in the
CUDA source), and walks a larger block as several segments
(``reduce_scan.scan_plan``), so every block stays legal.  The other 1-d
kernels stream their block and take any size.

Kernels 1-3 take measured plans too (``autotune.KernelTuner``); their
candidates live here, the analytic prior first, every one legal for the
call (the counterpart of the reference's ``candidates_attention``):

* attention, split path: keys per split around the prior (``/4 .. x4``),
  whole split tiles, within [one tile, the kv extent rounded up to one];
  the graphs reserve the largest scratch of any candidate
  (``attention_scratch_reserve``), so no candidate outgrows it;
* attention, tile path: the schedules the dtype runs
  (``flash_attention.tile_schedules``);
* kernel 1's forward: warps per block (``rmsnorm.WARPS``, the default
  first: a row's arithmetic does not depend on the block, so every one
  gives the same bits and is legal for any rows).
"""
from __future__ import annotations

import dataclasses
import math

from ..core.overhead_law import DEFAULT_CHUNKS_PER_CORE
from . import flash_attention as kfa

THREADS = 256            # threads of one block (csrc/elem1d.cuh kThreads)
BYTES_PER_THREAD = 16    # one tile gives each thread 16 bytes


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def tile_elems(bytes_per_elem: int) -> int:
    """Elements of one tile: 1024 for f32, 2048 for bf16."""
    return THREADS * max(BYTES_PER_THREAD // int(bytes_per_elem), 1)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    block: int          # elements of one thread block
    grid: int           # number of thread blocks


def plan_1d(n: int, *, num_sms: int, bytes_per_elem: int = 4,
            chunks_per_core: int = DEFAULT_CHUNKS_PER_CORE) -> BlockPlan:
    """Block size for a 1-d kernel over ``n`` elements.

    Eq. 10 with N_C = ``num_sms``: block = n / (C · num_sms), rounded
    down to whole tiles and floored at one tile, so the grid has at least
    C blocks per SM wherever ``n`` allows it.
    """
    n = max(int(n), 1)
    tile = tile_elems(bytes_per_elem)
    per_block = n // (max(int(chunks_per_core), 1) * max(int(num_sms), 1))
    block = max((per_block // tile) * tile, tile)
    return BlockPlan(block=block, grid=math.ceil(n / block))


def check_1d(name: str, x, block: int, dtypes: dict) -> int:
    """Raise unless ``x`` is what a 1-d kernel takes: a contiguous 1-d
    CUDA tensor of one of ``dtypes``, and a positive block.  Returns the
    kernel's dtype code."""
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"({', '.join(str(d)[6:] for d in dtypes)})")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous 1-d tensor, got "
                         f"shape {tuple(x.shape)}")
    if int(block) < 1:
        raise ValueError(f"{name}: block must be positive, got {block}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return dtypes[x.dtype]


def candidates_attention(b: int, hq: int, hkv: int, sq: int, skv: int,
                         dtype) -> list[kfa.AttentionPlan]:
    """Candidate plans of one attention call over a kv extent ``skv``,
    the analytic prior (``attention_plan``, its chunk snapped to the
    range) first, no duplicates."""
    prior = kfa.attention_plan(b, hq, hkv, sq, dtype)
    if prior.path == "tile":
        return [kfa.with_value(prior, r) for r in kfa.tile_schedules(dtype)]
    tile = prior.kv_tile
    cap = round_up(max(int(skv), 1), tile)
    out: list[int] = []
    for c in (prior.chunk, prior.chunk // 4, prior.chunk // 2,
              prior.chunk * 2, prior.chunk * 4):
        c = min(max((c // tile) * tile, tile), cap)
        if c not in out:
            out.append(c)
    return [kfa.with_value(prior, c) for c in out]


def cap_attention(plan: kfa.AttentionPlan, skv: int) -> kfa.AttentionPlan:
    """A winner stored for a bucket-mate with a longer kv extent, capped
    to this call's (the splits past the extent are empty either way)."""
    if plan.path != "split":
        return plan
    cap = round_up(max(int(skv), 1), plan.kv_tile)
    return plan if plan.chunk <= cap else kfa.with_value(plan, cap)


def attention_scratch_reserve(b: int, hq: int, hkv: int, widths, skv: int,
                              dtype, d: int) -> int:
    """The largest scratch any candidate plan of any of ``widths`` (query
    lengths) needs over ``skv`` at head dim ``d``: what a capture must
    bind so that every plan a tuner may pick fits."""
    return max((p.scratch_bytes(skv, d) for sq in widths
                for p in candidates_attention(b, hq, hkv, sq, skv, dtype)),
               default=0)
