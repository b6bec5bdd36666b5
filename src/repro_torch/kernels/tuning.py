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
"""
from __future__ import annotations

import dataclasses
import math

from ..core.overhead_law import DEFAULT_CHUNKS_PER_CORE

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
