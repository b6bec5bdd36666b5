"""``attention_plan``: the schedule kernels 2 and 3 share, on the CPU.

The plan is a pure function of (B, Hq, Hkv, Sq, dtype): split-KV decode
for at most 16 packed query rows per kv head, the tile path above it.
These tests pin the main path's shapes to their schedules, the split
boundaries to absolute multiples of one constant whatever the kv extent
or page size, the scratch the split path needs, the agreement of the
Python plan with the CUDA source that makes the same choice, and that no
library call computes attention.  The plain version at the plan's edges
is held against the Pallas kernel in interpret mode.  The kernels
themselves run only on the card (``chip_smoke.py``'s edge sweep).
"""
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as K
from repro_torch.kernels import flash_attention as tfa

CSRC = pathlib.Path(tfa.__file__).resolve().parent / "csrc"
HEADER = (CSRC / "flash_attention.cuh").read_text()

# qwen3-0.6b: 16 q heads over 8 kv heads (group 2), serve max_len 1024,
# 8 slots; the page sizes the paged pool may pick.
HQ, HKV, SLOTS, MAX_LEN = 16, 8, 8, 1024
PAGE_SIZES = (1, 8, 16, 32, 64, 100)
DTYPES = (torch.bfloat16, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq", [1, 2, 4, 8])
def test_main_path_decode_and_verify_take_the_split_path(sq, dtype):
    plan = tfa.attention_plan(SLOTS, HQ, HKV, sq, dtype)
    assert plan.path == "split"
    assert plan.rows == 2 * sq <= tfa.SPLIT_ROWS
    assert plan.chunk == tfa.SPLIT_CHUNK[dtype]
    assert plan.block_rows == tfa.SPLIT_ROWS
    assert not plan.tensor_cores


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq", [16, 32, 128, 256])
def test_main_path_prefill_chunks_take_the_tile_path(sq, dtype):
    plan = tfa.attention_plan(1, HQ, HKV, sq, dtype)
    assert plan.path == "tile"
    assert plan.chunk is None
    assert plan.scratch_bytes(MAX_LEN) == 0
    # bf16 on the tensor cores in 64-row blocks; f32 stays IEEE f32 on
    # the CUDA cores in 16-row blocks.
    if dtype == torch.bfloat16:
        assert plan.tensor_cores and plan.block_rows == tfa.TILE_ROWS == 64
    else:
        assert not plan.tensor_cores and plan.block_rows == tfa.SPLIT_ROWS


@pytest.mark.parametrize("hq,hkv,sq,path", [
    (16, 8, 8, "split"), (16, 8, 9, "tile"),     # group 2: 16 / 18 rows
    (4, 4, 16, "split"), (4, 4, 17, "tile"),     # group 1
    (8, 2, 4, "split"), (8, 2, 5, "tile"),       # group 4
    (8, 1, 2, "split"), (8, 1, 3, "tile"),       # MQA, group 8
])
def test_plan_switches_at_sixteen_packed_rows(hq, hkv, sq, path):
    for dtype in DTYPES:
        assert tfa.attention_plan(3, hq, hkv, sq, dtype).path == path


def test_plan_is_a_cached_pure_function():
    a = tfa.attention_plan(8, HQ, HKV, 1, torch.bfloat16)
    assert tfa.attention_plan(8, HQ, HKV, 1, torch.bfloat16) is a
    assert tfa.attention_plan(8, HQ, HKV, 1, torch.float32).kv_tile == 32
    assert a.kv_tile == 64


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ps", PAGE_SIZES)
@pytest.mark.parametrize("max_len", [1000, 1024, 1031])
def test_split_boundaries_do_not_depend_on_the_extent_or_page_size(
        max_len, ps, dtype):
    """Kernel 2 runs over Skv = max_len, kernel 3 over n_blocks * ps:
    the same plan, and splits at the same absolute keys, so both merge
    the same partials for every lane length either can hold."""
    plan = tfa.attention_plan(SLOTS, HQ, HKV, 1, dtype)
    chunk = tfa.SPLIT_CHUNK[dtype]
    skv2 = max_len
    skv3 = math.ceil(max_len / ps) * ps
    s2, s3 = plan.splits(skv2), plan.splits(skv3)
    for lo, hi in s2 + s3:
        assert lo % chunk == 0
        assert hi % chunk == 0 or hi in (skv2, skv3)
    for kv_len in (1, 127, 128, 129, 255, 256, 257, 700, max_len):
        used2 = [lo for lo, _ in s2 if lo < kv_len]
        used3 = [lo for lo, _ in s3 if lo < kv_len]
        assert used2 == used3 == list(range(0, kv_len, chunk))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("skv", [1, 127, 128, 129, 256, 1024, 4097])
def test_splits_cover_the_extent_without_gap_or_overlap(skv, dtype):
    plan = tfa.attention_plan(2, HQ, HKV, 4, dtype)
    splits = plan.splits(skv)
    assert splits[0][0] == 0 and splits[-1][1] == skv
    for (_, hi), (lo, _) in zip(splits, splits[1:], strict=False):
        assert hi == lo
    assert all(lo < hi for lo, hi in splits)
    assert plan.n_splits(skv) == len(splits) == math.ceil(
        skv / tfa.SPLIT_CHUNK[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ps", PAGE_SIZES)
@pytest.mark.parametrize("sq", [1, 2, 4, 8])
def test_scratch_fits_the_largest_main_path_shape(sq, ps, dtype):
    """The split kernel writes split s of (b, hk) at float offset
    ((b * Hkv + hk) * n_splits + s) * (16 * (128 + 2)), rows' (m, l)
    first, then acc[row][128]: the last float it writes lies inside."""
    plan = tfa.attention_plan(SLOTS, HQ, HKV, sq, dtype)
    skv = math.ceil(MAX_LEN / ps) * ps
    n = plan.n_splits(skv)
    part_floats = tfa.SPLIT_ROWS * (tfa.MAX_D + 2)
    assert tfa.PART_BYTES == 4 * part_floats
    last = ((SLOTS * HKV - 1) * n + n - 1) * part_floats \
        + 2 * tfa.SPLIT_ROWS + (plan.rows - 1) * tfa.MAX_D + tfa.MAX_D - 1
    assert 4 * (last + 1) <= plan.scratch_bytes(skv)
    # The whole slot pool's decode scratch stays small next to the cache.
    assert plan.scratch_bytes(skv) <= 8 * 2 ** 20


def test_scratch_buffer_grows_only():
    plan = tfa.attention_plan(2, HQ, HKV, 1, torch.float32)
    dev = torch.device("cpu")
    key = (dev.index, 12345)
    tfa._scratch.pop(key, None)
    try:
        p1 = tfa._scratch_ptr(plan, 256, dev, 12345)
        assert tfa._scratch[key].numel() == plan.scratch_bytes(256)
        assert tfa._scratch_ptr(plan, 128, dev, 12345) == p1
        tfa._scratch_ptr(plan, 1024, dev, 12345)
        assert tfa._scratch[key].numel() == plan.scratch_bytes(1024)
        tile = tfa.attention_plan(1, HQ, HKV, 256, torch.bfloat16)
        assert tfa._scratch_ptr(tile, 1024, dev, 12345) == 0
    finally:
        tfa._scratch.pop(key, None)


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", HEADER)
    assert m, f"{name} not found in flash_attention.cuh"
    return int(m.group(1))


def test_plan_constants_match_the_cuda_source():
    assert _constant("kSplitRows") == tfa.SPLIT_ROWS
    assert _constant("kTileRows") == tfa.TILE_ROWS
    assert _constant("kMaxD") == tfa.MAX_D
    assert _constant("kTileKeys") == 64
    assert re.search(r"return Sq \* \(Hq / Hkv\) <= kSplitRows;", HEADER)
    # Vec<float> first, then Vec<__nv_bfloat16>: tile keys and chunk.
    keys = re.findall(r"static constexpr int kKeys = (\d+);", HEADER)
    chunks = re.findall(r"static constexpr int kChunk = (\d+);", HEADER)
    order = (torch.float32, torch.bfloat16)
    assert list(map(int, keys)) == [
        tfa.attention_plan(1, HQ, HKV, 1, dt).kv_tile for dt in order]
    assert list(map(int, chunks)) == [
        tfa.attention_plan(1, HQ, HKV, 1, dt).chunk for dt in order]
    # Both entry points pass the scratch on to the shared launch.
    for src in ("flash_attention.cu", "paged_attention.cu"):
        text = (CSRC / src).read_text()
        assert "void* scratch" in text and "out, scratch," in text
        # ... and the plan: keys per split and the tile schedule, at run
        # time (the defaults above are the prior's).
        assert "int dtype, int chunk, int block_rows" in text
        assert "chunk, block_rows" in text
    # The launch takes the chunk as an argument in place of the
    # constant, refuses one that is not whole split tiles, and runs the
    # 64-row wgmma schedule only for bf16 at block_rows == kTileRows.
    assert "constexpr int chunk = Vec<T>::kChunk" not in HEADER
    assert "chunk % Vec<T>::kKeys != 0" in HEADER
    assert "if (block_rows == kTileRows)" in HEADER
    wrapper = pathlib.Path(tfa.__file__).read_text()
    assert wrapper.count("plan.chunk or 0, plan.block_rows") == 2
    for dt in order:
        default = tfa.attention_plan(1, HQ, HKV, 1, dt)
        assert default.chunk == tfa.SPLIT_CHUNK[dt]
        assert default.chunk % default.kv_tile == 0
        assert tfa.attention_plan(1, HQ, HKV, 256, dt).block_rows == \
            tfa.tile_schedules(dt)[0]


def test_no_library_computes_attention():
    for path in sorted(CSRC.glob("*.cu*")):
        text = path.read_text().lower()
        for lib in ("cublas", "cudnn", "cutlass/gemm/device"):
            assert lib not in text, f"{path.name} includes {lib}"
    wrapper = pathlib.Path(tfa.__file__).read_text()
    assert "scaled_dot_product_attention" not in wrapper
    assert "matmul" not in wrapper


def test_schedules_use_hand_written_tensor_core_and_async_copies():
    # bf16 tile path: wgmma from shared memory and registers; split path:
    # mma.sync; K/V through cp.async rings; no float atomics anywhere.
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in HEADER
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in HEADER
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in HEADER
    assert "cp.async.cg.shared.global" in HEADER
    assert re.search(r"kv_ring<2>", HEADER)
    assert re.search(r"constexpr int kTileStages = [2-9];", HEADER)
    assert not re.search(r"\batomic(Add|Max)|\bred\.|\batom\.", HEADER)


@pytest.mark.parametrize("hq,hkv,sq", [
    (4, 2, 8),     # 16 rows: split
    (4, 2, 9),     # 18 rows: tile
    (4, 4, 16),    # group 1 at 16 rows
    (4, 4, 17),
    (8, 2, 4),     # group 4 at 16 rows
    (8, 2, 5),
])
def test_plain_matches_pallas_at_the_plan_edges(hq, hkv, sq):
    rng = np.random.default_rng(hq * 100 + sq)
    skv = 40
    q = rng.standard_normal((2, hq, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, hkv, skv, 16)).astype(np.float32)
    v = rng.standard_normal((2, hkv, skv, 16)).astype(np.float32)
    ref = K.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, block_q=8, block_kv=16,
                            interpret=True)
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)
