"""The port's 1-d kernel modules on the CPU: each plain PyTorch version
held against the JAX package's Pallas kernel run in interpret mode, with
the tolerances of ``tests/test_kernels.py``; the grid planner's
invariants; and the measured block tuner's store.

The CUDA kernels themselves run only on the card; ``chip_smoke.py``
holds them against these same plain versions there.
"""
import math
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.adjacent_difference import adjacent_difference_pallas
from repro.kernels.artificial_work import artificial_work_pallas
from repro.kernels.reduce_scan import inclusive_scan_pallas, reduce_sum_pallas
from repro_torch.core.calibration import CalibrationCache
from repro_torch.core.overhead_law import DEFAULT_CHUNKS_PER_CORE
from repro_torch.kernels import adjacent_difference as tad
from repro_torch.kernels import artificial_work as taw
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import reduce_scan as trs
from repro_torch.kernels import tuning
from repro_torch.kernels.autotune import (KernelTuner, candidates_1d,
                                          shape_bucket)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
PALLAS_BLOCK = 128     # the Pallas calls below take n padded to this


def _pair(n: int, dtype: str, seed: int = 0):
    """The same input for both frameworks, zero-padded to the Pallas
    block for the JAX side (the padding is cut from its result)."""
    x = np.random.RandomState(seed).randn(n).astype(np.float32)
    padded = np.pad(x, (0, (-n) % PALLAS_BLOCK))
    return (jnp.asarray(padded, dtype=getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("n", [128, 1000, 4096, 65536 + 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adjacent_difference_plain_matches_pallas(n, dtype):
    jx, tx = _pair(n, dtype)
    ref = adjacent_difference_pallas(jx, block=PALLAS_BLOCK, interpret=True)
    out = tops.adjacent_difference(tx)
    assert out.dtype == tx.dtype and out.shape == (n,)
    np.testing.assert_allclose(_np(out), _np(ref)[:n], **TOL[dtype])


@pytest.mark.parametrize("n", [128, 5000])
@pytest.mark.parametrize("iters", [1, 16, 64])
def test_artificial_work_plain_matches_pallas(n, iters):
    jx, tx = _pair(n, "float32")
    ref = artificial_work_pallas(jx, iters=iters, block=PALLAS_BLOCK,
                                 interpret=True)
    out = tops.artificial_work(tx, iters=iters)
    np.testing.assert_allclose(_np(out), _np(ref)[:n], rtol=1e-5)


@pytest.mark.parametrize("n", [128, 1000, 4096, 30000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduce_sum_plain_matches_pallas(n, dtype):
    jx, tx = _pair(n, dtype)
    ref = reduce_sum_pallas(jx, block=PALLAS_BLOCK, interpret=True)
    out = tops.reduce_sum(tx)
    assert out.dtype == tx.dtype and out.shape == ()
    np.testing.assert_allclose(float(out), float(ref),
                               rtol=3e-2 if dtype == "bfloat16" else 1e-4)


@pytest.mark.parametrize("n", [128, 1000, 8192])
def test_inclusive_scan_plain_matches_pallas(n):
    jx, tx = _pair(n, "float32")
    ref = inclusive_scan_pallas(jx, block=PALLAS_BLOCK, interpret=True)
    out = tops.inclusive_scan(tx)
    np.testing.assert_allclose(_np(out), _np(ref)[:n], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_scan_is_the_exact_prefix_sum_rounded_once(dtype):
    """The plain scan accumulates in f64 and rounds once: after 1e8 come
    eight ones, and the prefix 1e8 + 8 is an f32 value that a running
    sum kept in f32 (spacing 8 at 1e8) never reaches."""
    x = torch.ones(64, dtype=torch.float32)
    x[0] = 1e8
    out = trs.inclusive_scan_ref(x.to(dtype))
    exact = torch.cumsum(x.to(dtype).double(), 0)
    assert torch.equal(out, exact.to(dtype))
    if dtype == torch.float32:
        assert float(out[8]) == 1e8 + 8


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 129])
def test_plain_versions_at_edge_sizes(n):
    x = torch.arange(n, dtype=torch.float32) * 0.5 - 1.0
    xs = x.numpy().astype(np.float64)
    np.testing.assert_array_equal(tops.adjacent_difference(x).numpy(),
                                  np.concatenate([xs[:1], np.diff(xs)]))
    assert float(tops.reduce_sum(x)) == pytest.approx(xs.sum())
    np.testing.assert_allclose(tops.inclusive_scan(x).numpy(),
                               np.cumsum(xs), rtol=1e-6)
    assert tops.artificial_work(x, iters=3).shape == (n,)


@pytest.mark.parametrize("num_sms", [132, 1])
@pytest.mark.parametrize("bytes_per_elem", [4, 2])
@pytest.mark.parametrize("n", [1, 7, 1023, 1024, 1025, 4097, 10 ** 5,
                               2 ** 20, 2 ** 24 + 3, 2 ** 26])
def test_plan_1d_invariants(n, bytes_per_elem, num_sms):
    p = tuning.plan_1d(n, num_sms=num_sms, bytes_per_elem=bytes_per_elem)
    tile = tuning.tile_elems(bytes_per_elem)
    assert tile == tuning.THREADS * 16 // bytes_per_elem
    assert p.block % tile == 0 and p.block >= tile
    assert p.grid == math.ceil(n / p.block)
    assert p.grid * p.block >= n
    min_blocks = DEFAULT_CHUNKS_PER_CORE * num_sms
    if n >= min_blocks * tile:      # n allows C blocks per SM
        assert p.grid >= min_blocks
    else:                           # one tile per block
        assert p.block == tile


@pytest.mark.parametrize("n", [1, 1000, 4096, 10 ** 6])
@pytest.mark.parametrize("bytes_per_elem", [4, 2])
def test_candidates_1d_legal(n, bytes_per_elem):
    tile = tuning.tile_elems(bytes_per_elem)
    cands = candidates_1d(n, num_sms=132, bytes_per_elem=bytes_per_elem)
    assert cands[0] == min(tuning.plan_1d(
        n, num_sms=132, bytes_per_elem=bytes_per_elem).block,
        tuning.round_up(n, tile))
    assert len(set(cands)) == len(cands)
    for b in cands:
        assert b % tile == 0 and tile <= b <= tuning.round_up(n, tile)


def test_shape_bucket():
    assert [shape_bucket(n) for n in (0, 1, 2, 3, 1000, 1024, 1025)] == \
        [1, 1, 2, 4, 1024, 1024, 2048]


def test_tuner_measures_once_then_reads_the_store(tmp_path):
    tuner = KernelTuner(CalibrationCache(str(tmp_path / "cal.json")),
                        repeats=1, hardware="test-card")
    x = torch.from_numpy(np.random.RandomState(3).randn(5000)
                         .astype(np.float32))
    out = tops.inclusive_scan(x, tuner=tuner)
    np.testing.assert_array_equal(out.numpy(),
                                  trs.inclusive_scan_ref(x).numpy())
    assert tuner.searches == 1 and tuner.cache_hits == 0
    report = tuner.reports[-1]
    assert report.measured and report.winner[0] % 1024 == 0
    assert report.key == ("kernel_block", "inclusive_scan", 8192,
                          "torch.float32", "test-card")
    tops.inclusive_scan(x[:4097], tuner=tuner)       # same bucket
    assert tuner.searches == 1 and tuner.cache_hits == 1
    again = KernelTuner(CalibrationCache(str(tmp_path / "cal.json")),
                        repeats=1, hardware="test-card")
    tops.inclusive_scan(x, tuner=again)
    assert again.searches == 0 and again.cache_hits == 1


def test_cpu_tensors_never_count_a_launch():
    counters = (tad.launches, taw.launches, trs.reduce_launches,
                trs.scan_launches)
    for c in counters:
        c.reset()
    x = torch.randn(3000)
    tops.adjacent_difference(x)
    tops.artificial_work(x, iters=2)
    tops.reduce_sum(x)
    tops.inclusive_scan(x, block=1024)
    assert [c.count for c in counters] == [0, 0, 0, 0]


def test_launch_counter_loses_no_update_across_threads():
    """The algorithms' workers launch concurrently; every launch counts."""
    counter = build.LaunchCounter("stress")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [counter.add() for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter.count == 16 * 2000
    counter.reset()
    assert counter.count == 0


def test_artificial_work_is_float32_only():
    with pytest.raises(TypeError, match="float32"):
        tops.artificial_work(torch.ones(8, dtype=torch.bfloat16), iters=2)
    with pytest.raises(TypeError, match="float32"):
        taw.artificial_work(torch.ones(8, dtype=torch.float64), iters=2,
                            block=1024)


def test_launch_checks_reject_bad_inputs():
    dtypes = {torch.float32: 0, torch.bfloat16: 1}
    with pytest.raises(TypeError):
        tuning.check_1d("k", torch.ones(8, dtype=torch.float16), 1024, dtypes)
    with pytest.raises(ValueError, match="1-d"):
        tuning.check_1d("k", torch.ones(2, 4), 1024, dtypes)
    with pytest.raises(ValueError, match="1-d"):
        tuning.check_1d("k", torch.ones(16)[::2], 1024, dtypes)
    with pytest.raises(ValueError, match="block"):
        tuning.check_1d("k", torch.ones(8), 0, dtypes)
    # A CPU tensor that passes every other check is still not the card's.
    with pytest.raises(ValueError, match="device"):
        tuning.check_1d("k", torch.ones(8), 1024, dtypes)
    with pytest.raises(ValueError, match="device"):
        tad.adjacent_difference(torch.ones(8, device="meta"), block=1024)
