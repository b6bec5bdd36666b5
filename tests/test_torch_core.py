"""The port's copy of the execution-model core against the JAX package's:
the same solver inputs give the same decisions, and the framework
touchpoints (hardware key, strict guard, measured search) are the
port's own."""
import dataclasses
import itertools

import pytest
import torch

from repro.core import model as jmodel
from repro.core import overhead_law as jlaw
from repro.core.calibration import CalibrationCache as JCache
from repro_torch.core import model as tmodel
from repro_torch.core import overhead_law as tlaw
from repro_torch.core import strict
from repro_torch.core.acc import AdaptiveCoreChunk
from repro_torch.core.calibration import CalibrationCache as TCache
from repro_torch.core.hardware import H100_SXM


@pytest.mark.parametrize("t_iter,t0", list(itertools.product(
    [0.0, 1e-9, 3e-7, 1e-5, 2e-3], [0.0, 1e-6, 4e-5, 1e-3])))
def test_overhead_law_decide_matches_reference(t_iter, t0):
    for n, cores in ((1, 4), (37, 8), (4096, 16), (10 ** 6, 132)):
        ref = jlaw.decide(t_iter=t_iter, n_elements=n, t0=t0,
                          max_cores=cores)
        got = tlaw.decide(t_iter=t_iter, n_elements=n, t0=t0,
                          max_cores=cores)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def _fill(cache):
    for key, obs in ((("serve_host_tick", "m", 64, 2), (1e-3, 2e-3)),
                     (("serve_decode_fused", "m", 64, 2), (4e-4, 3e-4)),
                     (("serve_prefill", "m", 64, 2), (2e-5,))):
        model = (jmodel if isinstance(cache, JCache) else tmodel) \
            .ExecutionModel.of(cache)
        for s in obs:
            model.observe(key, 1, s)


def test_engine_decisions_match_reference_on_same_store():
    jc, tc = JCache(), TCache()
    _fill(jc)
    _fill(tc)
    je = jmodel.ExecutionModel.of(jc)
    te = tmodel.ExecutionModel.of(tc)
    assert tc.peek_t_iter(("serve_host_tick", "m", 64, 2)) == \
        jc.peek_t_iter(("serve_host_tick", "m", 64, 2))
    key = ("serve_dispatch_depth", "m", 64, 2)
    evidence = (("serve_host_tick", "m", 64, 2),
                ("serve_decode_fused", "m", 64, 2))
    for host, dev, cap in ((1e-3, 4e-4, 32), (5e-6, 1e-3, 8), (0.0, 1e-3, 8),
                           (1e-3, 0.0, 16)):
        jd = je.dispatch_depth(key, host_overhead_s=host, device_step_s=dev,
                               max_depth=cap, evidence=evidence)
        td = te.dispatch_depth(key, host_overhead_s=host, device_step_s=dev,
                               max_depth=cap, evidence=evidence)
        assert (td.chunk, td.provenance, td.inputs) == \
            (jd.chunk, jd.provenance, jd.inputs)
    tick = ("serve_tick", "m", 64, 2)
    for t_iter, count in ((2e-5, 300), (1e-7, 5), (1e-3, 4096)):
        jd = je.cores_chunk(tick, t_iter=t_iter, count=count, t0=4e-5,
                            max_cores=4)
        td = te.cores_chunk(tick, t_iter=t_iter, count=count, t0=4e-5,
                            max_cores=4)
        assert (td.cores, td.chunk, td.provenance) == \
            (jd.cores, jd.chunk, jd.provenance)


def test_hardware_key_names_cuda_or_cpu_never_tpu():
    cpu = tmodel.hardware_key("cpu")
    assert cpu.startswith("cpu:")
    default = tmodel.hardware_key()
    assert default.split(":")[0] in ("cuda", "cpu")
    assert tmodel.hardware_key("cuda").startswith("cuda:")
    for key in (cpu, default, tmodel.hardware_key("cuda")):
        assert "tpu" not in key.lower()
    assert cpu != jmodel.hardware_key()


def test_acc_defaults_to_the_h100_preset():
    assert AdaptiveCoreChunk().hardware is H100_SXM
    assert H100_SXM.peak_flops == 989e12 and H100_SXM.mem_bw == 3.35e12
    assert H100_SXM.vmem_bytes == 227 * 1024


def test_measured_search_times_a_cpu_probe():
    search = tmodel.MeasuredBlockSearch(repeats=2)
    calls = []
    winner, seconds, timings = search.search(
        [(1,), (2,)], lambda c: calls.append(c) or torch.ones(c).sum())
    assert winner in ((1,), (2,)) and seconds >= 0.0
    assert len(calls) == 2 * 3      # cold call + 2 repeats per candidate


def test_strict_guards_are_no_ops_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour of the guards")
    with strict.hot_dispatch_guard():
        with strict.allow_sync():
            assert torch.ones(2).sum().item() == 2.0


def test_persistent_store_is_apart_from_the_reference(tmp_path,
                                                      monkeypatch):
    monkeypatch.delenv("REPRO_CAL_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert TCache.persistent().path != JCache.persistent().path
