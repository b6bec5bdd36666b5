"""The launch audit (``analysis/launch_audit.py``) on the CPU: the pure
part, ``audit_events``, on synthetic profiler events (clean, an NCCL
kernel, a large device-to-host copy, a small one, device-to-device
copies, a window with no graph replay), the kernel groups, the report,
the gate's injected host copy on the CPU's plain step, and the entry
points' refusals without a card.  The audit itself profiles a replay of
the captured step, which only the card has (``chip_smoke.py`` phase 14
runs the CLI both ways)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis import launch_audit as la
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serve import ServeScheduler
from repro_torch.serve import decode_loop as tdl

GRAPH = {"name": "cudaGraphLaunch", "cat": "cuda_runtime"}


def _kernel(name):
    return {"name": name, "cat": "kernel"}


def _copy(kind, nbytes):
    names = {"HtoD": "Memcpy HtoD (Pageable -> Device)",
             "DtoH": "Memcpy DtoH (Device -> Pinned)",
             "DtoD": "Memcpy DtoD (Device -> Device)"}
    return {"name": names[kind], "cat": "gpu_memcpy",
            "args": {"bytes": nbytes}}


STEP = [GRAPH, _kernel("void repro_fa::flash_split_kernel<...>"),
        _kernel("void (anonymous namespace)::norm_rows<...>"),
        _kernel("nvjet_tst_64x8_64x16_4x1_v_bz_TNT"),
        _kernel("void at::native::vectorized_elementwise_kernel<...>"),
        _copy("HtoD", 64)]


@pytest.mark.parametrize("extra,ok,reason", [
    ([], True, None),
    ([_kernel("ncclDevKernel_AllReduce_Sum_bf16_RING_LL")], False, "NCCL"),
    ([_copy("DtoH", 2048)], False, "DtoH copy of 2048 B"),
    ([_copy("DtoH", 1024)], True, None),
    ([_copy("HtoD", 4096)], False, "HtoD copy of 4096 B"),
    ([_copy("DtoD", 1 << 20), _copy("DtoD", 16)], True, None),
])
def test_audit_events(extra, ok, reason):
    """The one-card policy: NCCL kernels and host<->card copies above
    ``small_copy_max`` fail; small copies pass; device-to-device copies
    are counted, never a violation."""
    report = la.audit_events(STEP + extra)
    assert report.ok is ok
    if reason is not None:
        assert reason in report.violations[0][1]
    assert report.graph_launches == 1
    assert report.kernels["attention"] == 1 and report.kernels["gemm"] == 1
    assert report.kernels["kernel1"] == 1
    dtod = [e for e in extra if "DtoD" in e["name"]]
    if dtod:
        assert report.copies["DtoD"] == [2, (1 << 20) + 16]
    d = report.to_dict()
    assert d["ok"] is ok and d["graph_launches"] == 1
    text = la.format_report(report)
    assert text.endswith("clean") if ok else "VIOLATION" in text


def test_a_step_that_replayed_no_graph_fails():
    report = la.audit_events(STEP[1:])
    assert not report.ok and "did not replay" in report.violations[0][1]
    assert la.audit_events(STEP, la.AuditPolicy(small_copy_max=8)).ok \
        is False


@pytest.mark.parametrize("name,group", [
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "gemm"),
    ("void cutlass::Kernel2<...>", "gemm"),
    ("void (anonymous namespace)::norm_rows_generic<float, true>", "kernel1"),
    ("void repro_fa::flash_combine_kernel<float>", "attention"),
    ("ncclKernel_AllGather", "nccl"), ("Memcpy DtoD", "copy"),
    ("void at::native::reduce_kernel<...>", "elementwise")])
def test_kernel_groups(name, group):
    assert la.kernel_group(name) == group


def test_the_injected_host_copy_changes_nothing_on_the_cpu():
    """The gate's self-test step (``_inject_host_copy``) is the plain step
    plus a copy of a cache row to the host: the same tokens and rows."""
    cfg = get_config("qwen3-0.6b").reduced()
    p = lm.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, 2))
    poss = torch.tensor([3, 7])
    outs = []
    for inject in (False, True):
        caches = lm.init_caches(cfg, 2, 16, device="cpu")
        step = tdl.make_fused_decode_step(cfg, max_depth=4,
                                          _inject_host_copy=inject)
        outs.append(step(p, caches, toks, poss, [3, 2]))
    (c0, o0, t0), (c1, o1, t1) = outs
    assert torch.equal(o0, o1) and torch.equal(t0, t1)
    for a, b in zip(c0, c1, strict=True):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_the_audit_needs_the_card():
    """No card, no audit: a CPU scheduler is refused, and the CLI raises
    (no fallback)."""
    cfg = get_config("qwen3-0.6b").reduced()
    sched = ServeScheduler(cfg, lm.init_params(0, cfg, device="cpu"),
                           n_slots=2, max_len=16, dispatch_depth=2,
                           device="cpu")
    with pytest.raises(ValueError, match="card"):
        la.audit_scheduler(sched)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            la.main(["--arch", "qwen3-0.6b"])
    assert dataclasses.asdict(la.AuditPolicy())["small_copy_max"] == \
        la.SMALL_COPY_MAX
