"""Launch audit of the captured decode step on one card (the counterpart
of ``repro.analysis.hlo_audit``).

The reference lowers the live fused decode step and audits the compiled
loop body for collectives the sharding plan does not predict: a reshard
inside the body re-pays pool-sized traffic every iteration.  Here every
decode step on the card is a replay of a captured CUDA graph
(``serve/graphs.py``), and the hazards of one card are of the same kind:
work inside the step that the plan does not hold.  So the audit profiles
one replay of the live captured step (``torch.profiler``, CUDA activity)
and holds its device events against the one-card policy:

* any NCCL kernel is a violation (one card runs no collective), except
  in a mesh step (``AuditPolicy(mesh=True)``, a scheduler with
  ``mesh``), whose tensor-parallel collectives are captured in the
  graph: there they are counted;
* any copy between the host and the card above ``small_copy_max`` bytes
  is a violation (a dispatch's own copies are its budgets, a few bytes a
  lane; a cache row on its way to the host is KiB or MiB);
* a step that did not replay a graph (no graph launch in the window) is a
  violation;
* device-to-device copies are counted and reported; they do not fail.

Kernels are grouped (``kernel_group``: GEMMs, kernel 1, the attention
kernels, copies, the rest) for the report and for ``chip_smoke.py``'s
decode census.  ``audit_events(events, policy)`` is the pure part and
runs anywhere; the events are the profiler's Chrome-trace events.

CLI (on the card; without one it raises)::

    PYTHONPATH=src python -m repro_torch.analysis.launch_audit \\
        --arch qwen3-0.6b [--paged] [--inject-host-copy]

serves nothing: it builds the scheduler at full width (8 slots, 1024
positions, bf16, random weights), captures its decode graphs in
``warmup`` and audits one replay; it exits non-zero on a violation.
``--inject-host-copy`` audits a step built with a deliberate
device-to-host copy of a cache row inside its body
(``make_fused_decode_step(..., _inject_host_copy=True)``), which must
fail: the gate's self-test.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

SMALL_COPY_MAX = 1024


def kernel_group(name: str) -> str:
    """A profiled kernel's group: GEMMs (cuBLAS), kernel 1, the attention
    kernels, NCCL, copies, or the rest (PyTorch's elementwise and
    reduction kernels)."""
    low = name.lower()
    if "nccl" in low:
        return "nccl"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "cutlass")):
        return "gemm"
    if "norm_rows" in low:
        return "kernel1"
    if "repro_fa" in low:
        return "attention"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "elementwise"


def _bytes(event: dict) -> int:
    args = event.get("args") or {}
    return int(args.get("bytes", event.get("bytes", 0)) or 0)


def copy_kind(name: str) -> str | None:
    """"HtoD", "DtoH", "DtoD" (or "HtoH", "PtoP") for a profiled
    memcpy's name ("Memcpy DtoH (Device -> Pinned)"), else None."""
    if not name.startswith("Memcpy"):
        return None
    parts = name.split()
    return parts[1] if len(parts) > 1 else "?"


@dataclasses.dataclass
class AuditPolicy:
    """What one card's decode step may do on the device."""

    small_copy_max: int = SMALL_COPY_MAX
    mesh: bool = False       # a mesh step: its NCCL kernels are expected

    def violation(self, event: dict) -> str | None:
        """None when the policy allows ``event``; else why it fails."""
        name, cat = event.get("name", ""), event.get("cat", "")
        if cat == "kernel" and kernel_group(name) == "nccl" \
                and not self.mesh:
            return f"NCCL kernel {name[:60]} in a one-card step"
        kind = copy_kind(name) if cat == "gpu_memcpy" else None
        if kind in ("HtoD", "DtoH", "HtoH") \
                and _bytes(event) > self.small_copy_max:
            return (f"{kind} copy of {_bytes(event)} B in the step (> "
                    f"{self.small_copy_max} B): device state on its way "
                    f"between the host and the card")
        return None


@dataclasses.dataclass
class AuditReport:
    kernels: dict            # group -> launches in the window
    copies: dict             # kind -> [count, bytes]
    graph_launches: int
    violations: list         # (event name, reason)

    @property
    def ok(self) -> bool:
        return not self.violations

    def counts(self) -> dict[str, int]:
        out = dict(self.kernels)
        for kind, (n, _) in self.copies.items():
            out[f"memcpy {kind}"] = n
        out["graph launches"] = self.graph_launches
        return out

    def to_dict(self) -> dict:
        return {"ok": self.ok, "kernels": self.kernels,
                "copies": self.copies,
                "graph_launches": self.graph_launches,
                "violations": [{"event": n, "reason": r}
                               for n, r in self.violations]}


def audit_events(events: list[dict],
                 policy: AuditPolicy | None = None) -> AuditReport:
    """Audit the profiler events of one step's window against
    ``policy`` (the module docstring's rules)."""
    policy = policy or AuditPolicy()
    kernels: dict = {}
    copies: dict = {}
    graphs = 0
    violations = []
    for e in events:
        name, cat = e.get("name", ""), e.get("cat", "")
        if cat in ("cuda_runtime", "cuda_driver") and "GraphLaunch" in name:
            graphs += 1
        if cat == "kernel":
            group = kernel_group(name)
            kernels[group] = kernels.get(group, 0) + 1
        elif cat == "gpu_memcpy":
            kind = copy_kind(name) or "?"
            n, b = copies.get(kind, (0, 0))
            copies[kind] = [n + 1, b + _bytes(e)]
        reason = policy.violation(e)
        if reason is not None:
            violations.append((name, reason))
    if graphs == 0:
        violations.append(("(window)", "the step did not replay a CUDA "
                                       "graph"))
    return AuditReport(kernels=kernels, copies=copies,
                       graph_launches=graphs, violations=violations)


def format_report(report: AuditReport) -> str:
    copies = {k: f"{n} ({b} B)" for k, (n, b) in report.copies.items()}
    lines = [f"launch-audit: kernels {report.kernels or '{}'}, copies "
             f"{copies or '{}'}, graph launches {report.graph_launches}"]
    for name, reason in report.violations:
        lines.append(f"  VIOLATION {reason}")
        lines.append(f"    {name[:140]}")
    lines.append("launch-audit: " + ("clean" if report.ok else
                                     f"{len(report.violations)} "
                                     f"violation(s)"))
    return "\n".join(lines)


def trace_events(prof) -> list[dict]:
    """The Chrome-trace events of a finished ``torch.profiler`` run."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def audit_scheduler(sched, *, inject_host_copy: bool = False,
                    policy: AuditPolicy | None = None) -> AuditReport:
    """Profile one replay of the scheduler's live captured decode step
    (the fused step, contiguous or paged, or the speculative step at the
    live width) and audit it.  The pool must be idle: the step runs lane
    0 one token into slot 0, as ``warmup`` does, and its outputs are not
    adopted.  ``inject_host_copy`` audits a separate step built with the
    deliberate host copy (its own graphs) over the same pool.  A mesh
    scheduler's step runs its own lanes under its tensor-parallel
    context, audited by default with ``AuditPolicy(mesh=True)``."""
    import torch

    from ..models import flags
    from ..serve.decode_loop import (make_fused_decode_step,
                                     make_paged_decode_step)
    from ..serve.graphs import DecodeGraphs

    if sched.device.type != "cuda":
        raise ValueError("launch audit: the step's graphs run on the card "
                         f"only, not on {sched.device}")
    if not sched._fused:
        raise ValueError("launch audit needs the fused decode path "
                         "(dispatch_depth != None)")
    if sched.pool.free_slots() != sched.pool.n_slots:
        raise RuntimeError("launch audit: the pool must be idle")
    lanes = sched.pool.lanes
    n = lanes.stop - lanes.start
    pt = (sched.pool.page_table_array()[lanes],) if sched.paged else ()
    toks = torch.zeros(n, dtype=torch.long, device=sched.device)
    poss = sched.pool.positions_array()[lanes]
    if policy is None and sched.mesh is not None:
        policy = AuditPolicy(mesh=True)
    one = [1] + [0] * (n - 1)
    spec_d = sched._spec_depth if sched._spec else 1
    args = (toks, poss, one)
    tuner = sched._dispatch_tuner(("spec", spec_d) if spec_d >= 2
                                  else "fused")
    if inject_host_copy:
        kw = dict(max_depth=sched.max_dispatch_depth, graphs=DecodeGraphs(),
                  _inject_host_copy=True)
        step = make_paged_decode_step(
            sched.cfg, page_size=sched.pool.page_size, **kw) if sched.paged \
            else make_fused_decode_step(sched.cfg, window=sched.window, **kw)
    elif spec_d >= 2:
        step = sched._spec_step(spec_d)
        args = (torch.full((n, sched.spec_history), -1, dtype=torch.long,
                           device=sched.device),) + args
    else:
        step = sched._fused_step()

    def call():
        # The pool's own tensors, updated in place (its outputs are not
        # adopted: lane 0's row at position 0 takes the garbage), under
        # the kernel tuner the scheduler's dispatches of it run under.
        with flags.kernel_tuner(tuner), flags.tensor_parallel(sched.tp):
            step(sched.params, sched.pool.caches, *pt, *args)

    call()                       # captures if nothing is captured yet
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        call()
        torch.cuda.synchronize()
    return audit_events(trace_events(prof), policy)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.launch_audit",
        description="audit one replay of the captured decode step for "
                    "device work the one-card plan does not hold")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--paged", action="store_true",
                    help="audit the paged fused step (page size 16)")
    ap.add_argument("--inject-host-copy", action="store_true",
                    help="deliberately copy a cache row to the host "
                         "inside the step (the audit must then FAIL)")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..device import resolve_device
    from ..models import lm
    from ..serve import ServeScheduler

    device = resolve_device("cuda")
    cfg = get_config(args.arch)
    params = lm.init_params(0, cfg, device=device)
    sched = ServeScheduler(cfg, params, n_slots=8, max_len=1024,
                           dispatch_depth=4, paged=args.paged,
                           page_size=16, device=device)
    sched.warmup()
    report = audit_scheduler(sched, inject_host_copy=args.inject_host_copy)
    print(format_report(report))
    return 0 if report.ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
