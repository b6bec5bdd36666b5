"""Hardware descriptions used by the adaptive cost model.

The paper calibrates a single overhead constant ``T0`` on the machine it
runs on (40-core Skylake / 48-core EPYC).  On a CUDA card the analogous
constants are the kernel launch latency and the collective path between
cards (NVLink hops + link bandwidth).  Both are captured here so the
Overhead-Law solver (``overhead_law.py``) can run either against
measured numbers or against these analytic constants.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Aggregated machine model for one "processing unit" pool.

    Attributes
    ----------
    name:            human-readable identifier.
    num_units:       processing units available (cores or cards; the SMs
                     of one card are the kernel grid's concern, see
                     kernels/tuning.py).
    peak_flops:      peak FLOP/s per unit (dense bf16 tensor-core rate for
                     the card, AVX-512 fp64-ish notional for the CPU
                     presets — only ratios matter).
    mem_bw:          device-memory bandwidth per unit, bytes/s (HBM3 for
                     the card, DRAM for the CPU presets).
    link_bw:         interconnect bandwidth per unit, bytes/s (NVLink each
                     way for the card, inter-socket for the CPU presets).
    launch_overhead: fixed cost of dispatching one parallel region, seconds.
                     This is the paper's ``T0`` seed; on the host backend it
                     is re-measured at runtime (calibration.py).
    hop_latency:     per-hop latency of the interconnect, seconds.
    vmem_bytes:      fast scratch per unit: the shared memory one thread
                     block may use on the card, L2 for the CPU presets
                     (the field keeps the reference's name).
    """

    name: str
    num_units: int
    peak_flops: float
    mem_bw: float
    link_bw: float
    launch_overhead: float
    hop_latency: float
    vmem_bytes: int

    def t0_parallel(self, n_units: int | None = None) -> float:
        """Analytic ``T0``: serial overhead paid only when parallelising.

        Launch cost plus the latency of the synchronising collective across
        ``n_units`` (log-hops on a torus/tree).  This is the mesh-side
        analogue of HPX's "benchmark on an empty thread".
        """
        import math

        n = self.num_units if n_units is None else max(int(n_units), 1)
        hops = math.ceil(math.log2(n)) if n > 1 else 0
        return self.launch_overhead + hops * self.hop_latency


# --- NVIDIA H100 SXM: the port's target (per-card numbers) -----------------
# Data-sheet values (NVIDIA's H100 data sheet and the Hopper white paper),
# not measurements: dense bf16 tensor-core rate, HBM3 bandwidth, NVLink
# bandwidth each way, and the shared memory one block may use, which is
# the card's counterpart of the TPU's VMEM.  ``launch_overhead`` and
# ``hop_latency`` are analytic seeds only; the serve loop re-measures
# its own overheads at run time (calibration.py, core/feedback.py).
H100_SXM = HardwareSpec(
    name="h100-sxm",
    num_units=1,                   # one card
    peak_flops=989e12,             # bf16, dense
    mem_bw=3.35e12,                # HBM3
    link_bw=450e9,                 # NVLink, each way
    launch_overhead=5e-6,          # kernel launch (seed, re-measured)
    hop_latency=1e-6,              # NVLink hop (seed)
    vmem_bytes=227 * 1024,         # shared memory per block
)

# --- The paper's two evaluation machines (for figure reproduction) -------
INTEL_SKYLAKE_40C = HardwareSpec(
    name="intel-skylake-40c",
    num_units=40,
    peak_flops=2.4e9 * 32,         # 2.4 GHz * notional 32 flop/cycle
    mem_bw=128e9 / 40,             # ~128 GB/s socket pair shared
    link_bw=10e9,
    launch_overhead=15e-6,         # HPX parallel region overhead (order)
    hop_latency=0.5e-6,
    vmem_bytes=1 * 1024 * 1024,    # L2
)

AMD_EPYC_48C = HardwareSpec(
    name="amd-epyc-48c",
    num_units=48,
    peak_flops=2.0e9 * 32,
    mem_bw=160e9 / 48,
    link_bw=12e9,
    launch_overhead=15e-6,
    hop_latency=0.6e-6,
    vmem_bytes=1 * 1024 * 1024,
)


def this_host(num_units: int | None = None) -> HardwareSpec:
    """Spec for the machine we are actually running on (calibrated later)."""
    import os

    n = num_units if num_units is not None else (os.cpu_count() or 1)
    return HardwareSpec(
        name="host",
        num_units=n,
        peak_flops=50e9,
        mem_bw=20e9,
        link_bw=10e9,
        launch_overhead=20e-6,
        hop_latency=1e-6,
        vmem_bytes=1 * 1024 * 1024,
    )
