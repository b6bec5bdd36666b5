"""Public wrappers of the kernels: each picks a plan and calls its
kernel module (the counterpart of ``repro.kernels.ops``).

The 1-d kernels' plan is static — ``tuning.plan_1d`` with the card's SM
count, the paper's Eq. 10 at the kernel grid — or measured, by an
``autotune.KernelTuner`` passed as ``tuner=``; ``block=`` pins it.  The
kernels mask the ragged edge themselves, so there is no pad-to-plan copy
and no unpad.  Kernel 1's forward (``rmsnorm``, ``add_rmsnorm``) takes
its warps per block the same way (``warps=`` pins them), and kernels 2
and 3 (``flash_attention``, ``paged_flash_attention``) their
``AttentionPlan`` (``plan=`` pins it; by default ``attention_plan``'s
analytic prior).  A tuner's attention probe is the call itself, on its own
K/V and lengths.  For a CPU tensor each wrapper runs its kernel's plain
version, the plan is moot, and a tuner still resolves its key (probing
the plain version; the hardware key keeps CPU winners apart).
"""
from __future__ import annotations

from typing import Callable

import torch

from . import adjacent_difference as _adjdiff
from . import artificial_work as _awork
from . import build
from . import flash_attention as _kfa
from . import reduce_scan as _rscan
from . import rmsnorm as _krms
from . import tuning
from .autotune import device_seconds


def num_sms(x: torch.Tensor) -> int:
    """SMs of the card that holds ``x``; 1 for a CPU tensor."""
    if x.device.type != "cuda":
        return 1
    return build.sm_count(x.device)


def _block(kernel: str, x: torch.Tensor, block: int | None, tuner,
           call: Callable[[torch.Tensor, int], torch.Tensor]) -> int:
    if block is not None:
        return int(block)
    n, item = x.numel(), x.element_size()
    if tuner is not None:
        def run(b: int) -> None:
            call(torch.zeros(n, dtype=x.dtype, device=x.device), b)

        return tuner.plan_1d(kernel, n, run, num_sms=num_sms(x),
                             dtype=str(x.dtype), bytes_per_elem=item).block
    return tuning.plan_1d(n, num_sms=num_sms(x), bytes_per_elem=item).block


def adjacent_difference(x: torch.Tensor, *, block: int | None = None,
                        tuner=None) -> torch.Tensor:
    """out[0] = x[0]; out[i] = x[i] - x[i-1] (kernel 6)."""
    def call(xz, b):
        return _adjdiff.adjacent_difference(xz, block=b)

    return call(x, _block("adjacent_difference", x, block, tuner, call))


def artificial_work(x: torch.Tensor, *, iters: int = 256,
                    block: int | None = None, tuner=None) -> torch.Tensor:
    """``iters`` dependent FMAs per element, f32 (kernel 7)."""
    def call(xz, b):
        return _awork.artificial_work(xz, iters=iters, block=b)

    return call(x, _block(f"artificial_work_{iters}", x, block, tuner, call))


def reduce_sum(x: torch.Tensor, *, block: int | None = None,
               tuner=None) -> torch.Tensor:
    """0-d f32-accumulated sum, in x's type (kernel 4)."""
    def call(xz, b):
        return _rscan.reduce_sum(xz, block=b)

    return call(x, _block("reduce_sum", x, block, tuner, call))


def inclusive_scan(x: torch.Tensor, *, block: int | None = None,
                   tuner=None) -> torch.Tensor:
    """Prefix sum, f32 inside, in x's type (kernel 5)."""
    def call(xz, b):
        return _rscan.inclusive_scan(xz, block=b)

    return call(x, _block("inclusive_scan", x, block, tuner, call))


# ---------------------------------------------------------------------------
# kernel 1's forward and kernels 2 and 3
# ---------------------------------------------------------------------------

def norm_warps(tuner, entry: str, x: torch.Tensor) -> int:
    """Kernel 1's measured warps per block for ``entry`` (``rmsnorm`` or
    ``add_rmsnorm``) over the rows of ``x``; the probe runs the entry on
    zeros of x's rows."""
    d = x.shape[-1]
    rows = x.numel() // d
    fn = _krms.rmsnorm if entry == "rmsnorm" else _krms.add_rmsnorm

    def run(warps: int):
        xz = torch.zeros(rows, d, dtype=x.dtype, device=x.device)
        g = torch.ones(d, dtype=torch.float32, device=x.device)
        args = (xz, g) if entry == "rmsnorm" else (xz, xz, g)

        def call():
            fn(*args, warps=warps)

        took = device_seconds(call, x.device)
        if took is None:
            call()
        return took

    return tuner.plan_rows(entry, rows, d, run, dtype=x.dtype,
                           device=x.device)


def attention_plan_for(tuner, q: torch.Tensor, hkv: int, skv: int,
                       call: Callable[[_kfa.AttentionPlan], object], *,
                       causal: bool = True,
                       window: int | None = None) -> _kfa.AttentionPlan:
    """The measured plan of one attention call, q (B, Hq, Sq, D) over a
    kv extent ``skv``.  The probe is ``call(plan)``, the call itself
    (kernel 2 or 3, the plain version on the CPU): the served lanes' own
    K/V and lengths, with its output dropped.  One key for both kernels:
    the plan is the other kernel's as well."""
    b, hq, sq, d = q.shape

    def run(plan):
        def once():
            call(plan)

        with _kfa.scratch_buffer(None):
            took = device_seconds(once, q.device)
            if took is None:
                once()
        return took

    return tuner.plan_attention(b, hq, hkv, sq, skv, d, run, dtype=q.dtype,
                                causal=causal, window=window,
                                device=q.device)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6,
            warps: int | None = None, tuner=None) -> torch.Tensor:
    """Kernel 1 over the rows of x; ``warps`` pins the block, else a
    ``tuner`` measures it, else the default."""
    if warps is None and tuner is not None:
        warps = norm_warps(tuner, "rmsnorm", x)
    return _krms.rmsnorm(x, gamma, eps=eps, warps=warps)


def add_rmsnorm(x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor, *,
                eps: float = 1e-6, warps: int | None = None,
                tuner=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x + y, rmsnorm(x + y))`` in one launch of kernel 1; ``warps``
    and ``tuner`` as for ``rmsnorm``."""
    if warps is None and tuner is not None:
        warps = norm_warps(tuner, "add_rmsnorm", x)
    return _krms.add_rmsnorm(x, y, gamma, eps=eps, warps=warps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_lens: torch.Tensor | None = None, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None, plan=None,
                    tuner=None, return_lse: bool = False):
    """Kernel 2; ``plan`` pins the schedule, else a ``tuner`` measures
    it on this call, else ``attention_plan``'s prior.  ``return_lse``:
    (out, the rows' log-sum-exp), as ``flash_attention.flash_attention``
    returns them."""
    def call(p):
        return _kfa.flash_attention(q, k, v, kv_lens, causal=causal,
                                    window=window, scale=scale, plan=p,
                                    return_lse=return_lse)

    if plan is None and tuner is not None:
        plan = attention_plan_for(tuner, q, k.shape[1], k.shape[2], call,
                                  causal=causal, window=window)
    return call(plan)


def paged_flash_attention(q: torch.Tensor, k_store: torch.Tensor,
                          v_store: torch.Tensor, page_table: torch.Tensor,
                          kv_lens: torch.Tensor, *, page_size: int,
                          causal: bool = True, scale: float | None = None,
                          plan=None, tuner=None) -> torch.Tensor:
    """Kernel 3 over ``page_table``'s kv extent; ``plan`` and ``tuner``
    as for ``flash_attention``: the same call resolves the same plan."""
    def call(p):
        return _kfa.paged_flash_attention(q, k_store, v_store, page_table,
                                          kv_lens, page_size=page_size,
                                          causal=causal, scale=scale,
                                          plan=p)

    if plan is None and tuner is not None:
        plan = attention_plan_for(tuner, q, k_store.shape[1],
                                  page_table.shape[1] * int(page_size),
                                  call, causal=causal)
    return call(plan)
