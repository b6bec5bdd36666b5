"""RMSNorm (kernel 1): the CUDA kernel's three entry points and their
plain PyTorch versions.

Port of ``repro.kernels.rmsnorm.rmsnorm_pallas`` (the Pallas TPU kernel)
and ``repro.kernels.ref.rmsnorm_ref`` (its oracle).  The kernel lives in
``csrc/rmsnorm.cu``; one templated row body serves three launches:

* ``rmsnorm(x, γ)``: every row of x normed;
* ``add_rmsnorm(x, y, γ) -> (s, h)``: the residual add and the norm that
  follows it in one launch, ``s = x + y`` rounded to x's type and ``h =
  rmsnorm(s, γ)``;
* ``qk_norm_rope(q, k, γq, γk, cos, sin) -> (q', k')``: the q- and
  k-norms of one attention layer and the rotary embedding after them,
  both tensors in one launch.

Each launches the kernel for a CUDA tensor and runs its plain version
(``*_ref``) for a CPU tensor; there is no other route.  Every launch of
any entry adds one to ``launches`` (kernel 1's count) and one to its
entry's counter in ``entry_launches``.  ``rmsnorm`` and ``add_rmsnorm``
take ``warps``, the block's warps (``WARPS``; ``DEFAULT_WARPS`` unless a
measured plan, ``autotune.KernelTuner.plan_rows``, picks another): every
value gives the same bits.  Each entry also knows the work one call must
do (``*_work``), which a cost count reads (``build.counted``).

The backward (the JAX package's custom VJP, ``repro.kernels.ops``
``_rmsnorm_diffable_bwd``) has the same three entries, ``rmsnorm_bwd``,
``add_rmsnorm_bwd`` and ``qk_norm_rope_bwd``, with plain versions
``*_bwd_ref`` and counters ``bwd_launches`` / ``bwd_entry_launches``.
``RMSNormFn``, ``AddRMSNormFn`` and ``QKNormRopeFn`` join each forward
entry to its backward as a ``torch.autograd.Function``; the model calls
those.  A raw forward entry called on the card with grad mode on and an
input that requires grad raises: its output would have no autograd node.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from . import build

_ENTRIES = ("rmsnorm", "add_rmsnorm", "qk_norm_rope")
launches = build.LaunchCounter("rmsnorm")
entry_launches = {name: build.LaunchCounter(name) for name in _ENTRIES}
bwd_launches = build.LaunchCounter("rmsnorm_backward")
bwd_entry_launches = {name: build.LaunchCounter(f"{name}_backward")
                      for name in _ENTRIES}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Warps of a forward norm's block (csrc/rmsnorm.cu: kWarps the default).
WARPS = (8, 4, 2, 1)
DEFAULT_WARPS = 8
# Row widths with a compile-time register layout in csrc/rmsnorm.cu:
# 8..256 vectors of 16 bytes (bf16 d 64..2048, f32 d 32..1024).  Other
# widths that are a multiple of 8 take the kernel's generic loop.  The
# rotary entry takes head rows of 8..128 vectors (bf16 head dims
# 64..1024) and no others.
_ROPE_VECTORS = (8, 16, 32, 64, 128)
# The backward (csrc/rmsnorm.cu, one kernel a call): rows of up to
# BWD_REG_MAX_D elements held in registers, bf16 or f32 (the rotary entry:
# head rows of 8..128 vectors, as its forward); a generic loop for any
# wider width that is a multiple of 8, up to BWD_MAX_D elements (its partial
# row of dγ sits in shared memory).  dγ's partial rows, one per block (the
# grid is at most the card's SMs), sit in a scratch per device and stream
# after a header of BWD_SCRATCH_HEADER bytes (an arrival counter the kernel
# leaves at zero).  These mirror kBwdRegMaxD, kBwdMaxD and kBwdHeader in
# csrc/rmsnorm.cu.
BWD_REG_MAX_D = 8192
BWD_MAX_D = 49152
BWD_SCRATCH_HEADER = 128
_GAMMA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_counts() -> None:
    for c in (launches, bwd_launches, *entry_launches.values(),
              *bwd_entry_launches.values()):
        c.reset()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in the plain versions' compute type: f32, or f64 for f64 (the
    gradient checks run there)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``(x / sqrt(mean(x²) + eps)) · γ`` in f32, cast back to x's type."""
    xf = _wide(x)
    rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf / rms) * gamma.to(xf.dtype)).to(x.dtype)


def add_rmsnorm_ref(x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor,
                    eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """``s = x + y`` (PyTorch's add: f32 inside, rounded once to the
    type) and ``rmsnorm_ref(s, γ)``."""
    s = x + y
    return s, rmsnorm_ref(s, gamma, eps)


def rope_ref(x: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half rotary embedding, the one definition of its
    arithmetic (``models.common.apply_rope`` is this function).  x: (B,
    S, H, D); cos/sin: (B, S, D/2) f32, broadcast over the heads; each
    product, then the difference or sum, rounded in f32, the result
    rounded once to x's type."""
    d = x.shape[-1]
    cos, sin = cos[:, :, None], sin[:, :, None]
    xf1, xf2 = _wide(x[..., : d // 2]), _wide(x[..., d // 2:])
    out1 = xf1 * cos - xf2 * sin
    out2 = xf2 * cos + xf1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def qk_norm_rope_ref(q: torch.Tensor, k: torch.Tensor, gamma_q: torch.Tensor,
                     gamma_k: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor, eps: float = 1e-6
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``rope_ref(rmsnorm_ref(q, γq))`` and the same for k."""
    return (rope_ref(rmsnorm_ref(q, gamma_q, eps), cos, sin),
            rope_ref(rmsnorm_ref(k, gamma_k, eps), cos, sin))


def _norm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
              eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The closed form of the reference's custom VJP (``ops.py:161``), in
    f32 (f64 for f64 x): dx not yet rounded, and dγ."""
    xf = _wide(x)
    dyf, gf = dy.to(xf.dtype), gamma.to(xf.dtype)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * r
    dg = (dyf * xhat).reshape(-1, x.shape[-1]).sum(0)
    gdy = dyf * gf
    dx = (gdy - xhat * torch.mean(gdy * xhat, dim=-1, keepdim=True)) * r
    return dx, dg


def rmsnorm_bwd_ref(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dγ) of ``rmsnorm_ref`` for the output gradient dy: dx in x's
    type, dγ in γ's."""
    dx, dg = _norm_bwd(x, gamma, dy, eps)
    return dx.to(x.dtype), dg.to(gamma.dtype)


def add_rmsnorm_bwd_ref(s: torch.Tensor, gamma: torch.Tensor,
                        dh: torch.Tensor, ds: torch.Tensor | None,
                        eps: float = 1e-6
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(d(x + y), dγ) of ``add_rmsnorm_ref``: the norm's dx plus the
    residual's own gradient ds (None: s was not used), rounded once to
    s's type; it is the gradient of both x and y."""
    dx, dg = _norm_bwd(s, gamma, dh, eps)
    if ds is not None:
        dx = dx + ds.to(dx.dtype)
    return dx.to(s.dtype), dg.to(gamma.dtype)


def rope_bwd_ref(dy: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """The rotate-half rotation's transpose applied to dy (B, S, H, D):
    ``dh1 = dy1 cos + dy2 sin``, ``dh2 = dy2 cos − dy1 sin``, kept in the
    plain versions' compute type."""
    d = dy.shape[-1]
    cos, sin = cos[:, :, None], sin[:, :, None]
    d1, d2 = _wide(dy[..., : d // 2]), _wide(dy[..., d // 2:])
    return torch.cat([d1 * cos + d2 * sin, d2 * cos - d1 * sin], dim=-1)


def qk_norm_rope_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                         gamma_q: torch.Tensor, gamma_k: torch.Tensor,
                         cos: torch.Tensor, sin: torch.Tensor,
                         dq_out: torch.Tensor, dk_out: torch.Tensor,
                         eps: float = 1e-6) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dγq, dγk) of ``qk_norm_rope_ref``: each output gradient
    un-rotated, then the norm's backward."""
    dq, dgq = _norm_bwd(q, gamma_q, rope_bwd_ref(dq_out, cos, sin), eps)
    dk, dgk = _norm_bwd(k, gamma_k, rope_bwd_ref(dk_out, cos, sin), eps)
    return (dq.to(q.dtype), dk.to(k.dtype), dgq.to(gamma_q.dtype),
            dgk.to(gamma_k.dtype))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    lib = build.library("rmsnorm")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {"repro_rmsnorm": [vp, vp, vp, i, i, f, i, i, vp],
            "repro_add_rmsnorm": [vp, vp, vp, vp, vp, i, i, f, i, i, vp],
            "repro_qk_norm_rope": [vp, vp, vp, vp, vp, vp, vp, vp, i, i, i,
                                   i, i, f, i, vp],
            "repro_rmsnorm_bwd": [vp] * 6 + [i, i, f, i, i, vp],
            "repro_add_rmsnorm_bwd": [vp] * 7 + [i, i, f, i, i, vp],
            "repro_qk_norm_rope_bwd": [vp] * 13 + [i, i, i, i, i, f, i, i,
                                                   vp],
            "repro_rmsnorm_bwd_plan": [i] * 7 + [vp]}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _require_card(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def _rows_input(name: str, x: torch.Tensor, *, dtype=None) -> int:
    """Raise unless x is what the kernel reads as rows: contiguous,
    16-byte aligned, f32 or bf16 (``dtype`` when given), the last dim a
    multiple of 8.  Returns the dtype code."""
    if x.dtype not in _DTYPES or (dtype is not None and x.dtype != dtype):
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(float32, bfloat16, one type for all inputs)")
    if x.shape[-1] % 8 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: inputs must be contiguous, 16-byte "
                         f"aligned, with the last dim a multiple of 8")
    return _DTYPES[x.dtype]


def _check_gamma(name: str, gamma: torch.Tensor, x: torch.Tensor) -> None:
    d = x.shape[-1]
    if gamma.shape != (d,) or gamma.device != x.device:
        raise ValueError(f"{name}: gamma {tuple(gamma.shape)} on "
                         f"{gamma.device} does not match (..., {d}) on "
                         f"{x.device}")


def _gamma(name: str, gamma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    _check_gamma(name, gamma, x)
    return gamma.float().contiguous()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _count(entry: str) -> None:
    launches.add()
    entry_launches[entry].add()


def _warps(name: str, warps: int | None) -> int:
    if warps is None:
        return DEFAULT_WARPS
    if warps not in WARPS:
        raise ValueError(f"{name}: warps must be one of {sorted(WARPS)}, "
                         f"got {warps}")
    return int(warps)


# The work of one call (inputs read once, outputs written once; γ in
# f32): a few f32 operations an element, so bytes bound every entry.
def rmsnorm_work(x: torch.Tensor, gamma: torch.Tensor,
                 **_) -> build.Work:
    return build.Work(other_flops=4 * x.numel(),
                      bytes=2 * x.numel() * x.element_size()
                      + 4 * x.shape[-1])


def add_rmsnorm_work(x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor,
                     **_) -> build.Work:
    return build.Work(other_flops=5 * x.numel(),
                      bytes=4 * x.numel() * x.element_size()
                      + 4 * x.shape[-1])


def qk_norm_rope_work(q: torch.Tensor, k: torch.Tensor, gamma_q, gamma_k,
                      cos: torch.Tensor, sin: torch.Tensor,
                      **_) -> build.Work:
    elems = q.numel() + k.numel()
    return build.Work(other_flops=10 * elems,
                      bytes=2 * elems * q.element_size()
                      + 2 * cos.numel() * 4 + 2 * 4 * q.shape[-1])


@build.counted("rmsnorm", rmsnorm_work)
def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *,
            eps: float = 1e-6, warps: int | None = None) -> torch.Tensor:
    """x: (..., d), γ: (d,).  Leading dims are flattened to rows;
    ``warps`` per block (``WARPS``, default ``DEFAULT_WARPS``)."""
    warps = _warps("rmsnorm", warps)
    if build.plain(x):
        return rmsnorm_ref(x, gamma, eps)
    _require_card("rmsnorm", x)
    build.refuse_grad("rmsnorm", "kernels.rmsnorm.RMSNormFn.apply",
                      x, gamma)
    code = _rows_input("rmsnorm", x)
    g = _gamma("rmsnorm", gamma, x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    d = x.shape[-1]
    build.check(_lib().repro_rmsnorm(
        x.data_ptr(), g.data_ptr(), out.data_ptr(), x.numel() // d, d,
        float(eps), warps, code, _stream(x)), "rmsnorm")
    _count("rmsnorm")
    return out


@build.counted("rmsnorm", add_rmsnorm_work)
def add_rmsnorm(x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor, *,
                eps: float = 1e-6, warps: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, y: (..., d) of one type, γ: (d,).  Returns (s, h): the residual
    ``s = x + y`` (the same bits as PyTorch's ``x + y``) and ``h =
    rmsnorm(s, γ)`` (the same bits as ``rmsnorm`` on that ``s``);
    ``warps`` as for ``rmsnorm``."""
    warps = _warps("add_rmsnorm", warps)
    if build.plain(x):
        return add_rmsnorm_ref(x, y, gamma, eps)
    _require_card("add_rmsnorm", x)
    build.refuse_grad("add_rmsnorm", "kernels.rmsnorm.AddRMSNormFn.apply",
                      x, y, gamma)
    code = _rows_input("add_rmsnorm", x)
    _rows_input("add_rmsnorm", y, dtype=x.dtype)
    if y.shape != x.shape or y.device != x.device:
        raise ValueError(f"add_rmsnorm: y {tuple(y.shape)} on {y.device} "
                         f"does not match x {tuple(x.shape)} on {x.device}")
    g = _gamma("add_rmsnorm", gamma, x)
    s = torch.empty_like(x)
    h = torch.empty_like(x)
    if x.numel() == 0:
        return s, h
    d = x.shape[-1]
    build.check(_lib().repro_add_rmsnorm(
        x.data_ptr(), y.data_ptr(), g.data_ptr(), s.data_ptr(), h.data_ptr(),
        x.numel() // d, d, float(eps), warps, code, _stream(x)),
        "add_rmsnorm")
    _count("add_rmsnorm")
    return s, h


@build.counted("rmsnorm", qk_norm_rope_work)
def qk_norm_rope(q: torch.Tensor, k: torch.Tensor, gamma_q: torch.Tensor,
                 gamma_k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 *, eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, L, Hq, D), k: (B, L, Hkv, D) of one type; γq, γk: (D,);
    cos/sin: (B, L, D/2) f32.  Returns (q', k') of q's and k's shapes:
    each head row normed, rounded to the type, rotated (rotate-half) and
    rounded again, the bits of ``rmsnorm`` followed by ``rope_ref``."""
    if build.plain(q):
        return qk_norm_rope_ref(q, k, gamma_q, gamma_k, cos, sin, eps)
    _require_card("qk_norm_rope", q)
    build.refuse_grad("qk_norm_rope", "kernels.rmsnorm.QKNormRopeFn.apply",
                      q, k, gamma_q, gamma_k)
    code = _rows_input("qk_norm_rope", q)
    _rows_input("qk_norm_rope", k, dtype=q.dtype)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("qk_norm_rope: q and k must be (B, L, H, D)")
    b, length, hq, d = q.shape
    hkv = k.shape[2]
    if k.shape != (b, length, hkv, d) or k.device != q.device:
        raise ValueError(f"qk_norm_rope: k {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if d * q.element_size() // 16 not in _ROPE_VECTORS:
        raise ValueError(f"qk_norm_rope: head dim {d} in {q.dtype} has no "
                         f"register layout in the kernel")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.shape != (b, length, d // 2) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"qk_norm_rope: {name} must be (B, L, D/2) "
                             f"float32, contiguous, 16-byte aligned, on "
                             f"q's device; got {tuple(t.shape)} {t.dtype}")
    gq = _gamma("qk_norm_rope", gamma_q, q)
    gk = _gamma("qk_norm_rope", gamma_k, k)
    qo = torch.empty_like(q)
    ko = torch.empty_like(k)
    if q.numel() == 0:
        return qo, ko
    build.check(_lib().repro_qk_norm_rope(
        q.data_ptr(), k.data_ptr(), gq.data_ptr(), gk.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), qo.data_ptr(), ko.data_ptr(),
        b * length * hq, b * length * hkv, hq, hkv, d, float(eps), code,
        _stream(q)), "qk_norm_rope")
    _count("qk_norm_rope")
    return qo, ko


# ---------------------------------------------------------------------------
# backward wrappers
# ---------------------------------------------------------------------------

def _bwd_rows(name: str, x: torch.Tensor, *grads: torch.Tensor,
              vectors=None) -> tuple[int, list[torch.Tensor]]:
    """Checks of a backward launch: x as ``_rows_input`` takes it (the
    width a multiple of 8), a width the backward takes (at most
    ``BWD_MAX_D``; ``vectors``, where given, the register layouts allowed:
    the rotary entry's), each gradient of x's shape and type (made
    contiguous).  Returns (dtype code, the gradients)."""
    code = _rows_input(name, x)
    d = x.shape[-1]
    nv = d * x.element_size() // 16
    if (vectors is not None and nv not in vectors) or d > BWD_MAX_D:
        raise ValueError(f"{name}: rows of {d} {x.dtype} are not taken by "
                         f"the backward kernel")
    out = []
    for g in grads:
        if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
            raise ValueError(f"{name}: gradient {tuple(g.shape)} {g.dtype} "
                             f"does not match {tuple(x.shape)} {x.dtype}")
        g = g.contiguous()
        _rows_input(name, g)
        out.append(g)
    return code, out


def _partial_rows(x: torch.Tensor, tokens: int | None = None) -> int:
    """dγ's partial rows a backward call may write: one per block, and
    the kernel's grid is at most min(its tokens, the card's SMs); tokens
    are x's rows unless given."""
    rows = x.numel() // x.shape[-1] if tokens is None else tokens
    return min(rows, build.sm_count(x.device))


# The backward's scratch, per (device index, stream): grow-only, zeroed
# once when it is made; the kernel leaves its counter at zero after every
# call, so no call zeroes it again.
_bwd_scratch: dict = {}


def _bwd_scratch_ptr(x: torch.Tensor, stream: int, partial_rows: int,
                     cols: int) -> int:
    """Address of the scratch of x's device and ``stream`` holding
    ``partial_rows`` rows of ``cols`` floats after its header.  A graph
    capture cannot make or grow it (the address would be baked into the
    graph and then freed); it reuses one made before."""
    need = BWD_SCRATCH_HEADER + 4 * partial_rows * cols
    key = (x.device.index, stream)
    buf = _bwd_scratch.get(key)
    if buf is None or buf.numel() < need:
        if build.capturing():
            raise RuntimeError("rmsnorm backward: a graph capture cannot "
                               "make its scratch; run one call of this "
                               "size on the stream before capturing")
        buf = torch.zeros(need, dtype=torch.uint8, device=x.device)
        _bwd_scratch[key] = buf
    return buf.data_ptr()


def _bwd_gamma(name: str, gamma: torch.Tensor, x: torch.Tensor
               ) -> tuple[torch.Tensor, int]:
    """γ as the backward kernel reads it (its own type, f32 or bf16,
    contiguous) and its type code; dγ is written in that type."""
    _check_gamma(name, gamma, x)
    if gamma.dtype not in _GAMMA_DTYPES:
        raise TypeError(f"{name}: gamma dtype {gamma.dtype} not supported "
                        f"on the card (float32, bfloat16)")
    return gamma.contiguous(), _GAMMA_DTYPES[gamma.dtype]


def bwd_plan(tokens: int, d: int, dtype: torch.dtype, *, heads=(1, 0),
             residual: bool = False, rope: bool = False) -> dict:
    """The plan the backward kernel takes for a call of this shape on the
    current card (csrc/rmsnorm.cu ``repro_rmsnorm_bwd_plan``; launches
    nothing): threads a row (0: the generic loop), tokens a stage, stages,
    blocks, finishing blocks, dγ columns a finisher sums, dynamic shared
    memory, row elements a thread holds."""
    plan = (ctypes.c_int * 8)()
    build.check(_lib().repro_rmsnorm_bwd_plan(
        tokens, heads[0], heads[1], d, _DTYPES[dtype], int(residual),
        int(rope), plan), "rmsnorm_bwd_plan")
    keys = ("threads_per_row", "tokens_per_stage", "stages", "blocks",
            "finishers", "finish_cols", "smem_bytes", "elems_per_thread")
    return dict(zip(keys, list(plan), strict=True))


def _bwd_count(entry: str) -> None:
    bwd_launches.add()
    bwd_entry_launches[entry].add()


# The backward's work: its inputs read once, dx and dγ written once (dγ's
# partial rows are the kernel's choice of grid, not the function's; γ and
# dγ in γ's type).
def rmsnorm_bwd_work(x: torch.Tensor, gamma, dy, **_) -> build.Work:
    return build.Work(other_flops=8 * x.numel(),
                      bytes=3 * x.numel() * x.element_size()
                      + 2 * gamma.numel() * gamma.element_size())


def add_rmsnorm_bwd_work(s: torch.Tensor, gamma, dh, ds,
                         **_) -> build.Work:
    tensors = 3 if ds is None else 4
    return build.Work(other_flops=9 * s.numel(),
                      bytes=tensors * s.numel() * s.element_size()
                      + 2 * gamma.numel() * gamma.element_size())


def qk_norm_rope_bwd_work(q: torch.Tensor, k: torch.Tensor, gamma_q,
                          gamma_k, cos: torch.Tensor, *_,
                          **__) -> build.Work:
    elems = q.numel() + k.numel()
    return build.Work(other_flops=14 * elems,
                      bytes=3 * elems * q.element_size()
                      + 2 * cos.numel() * 4
                      + 2 * (gamma_q.numel() + gamma_k.numel())
                      * gamma_q.element_size())


@build.counted("rmsnorm_backward", rmsnorm_bwd_work)
def rmsnorm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dγ) of ``rmsnorm`` for the output gradient dy: dx in x's type,
    dγ in γ's, dγ summed over the rows in a fixed order (two calls give
    the same bits).  One C call, one kernel: dγ is summed across blocks
    and written in γ's type inside it."""
    if build.plain(x):
        return rmsnorm_bwd_ref(x, gamma, dy, eps)
    _require_card("rmsnorm_bwd", x)
    code, (dy,) = _bwd_rows("rmsnorm_bwd", x, dy)
    g, gcode = _bwd_gamma("rmsnorm_bwd", gamma, x)
    d = x.shape[-1]
    dx = torch.empty_like(x)
    if not x.numel():
        return dx, torch.zeros_like(g)
    dg = torch.empty_like(g)
    stream = _stream(x)
    build.check(_lib().repro_rmsnorm_bwd(
        x.data_ptr(), dy.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dg.data_ptr(), _bwd_scratch_ptr(x, stream, _partial_rows(x), d),
        x.numel() // d, d, float(eps), code, gcode, stream), "rmsnorm_bwd")
    _bwd_count("rmsnorm")
    return dx, dg


@build.counted("rmsnorm_backward", add_rmsnorm_bwd_work)
def add_rmsnorm_bwd(s: torch.Tensor, gamma: torch.Tensor, dh: torch.Tensor,
                    ds: torch.Tensor | None, *, eps: float = 1e-6
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(d(x + y), dγ) of ``add_rmsnorm`` from its residual s, the norm's
    output gradient dh and the residual's own gradient ds (None: s was
    not used), added in the same pass."""
    if build.plain(s):
        return add_rmsnorm_bwd_ref(s, gamma, dh, ds, eps)
    _require_card("add_rmsnorm_bwd", s)
    grads = (dh,) if ds is None else (dh, ds)
    code, grads = _bwd_rows("add_rmsnorm_bwd", s, *grads)
    dh, ds = grads[0], (grads[1] if ds is not None else None)
    g, gcode = _bwd_gamma("add_rmsnorm_bwd", gamma, s)
    d = s.shape[-1]
    dx = torch.empty_like(s)
    if not s.numel():
        return dx, torch.zeros_like(g)
    dg = torch.empty_like(g)
    stream = _stream(s)
    build.check(_lib().repro_add_rmsnorm_bwd(
        s.data_ptr(), dh.data_ptr(), None if ds is None else ds.data_ptr(),
        g.data_ptr(), dx.data_ptr(), dg.data_ptr(),
        _bwd_scratch_ptr(s, stream, _partial_rows(s), d),
        s.numel() // d, d, float(eps), code, gcode, stream),
        "add_rmsnorm_bwd")
    _bwd_count("add_rmsnorm")
    return dx, dg


@build.counted("rmsnorm_backward", qk_norm_rope_bwd_work)
def qk_norm_rope_bwd(q: torch.Tensor, k: torch.Tensor, gamma_q: torch.Tensor,
                     gamma_k: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor, dq_out: torch.Tensor,
                     dk_out: torch.Tensor, *, eps: float = 1e-6
                     ) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dγq, dγk) of ``qk_norm_rope`` for the gradients of q' and
    k', both tensors in one launch: a block takes a run of tokens with all
    their q and k head rows, and reads each token's cos/sin row once."""
    if build.plain(q):
        return qk_norm_rope_bwd_ref(q, k, gamma_q, gamma_k, cos, sin,
                                    dq_out, dk_out, eps)
    _require_card("qk_norm_rope_bwd", q)
    code, (dq_out,) = _bwd_rows("qk_norm_rope_bwd", q, dq_out,
                                vectors=_ROPE_VECTORS)
    _, (dk_out,) = _bwd_rows("qk_norm_rope_bwd", k, dk_out,
                             vectors=_ROPE_VECTORS)
    if k.dtype != q.dtype or k.dim() != 4 or q.dim() != 4 \
            or k.shape[:2] + k.shape[3:] != q.shape[:2] + q.shape[3:]:
        raise ValueError(f"qk_norm_rope_bwd: k {tuple(k.shape)} {k.dtype} "
                         f"does not match q {tuple(q.shape)} {q.dtype}")
    b, length, hq, d = q.shape
    hkv = k.shape[2]
    for name, t in (("cos", cos), ("sin", sin)):
        if t.shape != (b, length, d // 2) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"qk_norm_rope_bwd: {name} must be (B, L, D/2) "
                             f"float32, contiguous, 16-byte aligned, on q's "
                             f"device")
    gq, gcode = _bwd_gamma("qk_norm_rope_bwd", gamma_q, q)
    gk, gcode_k = _bwd_gamma("qk_norm_rope_bwd", gamma_k, k)
    if gcode_k != gcode:
        raise TypeError(f"qk_norm_rope_bwd: gamma_q {gamma_q.dtype} and "
                        f"gamma_k {gamma_k.dtype} differ")
    dq, dk = torch.empty_like(q), torch.empty_like(k)
    if not q.numel():
        return dq, dk, torch.zeros_like(gq), torch.zeros_like(gk)
    dgq, dgk = torch.empty_like(gq), torch.empty_like(gk)
    stream = _stream(q)
    scratch = _bwd_scratch_ptr(q, stream, _partial_rows(q, b * length), 2 * d)
    build.check(_lib().repro_qk_norm_rope_bwd(
        q.data_ptr(), k.data_ptr(), dq_out.data_ptr(), dk_out.data_ptr(),
        gq.data_ptr(), gk.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dgq.data_ptr(), dgk.data_ptr(),
        scratch, b * length * hq, b * length * hkv, hq, hkv, d, float(eps),
        code, gcode, stream), "qk_norm_rope_bwd")
    _bwd_count("qk_norm_rope")
    return dq, dk, dgq, dgk


# ---------------------------------------------------------------------------
# autograd entries: the forward entry and its backward
# ---------------------------------------------------------------------------

class RMSNormFn(torch.autograd.Function):
    """``rmsnorm(x, γ)`` with its backward: the kernel on the card, the
    plain versions on the CPU.  ``RMSNormFn.apply(x, gamma, eps[,
    warps])``: the forward's block (the backward keeps its launch)."""

    @staticmethod
    def forward(ctx, x, gamma, eps, warps=None):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return rmsnorm(x, gamma, eps=eps, warps=warps)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dg = rmsnorm_bwd(x, gamma, dy, eps=ctx.eps)
        return dx, dg, None, None


class AddRMSNormFn(torch.autograd.Function):
    """``add_rmsnorm(x, y, γ) -> (s, h)`` with its backward; the gradient
    of s (None when s is not used) joins the norm's in the same launch.
    ``AddRMSNormFn.apply(x, y, gamma, eps[, warps])``."""

    @staticmethod
    def forward(ctx, x, y, gamma, eps, warps=None):
        s, h = add_rmsnorm(x, y, gamma, eps=eps, warps=warps)
        ctx.save_for_backward(s, gamma)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return s, h

    @staticmethod
    @once_differentiable
    def backward(ctx, ds, dh):
        s, gamma = ctx.saved_tensors
        if dh is None:
            dx, dg = ds, torch.zeros_like(gamma)
        else:
            dx, dg = add_rmsnorm_bwd(s, gamma, dh, ds, eps=ctx.eps)
        return dx, dx, dg, None, None


class QKNormRopeFn(torch.autograd.Function):
    """``qk_norm_rope`` with its backward (q and k in one launch each
    way).  ``QKNormRopeFn.apply(q, k, gamma_q, gamma_k, cos, sin, eps)``;
    cos and sin get no gradient."""

    @staticmethod
    def forward(ctx, q, k, gamma_q, gamma_k, cos, sin, eps):
        ctx.save_for_backward(q, k, gamma_q, gamma_k, cos, sin)
        ctx.eps = eps
        return qk_norm_rope(q, k, gamma_q, gamma_k, cos, sin, eps=eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, dq_out, dk_out):
        q, k, gq, gk, cos, sin = ctx.saved_tensors
        dq, dk, dgq, dgk = qk_norm_rope_bwd(q, k, gq, gk, cos, sin, dq_out,
                                            dk_out, eps=ctx.eps)
        return dq, dk, dgq, dgk, None, None, None
