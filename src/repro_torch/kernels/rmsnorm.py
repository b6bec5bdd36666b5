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
entry's counter in ``entry_launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = build.LaunchCounter("rmsnorm")
entry_launches = {name: build.LaunchCounter(name) for name in
                  ("rmsnorm", "add_rmsnorm", "qk_norm_rope")}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Row widths with a compile-time register layout in csrc/rmsnorm.cu:
# 8..256 vectors of 16 bytes (bf16 d 64..2048, f32 d 32..1024).  Other
# widths that are a multiple of 8 take the kernel's generic loop.  The
# rotary entry takes head rows of 8..128 vectors (bf16 head dims
# 64..1024) and no others.
_ROPE_VECTORS = (8, 16, 32, 64, 128)


def reset_counts() -> None:
    launches.reset()
    for c in entry_launches.values():
        c.reset()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``(x / sqrt(mean(x²) + eps)) · γ`` in f32, cast back to x's type."""
    xf = x.float()
    rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf / rms) * gamma.float()).to(x.dtype)


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
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
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


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    lib = build.library("rmsnorm")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {"repro_rmsnorm": [vp, vp, vp, i, i, f, i, vp],
            "repro_add_rmsnorm": [vp, vp, vp, vp, vp, i, i, f, i, vp],
            "repro_qk_norm_rope": [vp, vp, vp, vp, vp, vp, vp, vp, i, i, i,
                                   i, i, f, i, vp]}
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


def _gamma(name: str, gamma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    if gamma.shape != (d,) or gamma.device != x.device:
        raise ValueError(f"{name}: gamma {tuple(gamma.shape)} on "
                         f"{gamma.device} does not match (..., {d}) on "
                         f"{x.device}")
    return gamma.float().contiguous()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _count(entry: str) -> None:
    launches.add()
    entry_launches[entry].add()


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d), γ: (d,).  Leading dims are flattened to rows."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, gamma, eps)
    _require_card("rmsnorm", x)
    code = _rows_input("rmsnorm", x)
    g = _gamma("rmsnorm", gamma, x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    d = x.shape[-1]
    build.check(_lib().repro_rmsnorm(
        x.data_ptr(), g.data_ptr(), out.data_ptr(), x.numel() // d, d,
        float(eps), code, _stream(x)), "rmsnorm")
    _count("rmsnorm")
    return out


def add_rmsnorm(x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor, *,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """x, y: (..., d) of one type, γ: (d,).  Returns (s, h): the residual
    ``s = x + y`` (the same bits as PyTorch's ``x + y``) and ``h =
    rmsnorm(s, γ)`` (the same bits as ``rmsnorm`` on that ``s``)."""
    if x.device.type == "cpu":
        return add_rmsnorm_ref(x, y, gamma, eps)
    _require_card("add_rmsnorm", x)
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
        x.numel() // d, d, float(eps), code, _stream(x)), "add_rmsnorm")
    _count("add_rmsnorm")
    return s, h


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor, gamma_q: torch.Tensor,
                 gamma_k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 *, eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, L, Hq, D), k: (B, L, Hkv, D) of one type; γq, γk: (D,);
    cos/sin: (B, L, D/2) f32.  Returns (q', k') of q's and k's shapes:
    each head row normed, rounded to the type, rotated (rotate-half) and
    rounded again, the bits of ``rmsnorm`` followed by ``rope_ref``."""
    if q.device.type == "cpu":
        return qk_norm_rope_ref(q, k, gamma_q, gamma_k, cos, sin, eps)
    _require_card("qk_norm_rope", q)
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
