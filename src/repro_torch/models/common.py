"""Shared model-layer primitives: plain functions on tensors and
parameter dicts (the counterpart of ``repro.models.common``).

Weights are held in the compute dtype from the moment they are loaded:
``linear`` and ``embed`` never cast a weight per call (the JAX package
casts f32 parameters to bf16 inside every jitted call, which XLA folds;
eagerly that would re-read the f32 weights at every step).  Norm gains
stay in f32, the dtype the norm computes in.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import rmsnorm as krms


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)`` in the weights' (compute) dtype."""
    w = p["w"]
    out = x.to(w.dtype) @ w
    if "b" in p:
        out = out + p["b"]
    return out


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim: the CUDA kernel for a CUDA tensor, its
    plain version for a CPU tensor (``kernels/rmsnorm.py``)."""
    return krms.rmsnorm(x, p["g"], eps=eps)


def add_rmsnorm(p: dict, x: torch.Tensor, y: torch.Tensor,
                eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual ``x + y`` and its RMSNorm in one launch of kernel 1:
    returns (x + y, rmsnorm(x + y))."""
    return krms.add_rmsnorm(x, y, p["g"], eps=eps)


def qk_norm_rope(pq: dict, pk: dict, q: torch.Tensor, k: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor, eps: float = 1e-5
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """q- and k-norm, then the rotary embedding of both, in one launch
    of kernel 1: the values of ``apply_rope(rmsnorm(...))``."""
    return krms.qk_norm_rope(q, k, pq["g"], pk["g"], cos, sin, eps=eps)


def act_fn(name: str):
    return {"silu": F.silu, "gelu": lambda t: F.gelu(t, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# Rotary position embeddings (rotate-half convention)
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin of shape (..., head_dim // 2)."""
    half = head_dim // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


# x: (B, S, H, D); cos/sin: (B, S, D/2), broadcast over the heads.  The
# arithmetic's one definition is kernel 1's plain version.
apply_rope = krms.rope_ref
