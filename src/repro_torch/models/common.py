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

from ..kernels.rmsnorm import rmsnorm as rmsnorm_kernel


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
    return rmsnorm_kernel(x, p["g"], eps=eps)


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


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2), broadcast over the heads."""
    d = x.shape[-1]
    cos, sin = cos[:, :, None], sin[:, :, None]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    out1 = xf1 * cos - xf2 * sin
    out2 = xf2 * cos + xf1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
