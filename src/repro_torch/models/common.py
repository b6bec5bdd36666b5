"""Shared model-layer primitives: plain functions on tensors and
parameter dicts (the counterpart of ``repro.models.common``).

``linear`` and ``embed`` take the compute dtype, as the reference's do.
The serve path holds its weights in that dtype from the moment they are
loaded, so no cast is launched there (the JAX package casts f32
parameters to bf16 inside every jitted call, which XLA folds; eagerly
that would re-read the f32 weights at every step).  Training keeps f32
master weights (``lm.init_params(..., dtype=...)``) and casts each one
once per call.  Norm gains stay in f32, the dtype the norm computes in.

The three norms go through kernel 1's autograd entries
(``kernels/rmsnorm.py``: the kernel forward and backward on the card,
their plain versions on the CPU) whenever autograd records the call;
when it records nothing (serving, ``torch.no_grad``), they call the
same forward entry directly, without the autograd wrapper's host cost
on every eager prefill forward.  With a measured kernel tuner set
(``flags.KERNEL_TUNER``) ``rmsnorm`` and ``add_rmsnorm`` resolve kernel
1's warps per block through it and pass them down; with none they pass
nothing.

Under a tensor-parallel context (``flags.TP``) the row-parallel products
end in *g* (``linear_rows``, ``embed``), the input of every
column-parallel one goes through *f* (``column_input``) and the
vocabulary-parallel logits through the gather (``gather_vocab``): the
differentiable collectives of ``collectives.py``, which train as the
reference's GSPMD step does.  Under an FSDP context (``flags.FSDP``)
``fsdp_params`` gathers a subtree's 'data' blocks.

Under sequence parallelism (``flags.SP``, Megatron-SP) the residual
stream holds this rank's rows of the sequence: a block's input is
gathered once (``block_input``: ``collectives.gather_seq``, whose
backward reduce-scatters the gradient of a split block's input, or
keeps this rank's rows of a whole block's), a split block's row-parallel
product ends in ``collectives.scatter_seq_sum`` and a whole one keeps
its rows (``linear_rows``), the vocab-split embedding reduce-scatters
the sequence (``embed``), and a norm over the rank's rows takes its gain
through *f* (``row_norm``), since the rank holds only its rows' part of
the gain's gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import collectives
from ..kernels import build, ops as kops, rmsnorm as krms
from . import flags


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if t.dtype == dtype else t.to(dtype)


def linear(p: dict, x: torch.Tensor,
           compute_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w (+ b)`` in ``compute_dtype``; a weight already in it is
    used as it is."""
    out = _cast(x, compute_dtype) @ _cast(p["w"], compute_dtype)
    if "b" in p:
        out = out + _cast(p["b"], compute_dtype)
    return out


def linear_rows(p: dict, x: torch.Tensor, compute_dtype: torch.dtype,
                split: bool) -> torch.Tensor:
    """``linear`` of a row-parallel weight (``wo``, ``w_down``): with a
    tensor-parallel context (``flags.TP``) and ``split``, ``x`` holds
    this rank's columns and ``w`` its rows, and the partial products are
    summed by one ``all_reduce`` over the model group before the bias
    (*g*: under autograd the gradient passes through).  Under sequence
    parallelism the sum is a reduce-scatter to this rank's rows
    (``collectives.scatter_seq_sum``), and a whole block keeps its rows
    (``keep_rows``): the block's output is the residual's rows."""
    tp = flags.TP
    if tp is None or not split:
        return keep_rows(linear(p, x, compute_dtype))
    out = _cast(x, compute_dtype) @ _cast(p["w"], compute_dtype)
    sp = flags.SP
    if sp is None:
        out = collectives.reduce_from_model(out, tp.group)
    else:
        out = collectives.scatter_seq_sum(out, sp.group, sp.size)
    if "b" in p:
        out = out + _cast(p["b"], compute_dtype)
    return out


def embed(p: dict, tokens: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    """The table's rows of ``tokens`` in ``compute_dtype``.  A gather by
    ``index_select``, whose backward is an ``index_add_`` (no host
    synchronisation, so a train step holds under strict mode).  With a
    vocab-parallel context (``flags.TP``) the table is this rank's rows:
    tokens outside them look up zeros, and an ``all_reduce`` over the
    model group sums the one rank's row with the others' zeros (exact)."""
    tp = flags.TP
    if tp is None or not tp.vocab:
        rows = torch.index_select(p["table"], 0, tokens.reshape(-1))
        return keep_rows(_cast(rows.view(*tokens.shape, -1), compute_dtype))
    if tp.size == 1:
        # One rank holds every row: no token lies outside them.
        rows = _cast(torch.index_select(p["table"], 0, tokens.reshape(-1)),
                     compute_dtype)
    else:
        n = p["table"].shape[0]
        local = tokens.reshape(-1) - tp.index * n
        inside = (local >= 0) & (local < n)
        rows = torch.index_select(p["table"], 0,
                                  torch.where(inside, local, 0))
        rows = _cast(torch.where(inside[:, None], rows, 0.0), compute_dtype)
    sp = flags.SP
    if sp is not None:
        return collectives.scatter_seq_sum(rows.view(*tokens.shape, -1),
                                           sp.group, sp.size)
    rows = collectives.reduce_from_model(rows, tp.group)
    return rows.view(*tokens.shape, -1)


def column_input(x: torch.Tensor, split: bool) -> torch.Tensor:
    """The input of a column-parallel product (``wq``/``wk``/``wv``,
    ``w_up``/``w_gate``, the head, the experts' up products): with a
    tensor-parallel context that splits it, *f* — the same values, and
    in the backward the model ranks' partial gradients summed.  Else,
    under autograd recording, a view: like *f*, it sums its readers'
    gradients before they join the input's other readers' (zamba2's
    shared block also adds its input to the residual), so a step sums
    them in one order with or without a split."""
    tp = flags.TP
    if tp is None or not split:
        return x.view_as(x) if torch.is_grad_enabled() and x.requires_grad \
            else x
    return collectives.copy_to_model(x, tp.group)


def block_input(x: torch.Tensor, split: bool) -> torch.Tensor:
    """A block's input ``x`` (B, L, d), read by its column-parallel
    products: ``column_input`` (*f* where ``split``), or under sequence
    parallelism (``flags.SP``) the model ranks' rows gathered on the
    sequence dim, once per block (``collectives.gather_seq``; a split
    block's readers each hold part of the gradient, which the backward
    reduce-scatters; a whole block's hold all of it, and each rank keeps
    its rows)."""
    sp = flags.SP
    if sp is None:
        return column_input(x, split)
    return collectives.gather_seq(x, sp.group, sp.size, sp.index,
                                  reduce=split)


def keep_rows(x: torch.Tensor) -> torch.Tensor:
    """Under sequence parallelism, this rank's rows of ``x`` (B, S, ...),
    which every model rank computed whole (``collectives.keep_seq``);
    ``x`` itself otherwise."""
    sp = flags.SP
    if sp is None:
        return x
    return collectives.keep_seq(x, sp.group, sp.size, sp.index)


def row_params(p: dict) -> dict:
    """The parameters of a product or norm over the residual's rows (the
    norms, zamba2's per-layer ``proj``): under sequence parallelism each
    leaf goes through *f*, since this rank's rows give only their part
    of its gradient; ``p`` itself otherwise."""
    sp = flags.SP
    if sp is None:
        return p
    return {k: collectives.copy_to_model(v, sp.group) for k, v in p.items()}


def replicated_segment(w: torch.Tensor, lo: int, hi: int,
                       split: bool) -> torch.Tensor:
    """``w`` whose last-dim entries ``[lo, hi)`` are replicated over the
    model group inside a block whose other entries are split (the Mamba2
    B/C columns and conv channels): under a tensor-parallel context that
    splits the block and autograd recording, those entries go through
    *f*, since each model rank's heads read them and hold part of their
    gradient; ``w`` itself otherwise (no copy)."""
    tp = flags.TP
    if tp is None or not split or not (torch.is_grad_enabled()
                                       and w.requires_grad):
        return w
    return torch.cat([w[..., :lo],
                      collectives.copy_to_model(w[..., lo:hi], tp.group),
                      w[..., hi:]], dim=-1)


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """The full logits from this rank's vocabulary columns: one
    ``all_gather`` over the model group with a vocab-parallel context
    (``flags.TP``; its backward keeps this rank's columns), ``logits``
    itself without one."""
    tp = flags.TP
    if tp is None or not tp.vocab:
        return logits
    return collectives.gather_last(logits, tp.group, tp.size, tp.index)


def fsdp_params(p, specs):
    """``p`` (a subtree of the parameters, ``specs`` its training specs)
    with every leaf whose spec holds 'data' gathered over the data axis
    (``collectives.fsdp_gather``) under an FSDP context
    (``flags.FSDP``); ``p`` itself without one."""
    ctx = flags.FSDP
    if ctx is None:
        return p
    if isinstance(p, dict):
        return {k: fsdp_params(v, specs[k]) for k, v in p.items()}
    if isinstance(p, list):
        return [fsdp_params(v, s) for v, s in zip(p, specs, strict=True)]
    if p is None or "data" not in specs:
        return p
    return collectives.fsdp_gather(p, ctx.group, ctx.size, ctx.index,
                                   specs.index("data"))


def _warps(entry: str, x: torch.Tensor) -> int | None:
    tuner = flags.KERNEL_TUNER
    return None if tuner is None else kops.norm_warps(tuner, entry, x)


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim: the CUDA kernel for a CUDA tensor, its
    plain version for a CPU tensor (``kernels/rmsnorm.py``)."""
    warps = _warps("rmsnorm", x)
    if build.records_grad(x, p["g"]):
        return krms.RMSNormFn.apply(x, p["g"], eps, warps)
    return krms.rmsnorm(x, p["g"], eps=eps, warps=warps)


def add_rmsnorm(p: dict, x: torch.Tensor, y: torch.Tensor,
                eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual ``x + y`` and its RMSNorm in one launch of kernel 1:
    returns (x + y, rmsnorm(x + y))."""
    warps = _warps("add_rmsnorm", x)
    if build.records_grad(x, y, p["g"]):
        return krms.AddRMSNormFn.apply(x, y, p["g"], eps, warps)
    return krms.add_rmsnorm(x, y, p["g"], eps=eps, warps=warps)


def qk_norm_rope(pq: dict, pk: dict, q: torch.Tensor, k: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor, eps: float = 1e-5
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """q- and k-norm, then the rotary embedding of both: the values of
    ``apply_rope(rmsnorm(...))``.  In one launch of kernel 1's rotary
    entry where it has a register layout for the head dim and type
    (``rmsnorm.rope_has_layout``), else as that composition: kernel 1's
    ``rmsnorm`` on q and on k, then ``apply_rope``
    (``rmsnorm.QKNormThenRopeFn``: the same bits)."""
    if not krms.rope_has_layout(q.shape[-1], q.dtype):
        return krms.QKNormThenRopeFn.apply(
            q, k, pq["g"], pk["g"], cos, sin, eps, _warps("rmsnorm", q),
            _warps("rmsnorm", k))
    if build.records_grad(q, k, pq["g"], pk["g"]):
        return krms.QKNormRopeFn.apply(q, k, pq["g"], pk["g"], cos, sin,
                                       eps)
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
