"""Model-layer flags (the counterpart of ``repro.models.flags``): the
measured kernel tuner, the tensor-parallel and FSDP contexts, the MoE
dispatch groups and the reference's dry-run context managers.

``KERNEL_TUNER`` is an ``autotune.KernelTuner`` or None.  When set, the
model layers resolve kernel 1's warps per block and kernels 2 and 3's
attention plans through it (``models/common.py``, ``models/attention.py``)
and pass them down; when None they pass nothing and the analytic plans
hold.  The serve path sets it around each forward (``kernel_tuner``),
the train launcher for the run (``--kernel-autotune``), as the reference
sets it around its traces.

``TP`` is a ``TensorParallel`` or None.  When set, the weights a forward
reads are this rank's blocks of a tensor-parallel model (mesh serving,
``launch/sharding.serve_param_specs``): attention runs on the local
heads and ends in one ``all_reduce`` of the row-parallel ``wo``, the
feed-forward the same with ``w_down``, the embedding is a masked local
lookup plus an ``all_reduce`` and the head's local logits are
``all_gather``-ed (``common.linear_rows``, ``common.embed``,
``lm._head``).  A part its plan leaves whole runs on every rank with no
collective.  The scheduler sets it around each tick, as it does the
tuner.  ``TensorParallel.moe`` splits the experts' hidden dim the
same way (``models/moe.py``); ``mamba``, ``mlstm`` and ``slstm`` the
recurrent blocks' heads or channels, their states holding this rank's
(``models/mamba2.py``, ``models/xlstm.py``).  ``attn`` (the
self-attention blocks, zamba2's shared one too) and ``xattn`` (the
cross-attention blocks) are the attention rule of ``launch/sharding.
attention_rule``: "split" (q and kv heads both over 'model'),
"kv_shared" (the q heads split, each rank keeping the one kv head they
read, gathered from the ranks' K/V columns), "head_dim" (every head's
dims split in RoPE pairs, the logits summed over 'model'; the serve
path only) or "whole" (``models/attention.py``).

``SEQ`` is a ``SeqSplit`` or None.  When set, every K/V cache a cached
forward reads holds a contiguous block of the cache's rows, the other
ranks of ``SEQ.group`` the others: a decode step writes its new row on
the rank that holds it, each rank runs kernel 2 over its rows with the
softmax statistics out, and the ranks merge (``attention.merge_blocks``;
the counterpart of the reference's caches with the sequence on 'data'
or 'model').  The dry run and the lock-step engine set it
(``serve/engine.make_decode_step``).

``SP`` is a ``SeqParallel`` or None.  When set (the sharded step under
``seq_shard``: Megatron-SP), the residual stream between blocks holds
this rank's S / n rows of the sequence, ``n`` the 'model' extent: every
block gathers its input's rows once and ends in a reduce-scatter on the
sequence, or, where it runs whole, keeps its own rows of its output;
the norms run on the rank's rows, their gains through *f*
(``models/common.py``, ``models/lm.py``).

``MOE_FF2D`` is an ``FF2DContext`` or None.  When set (the sharded step
under ``moe_ff2d``), the experts' weights are this rank's block of
their hidden dim over ('data', 'model') and are never gathered: the
dispatch buffer is gathered over 'data' instead and the partial output
reduce-scattered back (``models/moe.py``).

``FSDP`` is an ``FSDPContext`` or None.  When set, every leaf a forward
reads whose training spec holds 'data' is this rank's block over the
data axis, gathered where it is read: a layer's leaves at the start of the
layer, inside its ``torch.utils.checkpoint`` region, so that remat
gathers them again in the backward and no two layers' gathered weights
are alive at once; the embedding and the head's at their use
(``lm.py``).  The gather's backward reduce-scatters the gradient
(``collectives.fsdp_gather``).  It also names the batch ranks (every
'pod' and 'data' coordinate), over which the MoE layers place their
choices and take their aux loss (``models/moe.py``).  The sharded train
step sets it (``train/sharded.py``), and the dry run around prefill and
decode too.

``MOE_DISPATCH_GROUPS`` (None or a count) makes the MoE dispatch
group-local, as the reference's does: capacity and places are taken
within each of that many groups of the call's tokens
(``moe_dispatch_groups``).

``unroll_for_accounting`` and ``activation_sharding`` are the
reference's context managers, kept for its callers: an eager count sees
every iteration of every loop, so there is nothing to unroll, and the
hand-written SPMD of the port places every activation by construction,
so ``constrain`` returns its input (ROADMAP.md, Divergences).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

KERNEL_TUNER = None
TP = None
SEQ = None
SP = None
MOE_FF2D = None
FSDP = None
MOE_DISPATCH_GROUPS = None
UNROLL_FOR_ACCOUNTING = False
ACT_SHARDING = None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the 'model' axis and what is split over it
    (``launch/sharding.TPPlan``): ``group`` the model-axis process group,
    ``size`` its extent, ``index`` this rank's coordinate."""

    group: Any
    size: int
    index: int
    attn: str
    ffn: bool
    vocab: bool
    moe: bool = False
    mamba: bool = False
    mlstm: bool = False
    slstm: bool = False
    xattn: str = "whole"


def heads_split(rule: str) -> bool:
    """Whether an attention rule splits the block over 'model' (its
    output row-parallel): every rule but "whole"."""
    return rule != "whole"


@dataclasses.dataclass(frozen=True)
class SeqParallel:
    """The 'model' axis the residual stream's sequence is split over
    under Megatron-SP: ``group`` its process group, ``size`` its extent,
    ``index`` this rank's block of rows (rows ``[index · S/size, (index
    + 1) · S/size)`` of every sequence)."""

    group: Any
    size: int
    index: int


@dataclasses.dataclass(frozen=True)
class FF2DContext:
    """The 'data' axis the weight-stationary experts gather their
    dispatch buffer over: ``group``, ``size``, ``index``."""

    group: Any
    size: int
    index: int


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """The mesh axis a decode cache holds its sequence over
    (``launch/sharding.cache_seq_axis``): ``group`` its process group,
    ``size`` its extent, ``index`` this rank's block of contiguous rows
    (rows ``[index · S, (index + 1) · S)`` of the cache's global rows, S
    the rows a rank holds)."""

    group: Any
    size: int
    index: int


@dataclasses.dataclass(frozen=True)
class FSDPContext:
    """This rank's place on the data axes of a training mesh.

    ``group`` / ``size`` / ``index``: the 'data' axis, over which the
    leaves whose spec holds 'data' are split; ``specs``: the parameter
    tree's specs (``launch/sharding.train_param_specs``), the same
    structure as the parameters; ``batch`` / ``batch_size`` /
    ``batch_index``: every rank that holds other rows of the batch ('pod'
    and 'data'), this rank's index among them in the global row order."""

    group: Any
    size: int
    index: int
    specs: Any
    batch: Any
    batch_size: int
    batch_index: int


@contextlib.contextmanager
def kernel_tuner(tuner):
    global KERNEL_TUNER
    prev = KERNEL_TUNER
    KERNEL_TUNER = tuner
    try:
        yield
    finally:
        KERNEL_TUNER = prev


@contextlib.contextmanager
def tensor_parallel(tp: TensorParallel | None):
    global TP
    prev = TP
    TP = tp
    try:
        yield
    finally:
        TP = prev


@contextlib.contextmanager
def cache_seq(seq: SeqSplit | None):
    global SEQ
    prev = SEQ
    SEQ = seq
    try:
        yield
    finally:
        SEQ = prev


@contextlib.contextmanager
def sequence_parallel(sp: SeqParallel | None):
    global SP
    prev = SP
    SP = sp
    try:
        yield
    finally:
        SP = prev


@contextlib.contextmanager
def moe_ff2d(ctx: FF2DContext | None):
    global MOE_FF2D
    prev = MOE_FF2D
    MOE_FF2D = ctx
    try:
        yield
    finally:
        MOE_FF2D = prev


@contextlib.contextmanager
def fsdp(ctx: FSDPContext | None):
    global FSDP
    prev = FSDP
    FSDP = ctx
    try:
        yield
    finally:
        FSDP = prev


@contextlib.contextmanager
def moe_dispatch_groups(g):
    global MOE_DISPATCH_GROUPS
    prev = MOE_DISPATCH_GROUPS
    MOE_DISPATCH_GROUPS = g
    try:
        yield
    finally:
        MOE_DISPATCH_GROUPS = prev


@contextlib.contextmanager
def unroll_for_accounting():
    global UNROLL_FOR_ACCOUNTING
    prev = UNROLL_FOR_ACCOUNTING
    UNROLL_FOR_ACCOUNTING = True
    try:
        yield
    finally:
        UNROLL_FOR_ACCOUNTING = prev


@contextlib.contextmanager
def activation_sharding(sharding):
    global ACT_SHARDING
    prev = ACT_SHARDING
    ACT_SHARDING = sharding
    try:
        yield
    finally:
        ACT_SHARDING = prev


def constrain(x):
    """The identity: activations sit where the SPMD code put them."""
    return x

