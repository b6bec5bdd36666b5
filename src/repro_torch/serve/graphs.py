"""Each decode dispatch as one device program: a step body over static
buffers, captured once into a CUDA graph and replayed per step.

The reference compiles a dispatch into one XLA program (``jax.jit`` of a
``lax.fori_loop``, or a ``while_loop`` for speculation,
``repro.serve.decode_loop``): one host call per dispatch whatever its
depth.  Here a step body (``decode_loop``) reads and writes only the
tensors of a ``StepState`` — tokens, positions, budgets, the step
counter, the output rows, the page table, the history ring — so it has
no shape and no branch that depends on the host.  ``StepRunner`` copies a
dispatch's inputs into that state and runs the body once per step:

* on the CPU, eagerly (the plain version, as the kernels' wrappers run
  their plain versions for CPU tensors);
* on the card, the first step of a new key runs eagerly on the capture
  stream, is then captured into a ``torch.cuda.CUDAGraph`` and every
  later step replays it: one ``cudaGraphLaunch`` per step.

A graph holds raw addresses: of the weights, the K/V stores, the
recurrent states, the step state and the attention scratch.  So a runner
keys its graph by the params object (held, never copied), the
``data_ptr`` of every cache tensor, the lane count,
the depth and the table and history shapes, and captures anew when any
changes; ``DecodeGraphs`` owns an attention scratch sized for the
largest step (every verify width, the cache's capacity) before the first
capture, binds it around every capture (``kfa.scratch_buffer``) and
holds it as long as the graphs; a capture that would need more, or that
runs with no bound buffer, raises in the wrapper
(``kernels/flash_attention._scratch_ptr``).  A graph also bakes in the
kernels' plans: with a measured kernel tuner
(``models.flags.KERNEL_TUNER`` when the dispatch loads the runner) the
eager step before the capture resolves every plan on the dispatch's own
lanes (a search synchronises, so it may not run inside the capture,
where a miss raises), the scratch is sized for the largest plan any
candidate may take (``tuning.attention_scratch_reserve``), and the tuner
and the winners the capture used join its key: another tuner, or a
changed winner, captures anew.  All captures of a device
share one side stream: the cuBLAS handle keeps a workspace for every
stream it ever ran on, for the life of the process.

On a mesh (``ServeScheduler(mesh=)``) the body's forward holds the
tensor-parallel collectives (``models/flags.TP``): NCCL records them
into the graph like any kernel, each rank capturing its own.  NCCL
builds a group's communicator at its first collective, which may not
happen inside a capture, so ``launch/mesh.make_mesh`` runs one eager
collective on every group of the mesh; gloo has no capture, and on the
CPU the step runs eagerly as it always does.

Counting: a replay runs no Python, so no wrapper counts its launches.
The runner records what every ``LaunchCounter`` counted while capturing,
takes it back (a capture launches nothing) and adds it at each replay;
``replay_listeners`` hear of each replay with its ``Capture`` (its
forward's (B, L) and that tally).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Callable

import torch

from ..core import strict
from ..kernels import build
from ..kernels import flash_attention as kfa
from ..kernels import tuning
from ..models import flags

# Called with the ``Capture`` at every replay (``chip_smoke.ForwardSpy``
# counts kernel 1 per forward through it).
replay_listeners: list[Callable[[Capture], None]] = []

# The capture stream of each device, shared by every DecodeGraphs (see
# the module docstring).
_streams: dict = {}


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


@dataclasses.dataclass
class Capture:
    """One captured step: its graph, the launches one replay makes
    (``build.tally_since``), and the (B, L) of the forward inside it."""

    graph: Any
    tally: dict
    forward: tuple[int, int]


@dataclasses.dataclass
class StepState:
    """The static buffers a step body reads and writes in place; ``n``
    lanes, ``max_depth`` output rows."""

    toks: torch.Tensor      # (n,) long: each lane's carry token
    poss: torch.Tensor      # (n,) long: each lane's next cache position
    rem: torch.Tensor       # (n,) long: tokens left in the dispatch
    rem0: torch.Tensor      # (n,) long: the dispatch's budgets
    j: torch.Tensor         # (1,) long: the step counter (out row)
    out: torch.Tensor       # (max_depth, n) long: emitted tokens
    rounds: torch.Tensor    # (n,) long: speculative rounds per lane
    table: torch.Tensor | None = None   # (n, n_blocks) int32 page table
    hist: torch.Tensor | None = None    # (n, h) long history ring

    @classmethod
    def empty(cls, n: int, max_depth: int, device: torch.device,
              table_shape=None, hist_shape=None) -> StepState:
        def z(*shape, dtype=torch.long):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(z(n), z(n), z(n), z(n), z(1), z(max_depth, n), z(n),
                   None if table_shape is None
                   else z(*table_shape, dtype=torch.int32),
                   None if hist_shape is None else z(*hist_shape))


class DecodeGraphs:
    """What the decode graphs of one scheduler share: one memory pool,
    the attention scratch sized before the first capture, and the counts
    a report reads (captures per kind, replays).
    ``capture=False`` runs every step eagerly on the card as well: the
    graphs' plain version, which ``chip_smoke.py`` holds them against."""

    def __init__(self, *, capture: bool = True):
        self.capture = capture
        self.captures: collections.Counter = collections.Counter()
        self.replays = 0
        # Bumped when the scratch grows: graphs of an older generation
        # baked the freed address and are captured anew.
        self.generation = 0
        self.scratch: torch.Tensor | None = None
        self.pool = None

    @property
    def scratch_bytes(self) -> int:
        return 0 if self.scratch is None else self.scratch.numel()

    @staticmethod
    def stream(device: torch.device):
        if device.index not in _streams:
            _streams[device.index] = torch.cuda.Stream(device)
        return _streams[device.index]

    def reserve(self, nbytes: int, device: torch.device) -> None:
        """Own at least ``nbytes`` of attention scratch."""
        if nbytes <= self.scratch_bytes:
            return
        if self.scratch is not None:
            self.generation += 1
        self.scratch = torch.empty(nbytes, dtype=torch.uint8, device=device)

    def pool_bytes(self) -> int:
        """Device memory the graphs' pool holds (its segments in the
        caching allocator's snapshot)."""
        if self.pool is None:
            return 0
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == tuple(self.pool))


class StepRunner:
    """One step body over its ``StepState``.  ``heads`` (Hq, Hkv),
    ``page_size`` and ``widths`` (every query length a step of these
    graphs attends with) size the attention scratch; ``length`` is the
    query length of this step's forward.  The kernel tuner the body's
    forward resolves its plans through is ``models.flags.KERNEL_TUNER``
    at ``load``."""

    def __init__(self, graphs: DecodeGraphs, kind: str,
                 body: Callable[[Any, list, StepState], None], *,
                 length: int, heads: tuple[int, int],
                 widths: tuple[int, ...], page_size: int | None = None):
        self.graphs = graphs
        self.kind = kind
        self.body = body
        self.length = length
        self.heads = heads
        self.widths = widths
        self.page_size = page_size
        self.tuner = None         # flags.KERNEL_TUNER at the last load
        self.state: StepState | None = None
        self._key = None
        self._params = None
        self._caches: list | None = None
        self._capture: Capture | None = None
        self._generation = -1
        self._plans: tuple = ()   # (key, winner) the capture baked in

    def _plans_changed(self, tuner) -> bool:
        return tuner is not self.tuner or tuner is not None and any(
            tuner.winner(key) != winner for key, winner in self._plans)

    def load(self, params, caches: list, toks: torch.Tensor,
             poss: torch.Tensor, budget: list[int], max_depth: int,
             table: torch.Tensor | None = None,
             hist: torch.Tensor | None = None) -> StepState:
        """Copy one dispatch's inputs into the state (a new state, and a
        new capture at the next step, when the key changed)."""
        dev = toks.device
        tuner = flags.KERNEL_TUNER
        key = (dev, len(budget), max_depth,
               None if table is None else tuple(table.shape),
               None if hist is None else tuple(hist.shape),
               tuple(t.data_ptr() for c in caches for t in c.values()))
        if key != self._key or params is not self._params \
                or self._generation != self.graphs.generation \
                or self._plans_changed(tuner):
            self._key, self._params, self._caches = key, params, caches
            self.tuner = tuner
            self._capture = None
            self._generation = self.graphs.generation
            self.state = StepState.empty(
                len(budget), max_depth, dev,
                None if table is None else table.shape,
                None if hist is None else hist.shape)
        st = self.state
        st.toks.copy_(toks)
        st.poss.copy_(poss)
        st.rem.copy_(torch.tensor(budget, dtype=torch.long),
                     non_blocking=True)
        st.rem0.copy_(st.rem)
        st.j.zero_()
        st.out.zero_()
        st.rounds.zero_()
        if table is not None:
            st.table.copy_(table)
        if hist is not None:
            st.hist.copy_(hist)
        return st

    def step(self) -> None:
        """Run the body once over the loaded state."""
        st = self.state
        if not _on_card(st.toks) or not self.graphs.capture:
            self.body(self._params, self._caches, st)
            return
        if self._capture is None:
            self._capture = self._run_and_capture()
            return
        cap = self._capture
        cap.graph.replay()
        build.add_tally(cap.tally)
        self.graphs.replays += 1
        for listener in replay_listeners:
            listener(cap)

    def _scratch_need(self) -> int:
        """Bytes of attention scratch the largest step needs, sized from
        the first attention layer's store (0 with no attention layer):
        the analytic plans', or with a tuner the largest any candidate
        plan may take."""
        st = self.state
        store = next((c["k"] for c in self._caches if "k" in c), None)
        if store is None:
            return 0
        skv = store.shape[2] if st.table is None \
            else st.table.shape[1] * self.page_size
        hq, hkv = self.heads
        d = store.shape[-1]
        if self.tuner is not None:
            return tuning.attention_scratch_reserve(
                len(st.toks), hq, hkv, self.widths, skv, store.dtype, d)
        return max(kfa.attention_plan(len(st.toks), hq, hkv, sq,
                                      store.dtype).scratch_bytes(skv, d)
                   for sq in self.widths)

    def _run_and_capture(self) -> Capture:
        """This step, eagerly on the capture stream (the warm-up the
        capture needs, and the dispatch's real step), then its capture."""
        st, params, caches = self.state, self._params, self._caches
        dev = st.toks.device
        graphs = self.graphs
        side = graphs.stream(dev)
        if graphs.pool is None:
            graphs.pool = torch.cuda.graph_pool_handle()
        graphs.reserve(self._scratch_need(), dev)
        self._generation = graphs.generation
        here = torch.cuda.current_stream(dev)
        side.wait_stream(here)
        tuner = self.tuner
        with kfa.scratch_buffer(graphs.scratch), (
                tuner.recording() if tuner is not None
                else contextlib.nullcontext({})) as plans:
            # The eager step resolves every plan the capture will read.
            with torch.cuda.stream(side):
                self.body(params, caches, st)
            before = build.snapshot()
            graph = torch.cuda.CUDAGraph()
            with strict.allow_sync():      # the capture synchronises
                with torch.cuda.graph(graph, pool=graphs.pool, stream=side):
                    self.body(params, caches, st)
            tally = build.tally_since(before)
            build.restore(before)          # a capture launches nothing
        self._plans = tuple(plans.items())
        here.wait_stream(side)
        graphs.captures[self.kind] += 1
        return Capture(graph, tally, (len(st.toks), self.length))
