"""Synthetic token batches for training runs (the counterpart of
``repro.data.synthetic``): the same ``np.random.RandomState(seed)``
draws, so a seed gives the JAX package's batch token for token.  Tokens
and labels are int64 here (the index type of PyTorch's gathers).  A
vision arch's batch also holds ``frontend_feats`` (B, T, d), the stub
frontend's patch embeddings: ``randn · 0.02`` from the same stream, in
the compute dtype.  ``input_specs`` gives the dry run's inputs as meta
tensors of the reference's shapes and dtypes (its ``ShapeDtypeStruct``s:
tokens and labels int32), which the model takes as they are."""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..device import resolve_device
from ..models import lm


def batch_shapes(cfg: ArchConfig, batch: int, seq: int,
                 kind: str = "train") -> dict:
    """Logical shapes and dtypes of one batch."""
    lm.check_ported(cfg)
    shapes = {"tokens": ((batch, seq), torch.int64)}
    if kind == "train":
        shapes["labels"] = ((batch, seq), torch.int64)
    if cfg.frontend == "vision":
        shapes["frontend_feats"] = (
            (batch, cfg.num_frontend_tokens, cfg.d_model),
            lm.compute_dtype(cfg))
    return shapes


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                kind_override: str | None = None) -> dict:
    """Meta tensors standing for every model input of a dry-run cell, no
    storage: a decode step's one new token a sequence, a prefill's or a
    train step's whole sequences (with labels for training), and a
    vision arch's ``frontend_feats``; the reference's shapes and dtypes
    (tokens and labels int32)."""
    kind = kind_override or shape.kind
    seq = 1 if kind == "decode" else shape.seq_len
    shapes = batch_shapes(cfg, shape.global_batch, seq,
                          "train" if kind == "train" else kind)
    return {k: torch.empty(s, dtype=torch.int32 if d == torch.int64 else d,
                           device="meta")
            for k, (s, d) in shapes.items()}


def make_batch(cfg: ArchConfig, batch: int, seq: int, *,
               kind: str = "train", seed: int = 0,
               device: str | torch.device = "cuda") -> dict:
    """Tokens (and, for ``kind="train"``, labels) uniform over the
    vocabulary from ``seed``, and a vision arch's ``frontend_feats``, on
    ``device``."""
    lm.check_ported(cfg)
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    out = {"tokens": torch.from_numpy(
        rs.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int64))}
    if kind == "train":
        out["labels"] = torch.from_numpy(
            rs.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int64))
    if cfg.frontend == "vision":
        # f64 draws times 0.02, rounded once to the compute dtype, as the
        # reference's ``jnp.asarray(..., dtype)``.
        feats = rs.randn(batch, cfg.num_frontend_tokens, cfg.d_model) * 0.02
        out["frontend_feats"] = torch.from_numpy(
            feats.astype(np.float32)).to(lm.compute_dtype(cfg))
    return {k: v.to(dev) for k, v in out.items()}


class TokenPipeline:
    """Host-side synthetic token stream with a small prefetch queue (it
    stands in for a corpus loader; ``__iter__`` yields device-ready
    global batches, batch i drawn from seed ``seed + i``)."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int, *,
                 seed: int = 0, prefetch: int = 2,
                 device: str | torch.device = "cuda"):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed = seed
        self.prefetch = prefetch
        self.device = resolve_device(device)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            step = 0
            while not stop.is_set():
                b = make_batch(self.cfg, self.batch, self.seq, kind="train",
                               seed=self.seed + step, device=self.device)
                while not stop.is_set():
                    try:
                        q.put(b, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            t.join(timeout=5)
