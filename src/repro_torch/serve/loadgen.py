"""Seeded request-trace generators (the port's own copy of
``repro.serve.loadgen``: plain numpy, the same arrays for the same seed).

Three arrival processes, one fixed-seed contract: the same
``(generator, n, seed)`` always yields the identical trace, so every
scheduler configuration replays the exact same load and the comparison
is apples-to-apples.

* ``poisson_trace``      — memoryless arrivals at a constant rate: the
  baseline open-loop assumption every queueing result starts from.
* ``bursty_trace``       — a two-state Markov-modulated Poisson process
  (calm rate / burst rate, exponential dwell in each state): the
  traffic shape that punishes greedy admission, because a burst that is
  admitted wholesale parks a wall of prefills in the slot pool.
* ``heavy_tailed_trace`` — lognormal prompt *and* output lengths: a few
  requests are orders of magnitude longer than the median, the regime
  real LM serving lives in (and the acceptance trace for this repo's
  front end).
* ``templated_trace``    — motif-tiled prompts with high n-gram
  self-overlap: the structured-output shape where a prompt-lookup
  speculative drafter earns its keep.

Every request carries an SLO deadline derived from an ``SLOModel``
(TTFT allowance plus a per-token inter-token budget — longer answers
legitimately get more time), which is what turns a replay into a
goodput measurement instead of a throughput one.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class SLOModel:
    """Deadline = arrival + ttft_s + per_token_s * new_tokens."""

    ttft_s: float = 0.75
    per_token_s: float = 0.06

    def deadline_offset(self, new_tokens: int) -> float:
        return self.ttft_s + self.per_token_s * max(int(new_tokens), 1)


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One request in a trace: arrival offset (seconds from trace
    start), prompt/output lengths, and the absolute-offset deadline
    (None: no SLO on this request).  ``prefix_len`` > 0 marks the first
    that many prompt tokens as the trace's *shared system prompt*:
    ``materialize`` gives every such request the identical token
    content there, so a prefix-caching pool can recognise and reuse
    it."""

    arrival_s: float
    prompt_len: int
    new_tokens: int
    deadline_s: float | None
    prefix_len: int = 0
    # ``motif_len`` > 0 marks a *templated* prompt: ``materialize``
    # builds it by tiling a seeded per-request motif of that length, so
    # the token stream has high n-gram self-overlap — the regime where
    # a prompt-lookup speculative drafter gets real acceptance.
    motif_len: int = 0


def _finalize(arrivals, plens, news, slo: SLOModel | None,
              prefix_lens=None, motif_lens=None) -> list[TraceRequest]:
    out = []
    pre = prefix_lens if prefix_lens is not None else [0] * len(arrivals)
    mot = motif_lens if motif_lens is not None else [0] * len(arrivals)
    for t, p, n, x, m in zip(arrivals, plens, news, pre, mot,
                             strict=True):
        p, n = int(max(p, 1)), int(max(n, 1))
        d = None if slo is None else float(t) + slo.deadline_offset(n)
        out.append(TraceRequest(float(t), p, n, d, int(x), int(m)))
    return out


def poisson_trace(n: int, *, rate_rps: float,
                  prompt_lens: tuple[int, ...] = (8, 16, 32),
                  new_tokens: int = 12, seed: int = 0,
                  slo: SLOModel | None = SLOModel()) -> list[TraceRequest]:
    """Constant-rate Poisson arrivals, prompt lengths drawn uniformly
    from ``prompt_lens``."""
    rng = np.random.RandomState(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, size=n))
    plens = rng.choice(np.asarray(prompt_lens), size=n)
    news = np.full(n, new_tokens)
    return _finalize(arrivals, plens, news, slo)


def bursty_trace(n: int, *, base_rate_rps: float, burst_rate_rps: float,
                 mean_dwell_s: tuple[float, float] = (1.0, 0.25),
                 prompt_lens: tuple[int, ...] = (8, 16, 32),
                 new_tokens: int = 12, seed: int = 0,
                 slo: SLOModel | None = SLOModel()) -> list[TraceRequest]:
    """Two-state MMPP: exponential dwell in a calm state
    (``base_rate_rps``) and a burst state (``burst_rate_rps``), Poisson
    arrivals at the current state's rate."""
    rng = np.random.RandomState(seed)
    rates = (float(base_rate_rps), float(burst_rate_rps))
    t, state = 0.0, 0
    next_switch = rng.exponential(mean_dwell_s[0])
    arrivals = []
    while len(arrivals) < n:
        dt = rng.exponential(1.0 / rates[state])
        if t + dt >= next_switch:
            # State flips before the next arrival lands: restart the
            # draw from the switch point at the new rate (memoryless).
            t = next_switch
            state = 1 - state
            next_switch = t + rng.exponential(mean_dwell_s[state])
            continue
        t += dt
        arrivals.append(t)
    plens = rng.choice(np.asarray(prompt_lens), size=n)
    news = np.full(n, new_tokens)
    return _finalize(arrivals, plens, news, slo)


def heavy_tailed_trace(n: int, *, rate_rps: float,
                       median_prompt: int = 12, prompt_sigma: float = 0.7,
                       median_new: int = 8, new_sigma: float = 0.6,
                       max_prompt: int = 96, max_new: int = 48,
                       seed: int = 0,
                       slo: SLOModel | None = SLOModel()
                       ) -> list[TraceRequest]:
    """Poisson arrivals with lognormal prompt and output lengths
    (median-parameterised, clipped to the slot geometry): the
    heavy-tailed length mix where a handful of long requests dominate
    the token budget."""
    rng = np.random.RandomState(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, size=n))
    plens = np.clip(np.rint(rng.lognormal(
        math.log(median_prompt), prompt_sigma, size=n)), 1, max_prompt)
    news = np.clip(np.rint(rng.lognormal(
        math.log(median_new), new_sigma, size=n)), 1, max_new)
    return _finalize(arrivals, plens, news, slo)


def shared_prefix_trace(n: int, *, rate_rps: float, prefix_len: int = 24,
                        shared_fraction: float = 0.9,
                        median_suffix: int = 6, suffix_sigma: float = 0.7,
                        max_suffix: int = 32,
                        median_new: int = 8, new_sigma: float = 0.6,
                        max_new: int = 32, seed: int = 0,
                        slo: SLOModel | None = SLOModel()
                        ) -> list[TraceRequest]:
    """Poisson arrivals where a seeded ``shared_fraction`` of requests
    open with the *same* hot system prompt (``prefix_len`` tokens,
    identical content under ``materialize``) followed by a heavy-tailed
    lognormal unique suffix — the chatbot / RAG shape where most of
    every prompt's KV work is redundant across requests.  The workload
    a paged pool with copy-on-write prefix reuse is built for: the
    prefix is prefilled once, later requests map its pages read-only
    and only pay for their suffix."""
    rng = np.random.RandomState(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, size=n))
    shared = rng.random_sample(n) < shared_fraction
    suffixes = np.clip(np.rint(rng.lognormal(
        math.log(median_suffix), suffix_sigma, size=n)), 1, max_suffix)
    plens = np.where(shared, prefix_len + suffixes, suffixes)
    news = np.clip(np.rint(rng.lognormal(
        math.log(median_new), new_sigma, size=n)), 1, max_new)
    prefix_lens = np.where(shared, prefix_len, 0)
    return _finalize(arrivals, plens, news, slo, prefix_lens)


def templated_trace(n: int, *, rate_rps: float, motif_len: int = 8,
                    median_prompt: int = 24, prompt_sigma: float = 0.4,
                    max_prompt: int = 96,
                    median_new: int = 12, new_sigma: float = 0.5,
                    max_new: int = 48, seed: int = 0,
                    slo: SLOModel | None = SLOModel()
                    ) -> list[TraceRequest]:
    """Poisson arrivals whose prompts are *templated*: each is a seeded
    ``motif_len``-token motif tiled out to the prompt length (see
    ``materialize``), giving the token stream high n-gram self-overlap.
    Greedy continuations of such prompts keep cycling the motif, so a
    prompt-lookup speculative drafter sees real acceptance — the trace
    a ``--speculate`` run measures its win on (structured
    form-filling / code-completion-like load, as opposed to the
    near-zero-overlap random-token traces above)."""
    rng = np.random.RandomState(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, size=n))
    plens = np.clip(np.rint(rng.lognormal(
        math.log(median_prompt), prompt_sigma, size=n)),
        max(motif_len, 1), max_prompt)
    news = np.clip(np.rint(rng.lognormal(
        math.log(median_new), new_sigma, size=n)), 1, max_new)
    motifs = np.full(n, max(int(motif_len), 1))
    return _finalize(arrivals, plens, news, slo, motif_lens=motifs)


GENERATORS = {
    "poisson": poisson_trace,
    "bursty": bursty_trace,
    "heavy": heavy_tailed_trace,
    "shared_prefix": shared_prefix_trace,
    "templated": templated_trace,
}


def materialize(trace: list[TraceRequest], vocab: int, seed: int = 0
                ) -> list[tuple[TraceRequest, np.ndarray]]:
    """Attach a seeded int32 prompt token array to every trace request
    (kept separate from generation so traces stay cheap to describe and
    compare).  Requests with ``prefix_len > 0`` share one system-prompt
    array (drawn once per call from the seed): identical head content
    is what makes the paged pool's token-hash prefix lookup hit."""
    rng = np.random.RandomState(seed ^ 0x5EED)
    max_pre = max((tr.prefix_len for tr in trace), default=0)
    shared = np.random.RandomState(seed ^ 0x5AFE).randint(
        0, vocab, size=max_pre).astype(np.int32) if max_pre else None
    out = []
    for tr in trace:
        if tr.motif_len:
            # Templated prompt: a per-request seeded motif tiled to the
            # prompt length (same (trace, seed) → same tokens contract).
            motif = rng.randint(0, vocab, size=tr.motif_len)
            reps = -(-tr.prompt_len // tr.motif_len)
            toks = np.tile(motif, reps)[:tr.prompt_len].astype(np.int32)
            out.append((tr, toks))
            continue
        toks = rng.randint(0, vocab, size=tr.prompt_len - tr.prefix_len
                           ).astype(np.int32)
        if tr.prefix_len:
            toks = np.concatenate([shared[:tr.prefix_len], toks])
        out.append((tr, toks))
    return out


def trace_summary(trace: list[TraceRequest]) -> dict:
    """Shape-of-the-load numbers for reports (duration, rates, length
    percentiles), reported beside the results."""
    arr = np.asarray([t.arrival_s for t in trace])
    plens = np.asarray([t.prompt_len for t in trace])
    news = np.asarray([t.new_tokens for t in trace])
    dur = float(arr[-1]) if len(arr) else 0.0
    pre = np.asarray([t.prefix_len for t in trace])
    extra = {}
    if pre.any():
        extra = {"shared_prefix_requests": int((pre > 0).sum()),
                 "shared_prefix_tokens": int(pre.sum())}
    mot = np.asarray([t.motif_len for t in trace])
    if mot.any():
        extra |= {"templated_requests": int((mot > 0).sum())}
    return extra | {
        "requests": len(trace),
        "duration_s": round(dur, 3),
        "mean_rate_rps": round(len(trace) / dur, 2) if dur else 0.0,
        "prompt_p50": int(np.percentile(plens, 50)),
        "prompt_p99": int(np.percentile(plens, 99)),
        "new_tokens_p50": int(np.percentile(news, 50)),
        "new_tokens_p99": int(np.percentile(news, 99)),
        "total_tokens": int(plens.sum() + news.sum()),
    }
