"""Serve layer of the port: slot and paged pools, fused and speculative
decode loops (one CUDA graph replay per step on the card), scheduler,
lock-step engine, async front end and load generators."""
from .decode_loop import (DEFAULT_MAX_DEPTH, DEFAULT_SPEC_HISTORY,
                          SPEC_DEPTH_CANDIDATES, draft_from_history,
                          make_fused_decode_step, make_lane_step,
                          make_paged_decode_step, make_paged_spec_decode_step,
                          make_spec_decode_step, masked_merge)
from .engine import (ServeEngine, make_decode_step, make_prefill_step,
                     prefill_segments)
from .graphs import DecodeGraphs
from .frontend import QueueFullError, RequestRecord, ServeFrontend, TokenStream
from .kv_cache import (CacheLayoutError, PagedKVCachePool,
                       PagePoolExhaustedError, SlotKVCachePool,
                       SlotOverflowError)
from .loadgen import (GENERATORS, SLOModel, TraceRequest, bursty_trace,
                      heavy_tailed_trace, materialize, poisson_trace,
                      shared_prefix_trace, templated_trace, trace_summary)
from .scheduler import (TERMINAL_STATES, PromptTooLongError, Request,
                        RequestState, ServeScheduler, TickRecord,
                        percentile)

__all__ = [
    "DEFAULT_MAX_DEPTH", "DEFAULT_SPEC_HISTORY", "SPEC_DEPTH_CANDIDATES",
    "draft_from_history", "make_fused_decode_step", "make_lane_step",
    "make_paged_decode_step", "make_paged_spec_decode_step",
    "make_spec_decode_step", "masked_merge", "DecodeGraphs",
    "ServeEngine", "make_decode_step", "make_prefill_step",
    "prefill_segments",
    "QueueFullError", "RequestRecord", "ServeFrontend", "TokenStream",
    "CacheLayoutError", "PagedKVCachePool", "PagePoolExhaustedError",
    "SlotKVCachePool", "SlotOverflowError",
    "SLOModel", "TraceRequest", "GENERATORS", "bursty_trace", "heavy_tailed_trace",
    "materialize", "poisson_trace", "shared_prefix_trace",
    "templated_trace", "trace_summary",
    "TERMINAL_STATES", "PromptTooLongError", "Request", "RequestState",
    "ServeScheduler", "TickRecord", "percentile",
]
