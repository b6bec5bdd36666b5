"""Serve layer of the port: slot and paged pools, fused and speculative
decode loops, scheduler, async front end and load generators."""
from .decode_loop import (DEFAULT_MAX_DEPTH, DEFAULT_SPEC_HISTORY,
                          SPEC_DEPTH_CANDIDATES, draft_from_history,
                          make_fused_decode_step, make_lane_step,
                          make_paged_decode_step, make_paged_spec_decode_step,
                          make_spec_decode_step)
from .engine import ServeEngine, prefill_segments
from .frontend import QueueFullError, RequestRecord, ServeFrontend, TokenStream
from .kv_cache import (CacheLayoutError, PagedKVCachePool,
                       PagePoolExhaustedError, SlotKVCachePool,
                       SlotOverflowError)
from .loadgen import (SLOModel, TraceRequest, bursty_trace,
                      heavy_tailed_trace, materialize, poisson_trace,
                      shared_prefix_trace, templated_trace, trace_summary)
from .scheduler import (TERMINAL_STATES, PromptTooLongError, Request,
                        RequestState, ServeScheduler, TickRecord,
                        percentile)

__all__ = [
    "DEFAULT_MAX_DEPTH", "DEFAULT_SPEC_HISTORY", "SPEC_DEPTH_CANDIDATES",
    "draft_from_history", "make_fused_decode_step", "make_lane_step",
    "make_paged_decode_step", "make_paged_spec_decode_step",
    "make_spec_decode_step",
    "ServeEngine", "prefill_segments",
    "QueueFullError", "RequestRecord", "ServeFrontend", "TokenStream",
    "CacheLayoutError", "PagedKVCachePool", "PagePoolExhaustedError",
    "SlotKVCachePool", "SlotOverflowError",
    "SLOModel", "TraceRequest", "bursty_trace", "heavy_tailed_trace",
    "materialize", "poisson_trace", "shared_prefix_trace",
    "templated_trace", "trace_summary",
    "TERMINAL_STATES", "PromptTooLongError", "Request", "RequestState",
    "ServeScheduler", "TickRecord", "percentile",
]
