"""Serve layer of the port: slot pool, fused decode loop, scheduler."""
from .decode_loop import (DEFAULT_MAX_DEPTH, make_fused_decode_step,
                          make_lane_step)
from .engine import ServeEngine, prefill_segments
from .kv_cache import CacheLayoutError, SlotKVCachePool, SlotOverflowError
from .scheduler import (TERMINAL_STATES, PromptTooLongError, Request,
                        RequestState, ServeScheduler, TickRecord,
                        percentile)

__all__ = [
    "DEFAULT_MAX_DEPTH", "make_fused_decode_step", "make_lane_step",
    "ServeEngine", "prefill_segments",
    "CacheLayoutError", "SlotKVCachePool", "SlotOverflowError",
    "TERMINAL_STATES", "PromptTooLongError", "Request", "RequestState",
    "ServeScheduler", "TickRecord", "percentile",
]
