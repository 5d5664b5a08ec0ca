"""Utilities: tracing, profiling, capture statistics, compile cache."""

from .compile_cache import enable_compile_cache
from .trace import CaptureStats, StageTimer, get_logger, profile_trace

__all__ = [
    "CaptureStats", "StageTimer", "enable_compile_cache", "get_logger",
    "profile_trace",
]
