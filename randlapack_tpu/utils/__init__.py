"""Auxiliary subsystems: phase timing, profiling, memory tracking, the
compile cache's location."""
from .compile_cache import compile_cache_dir, enable_compile_cache
from .timing import (PhaseTimer, debug_checks, device_sync,
                     format_phase_breakdown, profile_trace)
from .memory import (PeakRSSTracker, analytical_peak_bytes,
                     device_memory_stats)

__all__ = ["PhaseTimer", "debug_checks", "device_sync", "profile_trace",
           "PeakRSSTracker", "analytical_peak_bytes",
           "device_memory_stats", "compile_cache_dir",
           "enable_compile_cache"]
