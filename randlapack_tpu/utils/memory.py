"""Memory tracking (reference: RandLAPACK/testing/rl_memory_tracker.hh —
``get_rss_kb`` /proc reader :20, ``PeakRSSTracker`` 100 μs background
sampler :41-77, analytical peak-memory formulas per algorithm :87-129).

Additions: device memory statistics via the PJRT ``memory_stats`` API,
which replaces host-RSS as the number that matters for device-resident
algorithms.
"""
from __future__ import annotations

import threading
import time


def get_rss_kb() -> int:
    """Current host RSS in kB (reads /proc/self/status, like the ref)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1


def device_memory_stats(device=None) -> dict:
    """Device memory statistics (bytes). Keys vary by backend; common ones:
    ``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``. Empty dict if
    the backend doesn't expose stats."""
    import jax
    dev = device or jax.devices()[0]
    try:
        return dict(dev.memory_stats() or {})
    except Exception:
        return {}


class PeakRSSTracker:
    """Background-thread peak host-RSS sampler (reference :41-77)."""

    def __init__(self, interval_s: float = 0.005):
        self.interval = interval_s
        self.peak_kb = -1
        self._stop = threading.Event()
        self._thread = None

    def __enter__(self):
        self._stop.clear()
        self.peak_kb = get_rss_kb()

        def loop():
            while not self._stop.is_set():
                self.peak_kb = max(self.peak_kb, get_rss_kb())
                time.sleep(self.interval)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=1.0)
        self.peak_kb = max(self.peak_kb, get_rss_kb())
        return False


def analytical_peak_bytes(algorithm: str, m: int, n: int,
                          block: int | None = None, dtype_bytes: int = 4,
                          d_factor: float = 1.25) -> int:
    """Analytical peak device-memory models per algorithm (reference
    :87-129 ports, adapted to this framework's drivers' buffers)."""
    b = block or 256
    K = min(m, n)
    if algorithm == "cholqr_linops":
        # operator block (m·b) + Gram (n²) + R (n²)
        return dtype_bytes * (m * b + 2 * n * n)
    if algorithm == "scholqr3_linops":
        return dtype_bytes * (m * b + 3 * n * n)
    if algorithm == "cqrrt":
        d = int(d_factor * n)
        return dtype_bytes * (m * n + d * n + 2 * n * n + m * n)
    if algorithm == "cqrrpt":
        d = int(d_factor * n)
        return dtype_bytes * (2 * m * n + d * n + 2 * n * n)
    if algorithm == "bqrrp":
        d = int(d_factor * b)
        return dtype_bytes * (2 * m * n + m * K + K * n + d * n)
    if algorithm == "rsvd":
        return dtype_bytes * (2 * m * n + 2 * m * b + b * n)
    if algorithm == "abrik":
        return dtype_bytes * (m * n + (m + n) * K + K * K)
    raise ValueError(f"no model for {algorithm}")
