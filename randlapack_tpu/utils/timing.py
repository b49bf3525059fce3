"""Phase timing + profiling (reference: per-driver fixed-slot μs timing
vectors, e.g. BQRRP's 10 slots rl_bqrrp.hh:584-607, CQRRPT's 8
rl_cqrrpt.hh:383 — SURVEY.md §5.1 maps these to returned metrics dicts and
jax.profiler traces).

Under jit the phases of one fused graph can't be separately timed from the
host, so phase timing here is measured by running the driver's stages as
separate synced executions (``PhaseTimer``) — the benchmark CLIs use this —
while production runs use a single fused graph and ``profile_trace`` for
XLA-level breakdowns.
"""
from __future__ import annotations

import contextlib
import time

import jax


def device_sync(out):
    """Wait until every array in ``out`` is computed on the device and
    return ``out`` — the barrier around every phase timing."""
    return jax.block_until_ready(out)


class PhaseTimer:
    """Accumulates named phase durations — the metrics-dict replacement for
    the reference's fixed-slot timing vectors.

    Usage::

        t = PhaseTimer()
        with t.phase("sketch"):
            out = sketch_fn(...); device_sync(out)
        t.report()  # {'sketch': seconds, ...}
    """

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.times[name] = self.times.get(name, 0.0) + (
            time.perf_counter() - t0)

    def report(self, out=None):
        total = sum(self.times.values())
        if out is not None:
            print(f"{'phase':<24}{'seconds':>12}{'pct':>8}", file=out)
            for k, v in sorted(self.times.items(), key=lambda kv: -kv[1]):
                print(f"{k:<24}{v:>12.4f}{100*v/max(total,1e-12):>7.1f}%",
                      file=out)
        return dict(self.times)


@contextlib.contextmanager
def debug_checks():
    """Enable jax NaN debugging for the scope — the framework's analogue
    of the reference's AddressSanitizer CI lanes (SURVEY.md §5.2): traced
    code fails fast at the op that produced a NaN instead of propagating
    it into the breakdown-flag logic. Use in tests/debugging only (it
    disables async dispatch)."""
    import jax
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """jax.profiler trace wrapper (XLA/device-level breakdown — the
    replacement for the reference's NVTX annotations)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def format_phase_breakdown(times: dict, title: str = "") -> str:
    """Pretty-print a phase-metrics dict as the reference's percentage
    breakdown block (rl_bqrrp.hh:586-607 prints each subroutine's μs and
    share of the total) — returns the formatted string; feed it any
    driver's ``timing=True`` dict::

        fac, st, t = bqrrp_factored(A, cfg, st, timing=True)
        print(format_phase_breakdown(t, "BQRRP"))
    """
    total = sum(times.values())
    head = f"/// {title + ' ' if title else ''}phase breakdown ///"
    lines = [head]
    for k, v in sorted(times.items(), key=lambda kv: -kv[1]):
        lines.append(f"{k:<24}{v * 1e6:>14.0f} us"
                     f"{100.0 * v / max(total, 1e-12):>7.1f}%")
    lines.append(f"{'total':<24}{total * 1e6:>14.0f} us{100.0:>7.1f}%")
    return "\n".join(lines)
