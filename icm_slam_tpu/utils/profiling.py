"""Profiling helpers: jax.profiler traces + lightweight phase timers.

The reference's tracing was commented-out time.time() deltas
(ICM_SLAM_old.py:311,323-324); here traces are first-class (SURVEY.md §5).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture an XLA profiler trace viewable in TensorBoard/Perfetto."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class PhaseTimer:
    """Accumulating wall-clock phase timers (blocks on device results)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        import jax
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            jax.block_until_ready(block_on)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, dict]:
        return {k: {"total_s": round(v, 4),
                    "mean_ms": round(v / max(self.counts[k], 1) * 1e3, 3),
                    "count": self.counts[k]}
                for k, v in sorted(self.totals.items())}
