"""The chained-median timing protocol, shared by every harness.

Every timed call consumes the previous call's output, so the timed work is
the state evolving as it does in a real run, and each call waits for the
device (``block_until_ready``).  The reported time is the MEDIAN of the
reps, which keeps one slow host hiccup out of the number.

Used by benchmarks/headline.py (single + fleet rows), fleet_curve.py,
modes_bench.py and roofline.py so the protocol cannot drift apart between
harnesses.
"""
import time


def timed_chained_median_s(step, m0, x0, reps):
    """Median seconds per ``step`` call over ``reps`` chained calls.

    ``step(m, x) -> (m, x)``: one timed unit (typically a fused N-sweep
    refine loop) — must be already compiled/warmed by the caller.
    Returns ``(median_s, m, x)`` with the final chained state.
    """
    import jax

    m, x = m0, x0
    ts = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        m, x = step(m, x)
        jax.block_until_ready(x)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2], m, x
