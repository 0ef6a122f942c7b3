"""Readings of a traced batch window shared by the per-layer metrics: one
eager window, the device alone traced (``harness/batch.py``)."""

from __future__ import annotations

from typing import List, Optional

from .trace import Trace

SAMPLE_KERNEL = "sample_step_kernel"


def window_split(run) -> Optional[dict]:
    """Device-busy microseconds of the traced window's front (its start to
    the first sampling kernel) and token loop (the first sampling kernel
    to its end), and its decode steps; None when the trace is short of the
    window's launches or holds no sampling kernel."""
    d = run.data
    tr: Trace = d.get("trace")
    if tr is None or not complete(run):
        return None
    a, b = tr.window
    first = tr.first_kernel(SAMPLE_KERNEL, a, b)
    if first is None:
        return None
    return dict(front_us=tr.busy_union_us(a, first), loop_us=tr.busy_union_us(first, b), steps=d["trace_steps"])


def near(n: int, want: int) -> bool:
    """``n`` events where the shapes make ``want`` launches, to a
    thousandth: a session that lost device events reads every time short."""
    return want > 0 and abs(n - want) <= max(4, want // 1000)


def complete(run) -> bool:
    """Whether the trace holds the window's w8 launches."""
    from ..yardstick.counts import w8_launches

    d = run.data
    want = len(w8_launches(d["cfg"], d["rows"], round(d["trace_steps"])))
    return near(d["trace"].kernel_time_us("w8_mma_kernel")[0], want)


def roofline(tr: Trace, kernel: str, bounds_s: List[float]) -> Optional[float]:
    """Percent of the bound that ``kernel``'s launches reached: the sum of
    their bounds over their summed device time.  ``bounds_s`` are the
    window's launches; None unless the trace holds about that many, the
    bound then taken over the events it holds."""
    n, us = tr.kernel_time_us(kernel)
    if not near(n, len(bounds_s)) or us <= 0:
        return None
    return 100.0 * sum(bounds_s) * (n / len(bounds_s)) / (us / 1e6)
