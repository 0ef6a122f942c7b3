"""Scheduler wait: the 95th percentile of milliseconds from a
stream-window's due time to the dispatch of the round that took it, over
the measured window (the benchmark's wrapper around the scheduler's round
dispatch)."""

from benchmark.harness.stats import percentile


def read(run):
    w = run.data.get("wait_ms")
    return percentile(w, 95) if w else None
