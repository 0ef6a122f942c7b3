"""Scheduler wait from the source: the 95th percentile of milliseconds
from a row's ``due_src`` (when the stream's packer completed the chunk
holding the first sample no window decoded before) to the start of the
dispatch of the round that took it, over the rows of the rounds
dispatched in the measured window (the scheduler's round records)."""

from benchmark.harness.records import live_rounds
from benchmark.harness.stats import percentile


def read(run):
    rounds = live_rounds(run)
    if rounds is None:
        return None
    waits = [(r["dispatch"][0] - row["due_src"]) / 1e6 for r in rounds for row in r["rows"]
             if row["due_src"] is not None]
    return percentile(waits, 95) if waits else None
