"""Scheduler blocked on the card: the share, in percent, of the measured
window's wall that the scheduler thread spent in its rounds' fetch spans
(waiting for a round's window to finish), the spans clipped to the
window."""

from benchmark.harness.records import live_rounds, snapshot, window_ns


def read(run):
    snap = snapshot()
    if live_rounds(run, snap) is None:
        return None
    t0, t1 = window_ns(run)
    blocked = sum(max(0, min(r["fetch"][1], t1) - max(r["fetch"][0], t0))
                  for r in snap["rounds"] if r.get("fetch") is not None)
    return 100.0 * blocked / (t1 - t0)
