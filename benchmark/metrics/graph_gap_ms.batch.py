"""Window program: mean milliseconds the card spends between one measured
window graph's end mark and the next one's start mark (the result and
input copies between them, and any wait for the host's dispatch), 0 where
they overlap."""

from benchmark.harness.records import batch_windows, region


def read(run):
    ws = batch_windows(run)
    if ws is None or len(ws) < 2:
        return None
    gaps = [max(0, region(b, "window")[0] - region(a, "window")[1]) for a, b in zip(ws, ws[1:])]
    return sum(gaps) / len(gaps) / 1e6
