"""A round's window on the card: mean milliseconds from its graph's start
mark to its end mark, over the rounds dispatched in the measured window."""

from benchmark.harness.records import live_rounds, region


def read(run):
    rounds = live_rounds(run)
    if rounds is None:
        return None
    spans = [region(r["windows"][0], "window") for r in rounds]
    return sum(b - a for a, b in spans) / len(spans) / 1e6
