"""Device queue: the 95th percentile over the rounds dispatched in the
measured window of milliseconds from the end of the round's window
dispatch on the host to its graph's start mark on the card (the time the
round waits behind the one in flight), on the host's clock."""

from benchmark.harness.records import live_rounds, region
from benchmark.harness.stats import percentile


def read(run):
    rounds = live_rounds(run)
    if rounds is None:
        return None
    return percentile([(region(w, "window")[0] - w["dispatch"][1]) / 1e6
                       for w in (r["windows"][0] for r in rounds)], 95)
