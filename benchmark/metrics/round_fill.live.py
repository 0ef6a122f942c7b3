"""Scheduler fill: active rows over dispatched rows (padding to the
power-of-two bucket included), in percent, over the rounds dispatched in
the measured window."""


def read(run):
    rounds = run.data.get("rounds")
    if not rounds:
        return None
    return 100.0 * sum(r["n_active"] for r in rounds) / sum(r["B"] for r in rounds)
