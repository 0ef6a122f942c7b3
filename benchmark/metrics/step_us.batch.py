"""Token loop: device-busy microseconds per decode step, from the traced
eager window's first sampling kernel to its last device event, over the steps
the engine counted."""

from benchmark.harness.split import window_split


def read(run):
    s = window_split(run)
    return None if s is None or not s["steps"] else s["loop_us"] / s["steps"]
