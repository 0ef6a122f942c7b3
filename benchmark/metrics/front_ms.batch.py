"""Window front (mel, encoder, cross-K/V, prefill): device-busy
milliseconds of the traced eager window from its first device event to
its first sampling kernel."""

from benchmark.harness.split import window_split


def read(run):
    s = window_split(run)
    return None if s is None else s["front_us"] / 1e3
