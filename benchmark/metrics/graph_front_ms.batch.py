"""Window front (mel, encoder, cross-K/V, prefill) in the served window
graph: mean milliseconds from each measured window's start mark to its
front's end mark, both written by the graph itself (the program's window
records, ``norma_tpu_torch.tracing``)."""

from benchmark.harness.records import batch_windows, region


def read(run):
    ws = batch_windows(run)
    if ws is None:
        return None
    return sum(region(w, "window_front")[1] - region(w, "window")[0] for w in ws) / len(ws) / 1e6
