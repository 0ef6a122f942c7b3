"""Token loop in the served window graph: microseconds per decode step,
the summed spans of the measured windows' token loops (between their
start and end marks in the graph) over the summed passes of their WHILE
nodes, each a step, as the device counted them."""

from benchmark.harness.records import batch_windows


def read(run):
    ws = batch_windows(run)
    if ws is None:
        return None
    loops = sum(b - a for w in ws for name, a, b in w["regions"] if name == "token_loop")
    steps = sum(sum(w["passes"]) for w in ws)
    return loops / steps / 1e3 if steps else None
