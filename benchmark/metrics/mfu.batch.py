"""The whole window's share of the card's dense bf16 peak, in percent:
the model's FLOPs per window (``benchmark/yardstick/counts.py``, from the
published widths and the decode steps the engine counted) over the wall
time per window of the measured window times 989 TFLOP/s."""

from benchmark.yardstick.counts import model_flops
from benchmark.yardstick.peaks import H100


def read(run):
    d = run.data
    if "wall_ms" not in d:
        return None
    flops = model_flops(d["cfg"], d["rows"], round(d["steps"]))
    return 100.0 * flops / (d["wall_ms"] / 1e3 * H100["bf16_flops"])
