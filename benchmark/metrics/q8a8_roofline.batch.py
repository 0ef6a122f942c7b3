"""q8a8 kernel (``csrc/q8a8.cu``): the sum of its launches' bounds over
their summed device time in the traced eager window, in percent; each bound
the larger of its bytes over the card's bandwidth and its int8 operations
over the int8 peak (``benchmark/yardstick``)."""

from benchmark.harness.split import roofline
from benchmark.yardstick.counts import q8a8_bound_s, q8a8_launches


def read(run):
    d = run.data
    if "trace" not in d:
        return None
    bounds = [q8a8_bound_s(*s) for s in q8a8_launches(d["cfg"], d["rows"])]
    return roofline(d["trace"], "q8a8_wgmma_kernel", bounds)
