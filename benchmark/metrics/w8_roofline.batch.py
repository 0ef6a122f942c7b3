"""w8 kernel (``csrc/w8_matmul.cu``): the sum of its launches' bounds
over their summed device time in the traced eager window, in percent.  Each
launch's bound is the larger of its bytes over the card's bandwidth and
its operations over the bf16 peak (``benchmark/yardstick``).  Nothing is
read when the trace's w8 kernels are not the launches the window's
shapes make."""

from benchmark.harness.split import roofline
from benchmark.yardstick.counts import w8_bound_s, w8_launches


def read(run):
    d = run.data
    if "trace" not in d:
        return None
    shapes = w8_launches(d["cfg"], d["rows"], round(d["trace_steps"]))
    return roofline(d["trace"], "w8_mma_kernel", [w8_bound_s(*s) for s in shapes])
