"""Share of the fill (int32, int16 and fill_block) kernels' roofline: the least time of the work
counted at their entries (the larger of bytes over 3.35 TB/s and
operations over the derived 16.75e12 int32 operations a second) over
their summed device time in the trace, in percent."""

from benchmark import arith
from benchmark.trace import FILL_KERNELS, kernel_time


def read(ctx):
    if "trace" not in ctx:
        return None
    t = kernel_time(ctx["trace"]["kernel_s"], FILL_KERNELS)
    w = ctx["work"]
    if t <= 0 or not w["fill_ops"]:
        return None
    return 100.0 * arith.least_s(w["fill_bytes"], w["fill_ops"]) / t
