"""The least time of the work the answered images need
(radarbench/roofline.py::vgg16_work of the traced slice: their
operations against the bf16 peak, or their bytes and the weights' once a
batch) over the device's kernel time in the slice, in percent."""

from radarbench import roofline, trace


def read(ctx):
    k = trace.kernel_seconds(ctx["events"])
    work = ctx["work"]
    if k <= 0 or work["flops"] <= 0:
        return None
    least, _ = roofline.least_seconds(work["bytes"], work["flops"], work["flop_peak"])
    return 100.0 * least / k
