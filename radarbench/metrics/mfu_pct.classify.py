"""The whole step's share of the card's bf16 peak: the operations of the
images answered in the traced slice (radarbench/roofline.py::vgg16_work
of the slice, padded rows not counted) over the slice's seconds times
the peak, in percent; None where no operation ran on a device."""

from radarbench import roofline


def read(ctx):
    work = ctx["work"]
    if ctx["window_s"] <= 0 or ctx["busy_s"] <= 0 or work["flops"] <= 0:
        return None
    return 100.0 * work["flops"] / (ctx["window_s"] * roofline.PEAKS[work["flop_peak"]])
