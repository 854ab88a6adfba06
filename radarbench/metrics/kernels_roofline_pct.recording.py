"""The least time of the slice's required work (radarbench/roofline.py:
bytes read and written once, FFT counts) over the device's kernel time in
the traced slice, in percent."""

from radarbench import roofline, trace


def read(ctx):
    k = trace.kernel_seconds(ctx["events"])
    if k <= 0:
        return None
    least, _ = roofline.least_seconds(ctx["work"]["bytes"], ctx["work"]["flops"])
    return 100.0 * least * ctx["items"] / k
