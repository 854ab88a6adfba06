"""The least time of the spectrogram export's required work
(radarbench/roofline.py, the "export" share of ``work``: the maps written
once, the FFT count) over the device time of the tiled export's kernels,
K4a ``psd_tiled_kernel`` and K4b ``db_rescale_tiled_kernel``, in the
traced slice, in percent; None where neither ran."""

from radarbench import roofline

KERNELS = ("psd_tiled_kernel", "db_rescale_tiled_kernel")


def read(ctx):
    k = sum(d["dur"] for d in ctx["events"]
            if d["cat"] == "kernel" and any(n in d["name"] for n in KERNELS)) / 1e6
    if k <= 0:
        return None
    export = ctx["work"]["export"]
    least, _ = roofline.least_seconds(export["bytes"], export["flops"])
    return 100.0 * least * ctx["items"] / k
