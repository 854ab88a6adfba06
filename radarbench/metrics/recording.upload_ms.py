"""Host-to-device copy time per recording in the traced slice (the device
trace's HtoD copies): the raw upload of ``_device_inputs``."""

from radarbench import trace


def read(ctx):
    s = trace.copy_seconds(ctx["events"], "HtoD")
    return 1e3 * s / ctx["items"] if s > 0 else None
