"""Kernel launches per window in the device trace of the traced slice."""

from radarbench import trace


def read(ctx):
    n = trace.kernel_count(ctx["events"])
    return n / ctx["items"] if n else None
