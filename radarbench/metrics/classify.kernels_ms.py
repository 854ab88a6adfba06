"""Kernel time a batched forward in the traced slice, in ms, from the
device trace: the convolutions, pools, Dense layers and casts of one
bucket."""

from radarbench import trace


def read(ctx):
    seconds = trace.kernel_seconds(ctx["events"])
    if seconds <= 0 or not ctx.get("batches"):
        return None
    return 1e3 * seconds / ctx["batches"]
