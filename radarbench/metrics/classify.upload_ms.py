"""Host-to-device copy time a batched forward in the traced slice (the
images' upload), in ms, from the device trace."""

from radarbench import trace


def read(ctx):
    seconds = trace.copy_seconds(ctx["events"], "HtoD")
    if seconds <= 0 or not ctx.get("batches"):
        return None
    return 1e3 * seconds / ctx["batches"]
