"""Images a batched forward: the growth of the batcher's counters
``batched_images`` over ``batches`` across the traced slice, read from
the service's ``GET /healthz`` (``classify_batching``) before and after
it."""


def read(ctx):
    if not ctx.get("batches"):
        return None
    return ctx["batched_images"] / ctx["batches"]
