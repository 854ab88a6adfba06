"""Median host time until ``process_window`` returns, without a sync: the
dispatch cost of a window (an untraced slice before the traced one)."""

import statistics


def read(ctx):
    ms = ctx["host"].get("enqueue_ms")
    return statistics.median(ms) if ms else None
