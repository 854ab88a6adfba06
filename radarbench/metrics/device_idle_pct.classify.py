"""Share of the traced slice of /classify requests in which no kernel,
copy or fill ran on the card, in percent."""


def read(ctx):
    if ctx["window_s"] <= 0 or ctx["busy_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - ctx["busy_s"] / ctx["window_s"])
