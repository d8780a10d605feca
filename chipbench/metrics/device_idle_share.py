"""Device: the share of the traced step in which no operation ran on the
device (one minus the union of the device intervals over the window)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
