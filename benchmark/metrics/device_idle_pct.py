"""device_idle_pct: the share of the traced stretch in which no kernel, copy
or memset ran on the card (1 minus the union of their intervals)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.busy_s or not ctx.stretch_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.stretch_s)
