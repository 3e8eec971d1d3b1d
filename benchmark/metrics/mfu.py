"""mfu: the model's operations in the traced stretch (``flops/``, from the
configuration's widths and the requests' true lengths; a training step
three forwards) over the stretch's host-clock time and the card's peak
(``lib/peaks.json``)."""


def read(ctx):
    units = ctx.profiled
    if not units or not ctx.stretch_s or ctx.trace is None or not ctx.trace.busy_s:
        return None
    return 100.0 * sum(u["flops"] for u in units) / (ctx.stretch_s * ctx.peaks["flops_per_s"])
