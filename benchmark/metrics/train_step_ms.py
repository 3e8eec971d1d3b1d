"""train_step_ms: the window over the optimizer steps completed in it; the
window ends when the trainer has read its loss back (host clock)."""


def read(ctx):
    steps = ctx.stats.get("steps")
    return 1e3 * ctx.stats["window_s"] / steps if steps else None
