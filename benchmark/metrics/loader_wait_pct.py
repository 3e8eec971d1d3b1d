"""loader_wait_pct: the share of the window the trainer's loop spent in the
loader's ``next()`` (host clock)."""


def read(ctx):
    wait = ctx.stats.get("loader_wait_s")
    return None if wait is None else 100.0 * wait / ctx.stats["window_s"]
