"""setup_s: seconds from the start of the process to the first timed call:
imports, the card, kernel libraries (built in the checkout's first run),
weights from the seed, the loader, and the warm-up (host clock)."""


def read(ctx):
    return ctx.stats["setup_s"]
