"""padding_pct: padded mixture samples over all mixture samples of the
batches served in the window (a count over the loader's batches)."""


def read(ctx):
    records = ctx.stats.get("records") or []
    total = sum(r.get("samples", 0) for r in records)
    return 100.0 * sum(r.get("padded", 0) for r in records) / total if total else None
