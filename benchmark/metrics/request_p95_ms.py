"""request_p95_ms: the 95th percentile (nearest rank) of the window's request
latencies, each from taking the request (its collate) to its estimate on
the host (host clock)."""

import math


def read(ctx):
    lat = sorted(ctx.stats.get("latencies_s") or [])
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
