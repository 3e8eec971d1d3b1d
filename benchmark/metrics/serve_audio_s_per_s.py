"""serve_audio_s_per_s: true mixture seconds whose estimates reached the host
in the window, over the window (host clock, from the window's start to the
last batch's estimates on the host)."""


def read(ctx):
    if ctx.traffic["loop"] != "serve" or not ctx.traffic.get("bucketed"):
        return None
    return ctx.stats["audio_s"] / ctx.stats["window_s"]
