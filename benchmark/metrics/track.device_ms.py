"""track.device_ms (ms): the device's busy time (union of CUPTI activity)
per tracked frame of the traced stretch. Moves track_ms."""


def read(ctx):
    if ctx.kind != "track":
        return None
    return ctx.summary.busy_s / ctx.traced.served * 1e3
