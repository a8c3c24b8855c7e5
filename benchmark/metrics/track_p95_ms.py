"""track_p95_ms (ms): the 95th percentile of every request's latency in the
window, on the host clock: for track_one, from the call with the host frame
to the pose on the host (statistics.quantiles, n = 20)."""

import statistics


def read(ctx):
    lat = ctx.untraced.latencies
    return statistics.quantiles(lat if len(lat) > 1 else lat * 2, n=20)[-1] * 1e3
