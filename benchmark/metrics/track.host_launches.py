"""track.host_launches (launches/frame): the host's kernel, graph, copy and memset
launch calls (CUDA runtime calls in the trace, benchmark/trace.py) per
frame of the traced stretch. Moves track_ms."""


def read(ctx):
    if ctx.kind != "track":
        return None
    return ctx.summary.launches / ctx.traced.served
