"""register.host_launches (launches/register): the host's kernel, graph, copy and memset
launch calls (CUDA runtime calls in the trace, benchmark/trace.py) per
register of the traced stretch. Moves register_ms."""


def read(ctx):
    if ctx.kind != "register":
        return None
    return ctx.summary.launches / ctx.traced.served
