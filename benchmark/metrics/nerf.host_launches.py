"""nerf.host_launches (launches/step): the host's kernel, graph, copy and
memset launch calls (CUDA runtime calls in the trace, benchmark/trace.py) per
neural-object-field step of the traced stretch. Moves train_step_ms."""


def read(ctx):
    if ctx.kind != "nerf":
        return None
    return ctx.summary.launches / ctx.traced.served
