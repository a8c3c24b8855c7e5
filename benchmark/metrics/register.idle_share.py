"""register.idle_share (%): the share of the traced stretch's wall time in which
the device ran nothing: one less the union of CUPTI's kernels, copies and
memsets over the stretch. Tracing slows the host's launches, a replayed
CUDA graph's most, so a host-bound cell reads higher here than untraced.
Moves register_ms."""


def read(ctx):
    if ctx.kind != "register":
        return None
    return (1.0 - ctx.summary.busy_s / ctx.traced.seconds) * 100.0
