"""nerf.idle_share (%): the share of the traced stretch's wall time in which
the device ran nothing: one less the union of CUPTI's kernels, copies and
memsets over the stretch. Tracing slows the host's launches. Moves
train_step_ms."""


def read(ctx):
    if ctx.kind != "nerf":
        return None
    return (1.0 - ctx.summary.busy_s / ctx.traced.seconds) * 100.0
