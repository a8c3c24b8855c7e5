"""train_step_ms (ms): the window's seconds on the host clock over the training steps completed, batch generation included
in it, closed loop; the window ends once the device has finished."""


def read(ctx):
    return ctx.untraced.seconds / ctx.untraced.served * 1e3
