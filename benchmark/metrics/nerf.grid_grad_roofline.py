"""nerf.grid_grad_roofline (%): the table gradient's least time a step over
its device time. The least bytes are the algorithm's (benchmark/nerf_work.py:
each point encoded read with its cotangent, the table's gradient written
once) at 3.35 TB/s, the points from the recorder's counter nerf.points over
the traced stretch. The device time is the step's stage nerf.grid_backward
(benchmark/spans.py): the device's wall from the table gradient's first
kernel to its last, which holds K4, the fold of its rolled rows and the
corner rows and weights computed again from the points; kernel names cannot
tell the fold's adds from the step's other adds. Moves train_step_ms."""

from benchmark import nerf_work, spans
from benchmark.peaks import bound


def read(ctx):
    spent_ms = spans.device_ms(ctx, "nerf", "nerf.grid_backward")
    if not spent_ms:
        return None
    from foundationpose_torch.utils import profiling

    points = (profiling.counters().get("nerf.points", 0) - ctx.driver.points_before) / ctx.traced.served
    if points <= 0:
        return None
    return bound(nerf_work.grid_grad_bytes(ctx.cfg, points), 0, "f32")[0] * 1e3 / spent_ms * 100.0
