"""What the `score_train.*` stage metrics read: the traced stretch's train
steps of a train-scorer cell from foundationpose_torch's recorder. The
recorder's requests are of kind "train" (models/training.py::_step), the
cell's traffic of kind `score_train`, so benchmark/spans.py's match of the
two finds nothing here. Where the program records no such stage (before
the scorer's step had stages of its own) a metric reads None."""
from __future__ import annotations


def device_ms(ctx, *stages):
    """The summed device time of these stages, a step, over the traced
    steps that recorded them."""
    if ctx.kind != "score_train" or ctx.traced is None or not ctx.traced.served:
        return None
    from foundationpose_torch.utils import profiling

    read = getattr(profiling, "requests", None)
    reqs = [r for r in (read("train", last=ctx.traced.served) if read else ())
            if r.has_device_spans() and r.named(*stages)]
    return sum(r.seconds(*stages) for r in reqs) / len(reqs) * 1e3 if reqs else None
