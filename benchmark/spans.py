"""What the per-layer metrics of source `program_span` read from the
program: the requests that foundationpose_torch's recorder
(foundationpose_torch/utils/profiling.py) kept for the traced stretch (a
`--trace 1` run's profiler turns it on), and the captured-step counters of
the driver's estimator. Where the program has no recorder or counter, or
the stretch left no request of the cell's kind, a metric reads None."""
from __future__ import annotations


def traced_requests(ctx, kind: str):
    """The traced stretch's requests of `kind` (the last `served` the
    recorder kept), or None."""
    if ctx.kind != kind or ctx.traced is None or not ctx.traced.served:
        return None
    from foundationpose_torch.utils import profiling

    read = getattr(profiling, "requests", None)
    return (read(kind, last=ctx.traced.served) or None) if read else None


def device_ms(ctx, kind: str, *stages):
    """The summed device time of these stages, a request, over the
    requests whose device stages were read (a replay's read is dropped
    when its graph is replayed again first)."""
    reqs = [r for r in traced_requests(ctx, kind) or () if r.has_device_spans()]
    return sum(r.seconds(*stages) for r in reqs) / len(reqs) * 1e3 if reqs else None


def host_ms(ctx, kind: str, wait: str):
    """The host's time in the request's spans less its blocking fetches
    (`wait` spans), a request."""
    reqs = traced_requests(ctx, kind)
    return sum(r.host_seconds() - r.seconds(wait) for r in reqs) / len(reqs) * 1e3 if reqs else None


def self_ms(ctx, kind: str, *names):
    """The summed self time of these host spans, a request."""
    reqs = traced_requests(ctx, kind)
    return sum(r.self_seconds(*names) for r in reqs) / len(reqs) * 1e3 if reqs else None


def share_holding(ctx, kind: str, name: str):
    """The share of the requests that hold a span `name`, in %."""
    reqs = traced_requests(ctx, kind)
    return sum(bool(r.named(name)) for r in reqs) / len(reqs) * 100.0 if reqs else None


def capture_s(ctx, kind: str):
    """The seconds the driver's estimator spent capturing its steps
    (StepGraphs.capture_s, set-up's captures)."""
    if ctx.kind != kind:
        return None
    graphs = getattr(getattr(ctx.driver, "est", None), "_graphs", None)
    return getattr(graphs, "capture_s", None)
