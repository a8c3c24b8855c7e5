"""The device's side of a traced stretch, from a torch.profiler chrome trace
(CUDA activity only: CUPTI records every kernel, copy and memset, each
node of a replayed CUDA graph too, and the host's CUDA runtime calls).

`summarize` gives the union of the device's activity (busy time), the
summed time of each kernel name, the host's launch calls, and the idle
gaps between device activities, each named by the runtime call that
overlapped it most (or "host" when the host made no CUDA call then).
"""
from __future__ import annotations

import dataclasses
import json

# CUDA API calls by which the host puts work on the card.
HOST_LAUNCH_CALLS = ("LaunchKernel", "GraphLaunch", "MemcpyAsync", "MemsetAsync", "LaunchCooperative")
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


@dataclasses.dataclass
class Summary:
    busy_s: float
    activities: int
    launches: int
    kernels: dict  # kernel name -> summed seconds
    gaps: list  # [(label, seconds)], longest first

    def kernel_s(self, match) -> float:
        """Summed seconds of the kernels whose name `match(name)` accepts."""
        return sum(s for k, s in self.kernels.items() if match(k))


def summarize(events: list) -> Summary:
    acts = sorted((e["ts"], e["ts"] + e["dur"], e) for e in events
                  if e.get("cat") in DEVICE_CATS and "dur" in e)
    calls = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                   if e.get("cat", "").startswith("cuda_") and "ts" in e)
    launches = sum(1 for c in calls if any(k in c[2] for k in HOST_LAUNCH_CALLS))
    busy, end, gaps = 0.0, None, []
    for a, b, _ in acts:
        if end is not None and a > end:
            gaps.append((end, a))
        busy += max(0.0, b - (a if end is None else max(a, end)))
        end = b if end is None else max(end, b)
    kernels = {}
    for _, _, e in acts:
        if e["cat"] == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + e["dur"] * 1e-6
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        over = [(min(b, ce) - max(a, cs), name) for cs, ce, name in calls if cs < b and ce > a]
        labelled.append((max(over)[1] if over else "host", (b - a) * 1e-6))
    return Summary(busy * 1e-6, len(acts), launches, kernels, labelled)


def load(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def traced(fn, path: str, device):
    """Run fn() under a torch.profiler trace of `device`'s activity (CUDA
    only on the card), export it to `path` and return (fn's result, the
    trace's events)."""
    from torch.profiler import ProfilerActivity, profile

    act = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
    with profile(activities=[act]) as prof:
        out = fn()
    prof.export_chrome_trace(path)
    return out, load(path)
