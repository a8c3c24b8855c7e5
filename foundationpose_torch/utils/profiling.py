"""Tracing and profiling helpers (the reference has none).

Port of foundationpose_tpu/utils/profiling.py:

* `stage_timer`: named wall-clock stages, synchronised with the card,
  and `timing_report`;
* `trace`: a `torch.profiler` trace of the block (CPU and, with a card,
  CUDA activity), written as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_STAGES: dict[str, list[float]] = defaultdict(list)


@contextlib.contextmanager
def stage_timer(name: str, sync: bool = True):
    """Add the wall time of the block to stage `name`. With sync=True the
    current CUDA device is synchronised before the clock stops (when a
    card is present), so the time covers the work the block enqueued.
    An exception in the block is raised as it is; no time is recorded
    for it."""
    t0 = time.perf_counter()
    yield
    if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    _STAGES[name].append(time.perf_counter() - t0)


def timing_report(reset: bool = False) -> dict[str, dict[str, float]]:
    """{stage: {"count", "total_s", "mean_ms"}}; `reset` clears the stages."""
    out = {}
    for name, ts in _STAGES.items():
        out[name] = {
            "count": len(ts),
            "total_s": sum(ts),
            "mean_ms": 1000.0 * sum(ts) / max(len(ts), 1),
        }
    if reset:
        _STAGES.clear()
    return out


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace"):
    """Profile the block with torch.profiler and write
    `<log_dir>/<name>.json` (a Chrome trace: chrome://tracing or Perfetto).
    Records CPU operators and, when a card is present, its kernels. The
    profiler object is yielded (for `key_averages()`)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))
