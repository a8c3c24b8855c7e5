"""Tracing and profiling: the port's one span-and-counter recorder (the
reference has none).

Port of foundationpose_tpu/utils/profiling.py (`stage_timer`,
`timing_report`, `trace`), grown into a recorder of requests:

* A request is one `register`, one tracked frame (`track_one_async` to
  its `TrackResult.result()`), one train step (`models/training.py`) or
  one neural-object-field step (`nerf/runner.py`, kind "nerf"):
  its spans share the request's id. A span has a name, a start and an
  end (seconds on the host's `perf_counter`), its parent span (an index
  into the request's spans, or None) and its clock: "host" for what the
  host did (`span(name)`), "device" for the stages of a step body as the
  device ran them.
* Device stages. A step body calls `mark(name)` where a stage begins
  (`prep`, `crops`, `refiner`, `update`, `score.crops`, `score.net`,
  `rank`, `train.*`, `nerf.sample`, `nerf.encode`, `nerf.mlp`,
  `nerf.backward`, `nerf.grid_backward`, `nerf.adam`); a mark of the stage
  already running is nothing. A mark made on autograd's worker thread
  during a backward the body started (`nerf.grid_backward`) lands in the
  body's marks like any other.
  While a `StepGraph` captures its body, each mark records a timing
  event made with `external=True`, which becomes an event-record node of
  the CUDA graph, so every replay records it again; these nodes are
  captured whatever the flag says, so turning recording on never forces
  a capture. A replay made inside a request leaves the request a pending
  read, which the owner's `finish` turns into device spans after its
  fetch: a "step" span (parent: the host span that launched the replay)
  and one span per stage, from `elapsed_time` between consecutive marks;
  their durations are device time, placed at the replay's launch on the
  host clock. If the graph is replayed again before that read, the
  earlier replay's read is dropped (counter `device_reads_dropped`).
  Eager runs of a body (a register key's first call, the CPU) record
  ordinary timing events, or the host clock on the CPU, which is the
  device there. A body called directly, outside a StepGraph, records
  no device spans.
* The recorder records while a `torch.profiler` is recording
  (`torch._C._autograd._profiler_enabled()`, which a CUDA-only profile
  turns on too) or between `enable()` and `disable()`. Off, a request
  is None, a span or a mark costs one check of a module global and
  allocates nothing. While a profiler records, each host span is also a
  `torch.profiler.record_function` range, on the profiler's clock beside
  the kernels and runtime calls.
* Finished requests are kept in a ring of the last RING_REQUESTS
  (`requests(kind, last=n)`); `reset()` clears it and the counters.
  Counters are plain named numbers (`count`, `counters`).
* `stage_timer` is the operator's explicit host span: it records a
  request of kind "stage" whatever the flag; `timing_report` sums them.
* `trace`: a `torch.profiler` trace of the block (CPU and, with a card,
  CUDA activity), written as a Chrome trace.
"""
from __future__ import annotations

import collections
import contextlib
import os
import time

import torch

RING_REQUESTS = 4096
_NULL = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


class Span:
    """One span of a request; `covered` is the time its children of the
    same clock cover."""

    __slots__ = ("name", "start", "end", "parent", "request", "clock", "covered")

    def __init__(self, name, start, end, parent, request, clock):
        self.name, self.start, self.end = name, start, end
        self.parent, self.request, self.clock = parent, request, clock
        self.covered = 0.0

    @property
    def duration(self) -> float:
        return self.end - self.start

    @property
    def self_time(self) -> float:
        """The duration less the time its children cover."""
        return self.duration - self.covered

    def __repr__(self):
        return f"Span({self.name!r}, {self.clock}, {self.duration * 1e3:.3f} ms, parent={self.parent})"


class Request:
    """The spans of one request, in the order they were opened (a step's
    device spans after the host spans open when they were read)."""

    __slots__ = ("id", "kind", "spans", "_open", "_pending")

    def __init__(self, rid: int, kind: str):
        self.id, self.kind, self.spans = rid, kind, []
        self._open, self._pending = [], []

    def named(self, *names) -> list[Span]:
        return [s for s in self.spans if s.name in names]

    def seconds(self, *names) -> float:
        """The summed duration of the spans with these names."""
        return sum(s.duration for s in self.named(*names))

    def self_seconds(self, *names) -> float:
        """The summed self time of the spans with these names."""
        return sum(s.self_time for s in self.named(*names))

    def host_seconds(self) -> float:
        """The summed duration of the request's outermost host spans."""
        return sum(s.duration for s in self.spans if s.clock == "host" and s.parent is None)

    def has_device_spans(self) -> bool:
        return any(s.clock == "device" for s in self.spans)

    def _settle(self, wait: bool) -> None:
        """Turn the pending reads whose last mark has run (all of them with
        `wait`) into device spans."""
        keep = []
        for p in self._pending:
            if p.state == "pending" and (wait or p.done()):
                p.read(self)
            elif p.state == "pending":
                keep.append(p)
        self._pending = keep


class _Pending:
    """The marks of one run of a step body, to be read into `request`'s
    device spans under the span `parent`; `t0` is the run's launch on the
    host clock."""

    __slots__ = ("marks", "parent", "t0", "state")

    def __init__(self, marks, parent, t0):
        self.marks, self.parent, self.t0, self.state = marks, parent, t0, "pending"

    def done(self) -> bool:
        end = self.marks[-1][1]
        return not isinstance(end, torch.cuda.Event) or end.query()

    def read(self, req: Request) -> None:
        (_, first), *rest = self.marks
        if isinstance(first, torch.cuda.Event):
            rest[-1][1].synchronize()
            at = [first.elapsed_time(s) * 1e-3 for _, s in rest]
        else:
            at = [s - first for _, s in rest]
        root = Span("step", self.t0, self.t0 + at[-1], self.parent, req.id, "device")
        i = len(req.spans)
        req.spans.append(root)
        for (name, _), a, b in zip(rest, at, at[1:]):
            req.spans.append(Span(name, self.t0 + a, self.t0 + b, i, req.id, "device"))
            root.covered += b - a
        self.state = "read"


class _Recorder:
    def __init__(self):
        self.on = False
        self.ring = collections.deque(maxlen=RING_REQUESTS)
        self.current: Request | None = None
        self.next_id = 0
        self.counters: dict[str, float] = {}
        self.marks: list | None = None  # (name, stamp) of the body running under stages()
        self.stamp = None


_REC = _Recorder()


def recording() -> bool:
    return _REC.on or _profiler_enabled()


def enable() -> None:
    _REC.on = True


def disable() -> None:
    _REC.on = False


def reset() -> None:
    """Forget every finished request and every counter."""
    _REC.ring.clear()
    _REC.counters.clear()


def count(name: str, n=1) -> None:
    _REC.counters[name] = _REC.counters.get(name, 0) + n


def counters() -> dict:
    return dict(_REC.counters)


def begin(kind: str) -> Request | None:
    """A new request of `kind` while recording, else None."""
    if not recording():
        return None
    _REC.next_id += 1
    return Request(_REC.next_id, kind)


class _Within:
    __slots__ = ("req", "prev")

    def __init__(self, req):
        self.req = req

    def __enter__(self):
        self.prev, _REC.current = _REC.current, self.req
        return self.req

    def __exit__(self, *exc):
        _REC.current = self.prev
        return False


class _Block(_Within):
    def __exit__(self, *exc):
        _REC.current = self.prev
        if exc[0] is None:
            finish(self.req)
        return False


def within(req: Request | None):
    """Make `req` the request that spans and step runs record into (for
    None, nothing)."""
    return _NULL if req is None else _Within(req)


def finish(req: Request | None) -> None:
    """Read the device stages whose runs have ended and keep the request
    in the ring. Owners call it after their fetch."""
    if req is not None:
        req._settle(wait=False)
        _REC.ring.append(req)


def request(kind: str):
    """begin, within and finish around a block that ends with its fetch;
    yields the request, or None when not recording."""
    req = begin(kind)
    return _NULL if req is None else _Block(req)


class _HostSpan:
    __slots__ = ("req", "name", "idx", "rf")

    def __init__(self, req, name):
        self.req, self.name = req, name

    def __enter__(self):
        req = self.req
        self.idx = len(req.spans)
        parent = req._open[-1] if req._open else None
        req._open.append(self.idx)
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        req.spans.append(Span(self.name, time.perf_counter(), 0.0, parent, req.id, "host"))
        return self

    def __exit__(self, *exc):
        req = self.req
        s = req.spans[self.idx]
        s.end = time.perf_counter()
        req._open.pop()
        if s.parent is not None:
            req.spans[s.parent].covered += s.duration
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A host span of the current request (nothing outside a request)."""
    req = _REC.current
    if req is None:
        return _NULL
    return _HostSpan(req, name)


def mark(name: str) -> None:
    """Begin the device stage `name` of the step body running under
    `stages` (nothing outside one, or when `name` is already running)."""
    marks = _REC.marks
    if marks is None or marks[-1][0] == name:
        return
    marks.append((name, _REC.stamp()))


def _capture_event():
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    return ev


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


@contextlib.contextmanager
def _marking(stamp):
    prev = (_REC.marks, _REC.stamp)
    marks = [(None, stamp())]
    _REC.marks, _REC.stamp = marks, stamp
    try:
        yield marks
        marks.append(("", stamp()))
    finally:
        _REC.marks, _REC.stamp = prev


def capture_marks():
    """The marks of a body being captured into a CUDA graph, as
    event-record nodes, whatever the flag: yields the list of (name,
    event) the capture fills."""
    return _marking(_capture_event)


def stages(device: torch.device):
    """Around an eager run of a step body inside a request: its marks,
    read into the request's device spans at `finish` (timing events on a
    card, the host clock on the CPU). Nothing outside a request."""
    req = _REC.current
    if req is None:
        return _NULL
    return _eager_stages(req, _event if device.type == "cuda" else time.perf_counter)


@contextlib.contextmanager
def _eager_stages(req, stamp):
    parent = req._open[-1] if req._open else None
    t0 = time.perf_counter()
    with _marking(stamp) as marks:
        yield
    req._pending.append(_Pending(marks, parent, t0))


def replaying(marks, unread: _Pending | None) -> _Pending | None:
    """Before a replay of a graph captured with `marks`: drop the read of
    its previous replay if that is still pending, and return this
    replay's pending read (None outside a request)."""
    if unread is not None and unread.state == "pending":
        unread.state = "dropped"
        count("device_reads_dropped")
    req = _REC.current
    if req is None or not marks:
        return None
    p = _Pending(marks, req._open[-1] if req._open else None, time.perf_counter())
    req._pending.append(p)
    return p


def requests(kind: str, last: int | None = None) -> list[Request]:
    """The finished requests of `kind`, oldest first (the `last` n of
    them), their device stages read."""
    out = [r for r in _REC.ring if r.kind == kind]
    out = out[-last:] if last else out
    for r in out:
        r._settle(wait=True)
    return out


@contextlib.contextmanager
def stage_timer(name: str, sync: bool = True):
    """Record the wall time of the block as a request of kind "stage" with
    one host span `name`, whatever the flag. With sync=True the current
    CUDA device is synchronised before the clock stops (when a card is
    present), so the time covers the work the block enqueued. An
    exception in the block is raised as it is; no time is recorded for
    it."""
    _REC.next_id += 1
    req = Request(_REC.next_id, "stage")
    with _HostSpan(req, name):
        yield
        if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    _REC.ring.append(req)


def timing_report(reset: bool = False) -> dict[str, dict[str, float]]:
    """{stage: {"count", "total_s", "mean_ms"}} over the stage_timer
    requests in the ring; `reset` forgets them."""
    totals: dict[str, list[float]] = {}
    for r in _REC.ring:
        if r.kind == "stage":
            totals.setdefault(r.spans[0].name, []).append(r.spans[0].duration)
    if reset:
        kept = [r for r in _REC.ring if r.kind != "stage"]
        _REC.ring.clear()
        _REC.ring.extend(kept)
    return {name: {"count": len(ts), "total_s": sum(ts), "mean_ms": 1000.0 * sum(ts) / len(ts)}
            for name, ts in totals.items()}


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace"):
    """Profile the block with torch.profiler and write
    `<log_dir>/<name>.json` (a Chrome trace: chrome://tracing or Perfetto).
    Records CPU operators and, when a card is present, its kernels; the
    recorder's host spans appear as ranges of their names. The profiler
    object is yielded (for `key_averages()`)."""
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
