"""Steps whose shapes are static, captured once and replayed: the port's
counterpart of `jax.jit`.

The JAX package dispatches each register and each tracking frame as one
compiled executable, one per (path, static sizes, iterations). Here a
`StepGraph` captures one step in a `torch.cuda.CUDAGraph` and replays it
per call, and a `StepGraphs` cache, owned by each `FoundationPose` and
each `MultiTracker`, keeps one StepGraph per (path, sizes, iterations,
funnel, object count, shapes and dtypes of the dynamic inputs).

A graph reads its inputs from static tensors and writes its output (a
tensor or a tuple of tensors) to static tensors, by address. So a call
copies its inputs into the static inputs (stream-ordered) and returns a
fresh copy of each output: the next replay overwrites them while earlier
results may still be in flight or be read. What the step reads by address
besides its inputs (the nets' weights, the config, the render meshes) is
the step's `statics`: its owner clears the cache when any of them is
replaced, and a cached step whose statics are not the caller's is
captured again. Weights changed in place keep their addresses and reach
the graph.

When a step is captured:
- a tracking step (the default) runs its body WARMUP_RUNS times on a side
  stream at its first call, then is captured and replayed;
- a register step (`eager_first=True`) runs its body once eagerly on the
  current stream at its first call, through its static inputs, and
  returns that result: the run is its warm-up, and a register is often
  made once per video, so it costs no capture. The second call captures
  and replays.

One pool: every step of an owner is captured into the owner's one memory
pool (`StepGraphs._pool`). A capture takes the blocks that earlier
captures freed (their intermediates) and keeps only its static outputs
for itself, so the pool holds about the largest step's intermediates
plus each step's outputs, not a step's intermediates per key (the
register's window sizes come in 64-px steps, and each is a key). This is
safe because an owner's steps replay on one stream, one after another,
and each call copies its outputs out before the next replay can reuse a
block; a static output is never read after the call that wrote it.

On the CPU a StepGraph runs its body eagerly at every call, through the
same static inputs (and, after a register step's first call, the same
static outputs), so the copies in and out are exercised where no graph
can be captured. On the card a failed capture or replay raises; nothing
runs the body eagerly in its place.

Device stages (`utils/profiling.py`): a capture records the body's
`profiling.mark` calls as timing-event nodes of the graph, whatever the
recorder's flag; a replay inside a request leaves the request a read of
them, and an eager run inside one records its own marks.
"""
from __future__ import annotations

import contextlib
import time

import torch

from ..ops import attention_cuda, epilogue_cuda, raster_cuda, segment_add_cuda
from ..utils import profiling

WARMUP_RUNS = 2  # eager runs on a side stream before a tracking step's capture


def _kernel_counters():
    return (raster_cuda.KERNEL, attention_cuda.KERNEL, segment_add_cuda.K3, segment_add_cuda.K4,
            epilogue_cuda.KERNEL)


def _tensors(out) -> tuple:
    """A step's output, a tensor or a tuple of tensors, as a tuple."""
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def _on(device: torch.device):
    """Run on `device`'s card (a no-op on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _copy(out):
    """A fresh copy of a step's output, in its structure."""
    return out.clone() if isinstance(out, torch.Tensor) else tuple(o.clone() for o in out)


class StepGraph:
    """One step `body(*inputs) -> tensor or tuple of tensors` with static
    input shapes.

    On the card a tracking step's first call runs the body WARMUP_RUNS
    times on a side stream (so that cuDNN, cuBLAS and the kernels'
    libraries have made their choices and loaded), captures it in a CUDA
    graph (in `pool`, a `torch.cuda.graph_pool_handle()`, if given) and
    replays it. A step made with `eager_first` runs the body once on the
    current stream at its first call and returns that result; its second
    call captures, with no further warm-up, and replays. Later calls
    replay. The kernel wrappers count launches in Python, which a replay
    bypasses: the counts the capture made are recorded in `launches` and
    added at every replay, and the capture itself counts none (the
    warm-up runs launch, and count). `replays` counts the calls answered
    from the static outputs: graph replays on the card, the body run
    through the static tensors on the CPU. `marks` are the capture's
    stage marks (profiling.capture_marks)."""

    def __init__(self, body, inputs, statics=(), pool=None, eager_first=False):
        self.body = body
        self.statics = tuple(statics)
        self.inputs = tuple(torch.empty_like(x) for x in inputs)
        self.device = self.inputs[0].device
        self.pool = pool
        self.eager_first = eager_first
        self.output = None
        self.graph = None
        self.launches = ()  # (counter, launches of one replay)
        self.capture_ms = None
        self.eager_runs = 0
        self.replays = 0
        self.marks = ()
        self._unread = None  # the last replay's pending read of its marks

    def _capture(self):
        dev = self.device
        t0 = time.perf_counter()
        if not self.eager_first:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    self.body(*self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
        counters = _kernel_counters()
        before = [c.launches for c in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool), profiling.capture_marks() as marks:
            out = self.body(*self.inputs)
        self.launches = tuple((c, c.launches - n) for c, n in zip(counters, before) if c.launches != n)
        for c, n in zip(counters, before):
            c.launches = n  # capturing launches nothing
        self.graph, self.output, self.marks = graph, out, marks
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    @torch.inference_mode()
    def __call__(self, *inputs):
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        if self.eager_first and self.eager_runs == 0:
            self.eager_runs = 1
            with _on(self.device):
                with profiling.stages(self.device):
                    out = self.body(*self.inputs)
                return _copy(out)
        if self.device.type != "cuda":
            with profiling.stages(self.device):
                out = self.body(*self.inputs)
            if self.output is None:
                self.output = _copy(out)
            else:
                for static, o in zip(_tensors(self.output), _tensors(out)):
                    static.copy_(o)
        else:
            with _on(self.device):  # capture and replay on the inputs' card
                if self.graph is None:
                    self._capture()
                self._unread = profiling.replaying(self.marks, self._unread)
                self.graph.replay()
            for counter, n in self.launches:
                counter.launches += n
        self.replays += 1
        return _copy(self.output)


class StepGraphs:
    """An owner's captured steps, all in one memory pool on the card (see
    the module's docstring for why one pool is enough).

    `run(key, statics, body, *inputs)` replays the StepGraph of `key` and
    the inputs' shapes, dtypes and devices, making it on a miss or when
    the cached one was made with other statics (compared by identity:
    the cache holds them, so an address is never reused under it). The
    owner calls `clear()` when it replaces what its steps read by address.
    `captures` and `capture_s` count the steps captured and the seconds
    their captures took (StepGraph.capture_ms), over the owner's life:
    `clear()` keeps them."""

    def __init__(self):
        self._graphs: dict = {}
        self._pool = None
        self.captures = 0
        self.capture_s = 0.0

    def __len__(self) -> int:
        return len(self._graphs)

    def items(self) -> list:
        """[(key, StepGraph)]; a key is (path key, ((shape, dtype, device) of
        each dynamic input))."""
        return list(self._graphs.items())

    def clear(self) -> None:
        self._graphs.clear()
        self._pool = None

    def run(self, key, statics, body, *inputs, eager_first=False):
        key = (key, tuple((tuple(x.shape), x.dtype, x.device) for x in inputs))
        step = self._graphs.get(key)
        if step is None or len(step.statics) != len(statics) or any(
                a is not b for a, b in zip(step.statics, statics)):
            if self._pool is None and inputs[0].device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
            step = self._graphs[key] = StepGraph(body, inputs, statics, self._pool, eager_first)
        graph = step.graph
        out = step(*inputs)
        if step.graph is not graph:  # this call captured the step
            self.captures += 1
            self.capture_s += step.capture_ms * 1e-3
        return out


class GraphOwner:
    """Base of the owners of a StepGraphs cache (`self._graphs`): assigning
    an attribute named in GRAPH_STATICS, what the owner's captured steps
    read by address, clears the cache."""

    GRAPH_STATICS = ("refiner", "scorer", "cfg", "mesh_tensors")

    def __setattr__(self, name, value):
        if name in self.GRAPH_STATICS and "_graphs" in self.__dict__:
            self._graphs.clear()
        super().__setattr__(name, value)


def run_step(graphs: StepGraphs | None, key, statics, body, *inputs, eager_first=False):
    """`body(*inputs)` through `graphs` (an owner's cache), or through a
    StepGraph made for this call alone when `graphs` is None (which, for
    an `eager_first` step, runs the body once and captures nothing)."""
    if graphs is None:
        graphs = StepGraphs()
    return graphs.run(key, statics, body, *inputs, eager_first=eager_first)
