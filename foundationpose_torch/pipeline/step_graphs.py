"""Steps whose shapes are static, captured once and replayed: the port's
counterpart of `jax.jit`.

The JAX package dispatches each tracking frame as one compiled
executable, one per (path, static sizes, iterations). Here a `StepGraph`
captures one step in a `torch.cuda.CUDAGraph` and replays it per call,
and a `StepGraphs` cache, owned by each `FoundationPose` and each
`MultiTracker`, keeps one StepGraph per (path, sizes, iterations, object
count, shapes and dtypes of the dynamic inputs).

A graph reads its inputs from static tensors and writes its output to a
static tensor, by address. So a call copies its inputs into the static
inputs (stream-ordered) and returns a fresh copy of the static output:
the next replay overwrites it while earlier results may still be in
flight. What the step reads by address besides its inputs (the refiner's
weights, the config, the render meshes) is the step's `statics`: its
owner clears the cache when any of them is replaced, and a cached step
whose statics are not the caller's is captured again. Weights changed in
place keep their addresses and reach the graph.

On the CPU a StepGraph runs its body eagerly, through the same static
inputs and output, so the copies in and out are exercised where no graph
can be captured. On the card a failed capture or replay raises; nothing
runs the body eagerly in its place.
"""
from __future__ import annotations

import time

import torch

from ..ops import attention_cuda, raster_cuda, segment_add_cuda

WARMUP_RUNS = 2  # eager runs on a side stream before a capture


def _kernel_counters():
    return (raster_cuda.KERNEL, attention_cuda.KERNEL, segment_add_cuda.K3, segment_add_cuda.K4)


class StepGraph:
    """One step `body(*inputs) -> tensor` with static input shapes.

    On the card the first call runs the body WARMUP_RUNS times on a side
    stream (so that cuDNN, cuBLAS and the kernels' libraries have made
    their choices and loaded), captures it in a CUDA graph (in `pool`, a
    `torch.cuda.graph_pool_handle()`, if given) and replays it; later
    calls replay it. The kernel wrappers count launches in Python, which a
    replay bypasses: the counts the capture made are recorded in
    `launches` and added at every replay, and the capture itself counts
    none (the warm-up runs launch, and count)."""

    def __init__(self, body, inputs, statics=(), pool=None):
        self.body = body
        self.statics = tuple(statics)
        self.inputs = tuple(torch.empty_like(x) for x in inputs)
        self.device = self.inputs[0].device
        self.pool = pool
        self.output = None
        self.graph = None
        self.launches = ()  # (counter, launches of one replay)
        self.capture_ms = None

    def _capture(self):
        dev = self.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self.body(*self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        counters = _kernel_counters()
        before = [c.launches for c in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            out = self.body(*self.inputs)
        self.launches = tuple((c, c.launches - n) for c, n in zip(counters, before) if c.launches != n)
        for c, n in zip(counters, before):
            c.launches = n  # capturing launches nothing
        self.graph, self.output = graph, out
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    @torch.inference_mode()
    def __call__(self, *inputs) -> torch.Tensor:
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        if self.device.type != "cuda":
            out = self.body(*self.inputs)
            if self.output is None:
                self.output = torch.empty_like(out)
            self.output.copy_(out)
        else:
            with torch.cuda.device(self.device):  # capture and replay on the inputs' card
                if self.graph is None:
                    self._capture()
                self.graph.replay()
            for counter, n in self.launches:
                counter.launches += n
        return self.output.clone()


class StepGraphs:
    """An owner's captured steps, all in one memory pool on the card.

    `run(key, statics, body, *inputs)` replays the StepGraph of `key` and
    the inputs' shapes, dtypes and devices, capturing it on a miss or when
    the cached one was captured with other statics (compared by identity:
    the cache holds them, so an address is never reused under it). The
    owner calls `clear()` when it replaces what its steps read by address."""

    def __init__(self):
        self._graphs: dict = {}
        self._pool = None

    def __len__(self) -> int:
        return len(self._graphs)

    def items(self) -> list:
        """[(key, StepGraph)]; a key is (path key, ((shape, dtype, device) of
        each dynamic input))."""
        return list(self._graphs.items())

    def clear(self) -> None:
        self._graphs.clear()
        self._pool = None

    def run(self, key, statics, body, *inputs) -> torch.Tensor:
        key = (key, tuple((tuple(x.shape), x.dtype, x.device) for x in inputs))
        step = self._graphs.get(key)
        if step is None or len(step.statics) != len(statics) or any(
                a is not b for a, b in zip(step.statics, statics)):
            if self._pool is None and inputs[0].device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
            step = self._graphs[key] = StepGraph(body, inputs, statics, self._pool)
        return step(*inputs)


class GraphOwner:
    """Base of the owners of a StepGraphs cache (`self._graphs`): assigning
    an attribute named in GRAPH_STATICS, what the owner's captured steps
    read by address, clears the cache."""

    GRAPH_STATICS = ("refiner", "cfg", "mesh_tensors")

    def __setattr__(self, name, value):
        if name in self.GRAPH_STATICS and "_graphs" in self.__dict__:
            self._graphs.clear()
        super().__setattr__(name, value)


def run_step(graphs: StepGraphs | None, key, statics, body, *inputs) -> torch.Tensor:
    """`body(*inputs)` through `graphs` (an owner's cache), or through a
    StepGraph captured for this call alone when `graphs` is None."""
    if graphs is None:
        graphs = StepGraphs()
    return graphs.run(key, statics, body, *inputs)
