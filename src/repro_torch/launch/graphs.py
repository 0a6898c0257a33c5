"""Captured steps: the port's counterpart of ``jax.jit`` for a step whose
shapes are fixed.

The reference runs each train, sample and serve step as one XLA program.
:class:`StepGraphs` runs a step function as one ``torch.cuda.CUDAGraph``
per key (a drop rate, a step width), all of one path's graphs in one
memory pool (``torch.cuda.graph_pool_handle()``):

  * the first call at a key runs the function eagerly on a side stream:
    that call is the real step, and it warms up what a capture must not
    do for the first time (building a kernel, cuBLAS's workspace). The
    capture follows; it records the step's launches and runs nothing, so
    a run does as many real steps as an eager one;
  * a later call copies its inputs into the key's static buffers (host
    tensors through pinned staging, device tensors on the device) and
    replays. Its outputs are the graph's static outputs, overwritten by
    the next replay of the key: a caller reads them before the next step;
  * what the step changes besides its outputs (params, optimizer state,
    cache pools) it must change in place: a replay writes the addresses
    the capture saw. A tensor the step reads from the host at capture
    would be a constant of the key; the steps captured here read none
    (``tests/test_torch_compiled_step.py`` counts 0 host syncs in each);
  * the hand-written kernels' launch counters stay true: the capture
    enters each wrapper once but launches nothing, so each graph records
    the counters' change over its capture, takes it back, and adds it
    again at every replay.

Dispatch is by device, as the kernels' wrappers do it: on a card the step
is captured or the call raises (no fallback to eager); on any other
device every call runs the function eagerly (the CPU route of the tests).
A mesh's step stays eager (its collectives run through gloo on the
host, which a graph cannot hold): its callers do not build one.
"""
from __future__ import annotations

from collections.abc import Callable, Hashable
import dataclasses
import time
from typing import Any

import torch

from repro_torch.kernels import gathered_matmul as gm
from repro_torch.kernels import paged_attention as pa


def launch_counts() -> dict[str, int]:
    """The hand-written kernels' launch counters, by kernel."""
    return {**gm.launches, "paged_attention": pa.launches}


def add_launches(delta: dict[str, int]) -> None:
    """Add ``delta`` (kernel -> launches) to the kernels' counters."""
    for name, n in delta.items():
        if name == "paged_attention":
            pa.launches += n
        else:
            gm.launches[name] += n


class CudaGraphs:
    """Capture on a card: a side stream for the eager first call, a
    ``torch.cuda.CUDAGraph`` a key in one pool, pinned staging buffers."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()

    def run_eager(self, fn: Callable, args) -> Any:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            out = fn(*args)
        torch.cuda.current_stream(self.device).wait_stream(side)
        return out

    def capture(self, fn: Callable, args) -> tuple[Any, Any]:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            out = fn(*args)
        return graph, out

    def reserved(self) -> int:
        """Device memory reserved once the allocator's free cache is
        released: what a capture adds to it is its pool's."""
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(self.device)

    def staging(self, t: torch.Tensor) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


@dataclasses.dataclass
class _Graph:
    graph: Any
    inputs: list[torch.Tensor]  # the static input buffers, on the device
    staged: list[torch.Tensor | None]  # pinned host buffers of the host inputs
    out: Any  # the static outputs
    launches: dict[str, int]  # kernel launches a replay makes
    capture_s: float
    pool_bytes: int  # device memory the capture reserved


class StepGraphs:
    """``fn(key, *inputs)`` (tensors in, a tensor or a tuple of tensors
    out) captured once per key on ``device`` (module docstring).

    ``capture=False`` runs every call eagerly, on any device (what a
    caller asks for when it wants the eager step). ``backend`` captures
    and replays; by default :class:`CudaGraphs` on a card and none
    elsewhere. A test may give another with the same methods."""

    def __init__(self, fn: Callable, device, *, capture: bool = True, backend=None):
        self.fn = fn
        self.device = torch.device(device)
        if backend is None and capture and self.device.type == "cuda":
            backend = CudaGraphs(self.device)
        self.backend = backend
        self.graphs: dict[Hashable, _Graph] = {}
        self.replays = 0
        self._copied = None  # the event after the last staged copies

    @property
    def captured(self) -> bool:
        """Do calls run as captured graphs (else eagerly)?"""
        return self.backend is not None

    def __call__(self, key: Hashable, *inputs: torch.Tensor):
        if self.backend is None:
            return self.fn(key, *inputs)
        g = self.graphs.get(key)
        if g is None:
            return self._first(key, inputs)
        self._fill(g, inputs)
        g.graph.replay()
        add_launches(g.launches)
        self.replays += 1
        return g.out

    def _first(self, key, inputs):
        static = [torch.empty(t.shape, dtype=t.dtype, device=self.device) for t in inputs]
        staged = [self.backend.staging(t) if t.device != self.device else None for t in inputs]
        g = _Graph(None, static, staged, None, {}, 0.0, 0)
        self._fill(g, inputs)
        fn = lambda *args: self.fn(key, *args)  # noqa: E731
        out = self.backend.run_eager(fn, static)
        t0 = time.perf_counter()
        before, reserved = launch_counts(), self.backend.reserved()
        g.graph, g.out = self.backend.capture(fn, static)
        after = launch_counts()
        g.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        add_launches({k: -n for k, n in g.launches.items()})
        g.capture_s = time.perf_counter() - t0
        g.pool_bytes = self.backend.reserved() - reserved
        self.graphs[key] = g
        return out

    def _fill(self, g: _Graph, inputs) -> None:
        if len(inputs) != len(g.inputs):
            raise ValueError(f"{len(inputs)} inputs, the graph takes {len(g.inputs)}")
        host = [i for i, s in enumerate(g.staged) if s is not None]
        if host and self._copied is not None:
            self._copied.synchronize()  # the last step's copies have left the staging buffers
        for dst, src, pinned in zip(g.inputs, inputs, g.staged, strict=True):
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"input {tuple(src.shape)} {src.dtype}: the graph takes "
                                 f"{tuple(dst.shape)} {dst.dtype}")
            if pinned is not None:
                pinned.copy_(src)
                dst.copy_(pinned, non_blocking=True)
            else:
                dst.copy_(src)
        if host and self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(self.device))

    def stats(self) -> dict[str, Any]:
        """Graphs captured (their keys), replays, capture seconds and the
        device memory the captures reserved (the shared pool)."""
        return {
            "captured": self.captured,
            "keys": [repr(k) for k in self.graphs],
            "replays": self.replays,
            "capture_s": sum(g.capture_s for g in self.graphs.values()),
            "pool_bytes": sum(g.pool_bytes for g in self.graphs.values()),
        }
