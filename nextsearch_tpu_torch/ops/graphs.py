"""The launch cache: the port's counterpart of ``jax.jit`` with static
arguments, for the serving launches.

The JAX package runs each serving launch as one compiled program per
distinct set of static arguments and input shapes
(``bm25_search_sparse_packed`` and its kin are ``jax.jit`` with
``static_argnames``); ``pin_shapes`` freezes the statics so that serving
compiles one program per envelope, and ``Engine.warmup`` compiles them up
front. Here each distinct key is captured once into a CUDA graph and
replayed after that. The key is the launch function, its static arguments,
the shapes and dtypes of its per-batch tensors, and the device. A launch
function takes every switch it reads as an argument (the caller reads the
environment, as TorchIndex reads NEXTSEARCH_H_BF16), so a graph is never
replayed under a switch it was not captured with.

- ``LaunchCache.run(fn, tensors, statics)`` calls ``fn(**tensors,
  **statics)``. ``tensors`` are the per-batch tensors (the plan): each
  graph has a static copy of them, into which a replay copies the fresh
  ones on the current stream. ``statics`` are the keyword arguments that
  key the graph; a tensor among them (a persistent table of the index) is
  captured by address, keyed by identity and held by the entry.
- On a miss the function runs once eagerly on a side stream, so that
  first-use work (the kernel build, ``cudaFuncSetAttribute``, cub's and
  cuBLAS's workspaces) stays out of the graph, then a second call is
  captured with ``torch.cuda.graph`` into the cache's one memory pool, on
  a capture stream of the cache's device. Graphs of one cache are replayed
  one after another on one stream, so they share the pool: a graph's
  intermediates are dead once its output is copied out.
- A replay hands back a copy of the static output: the next replay
  overwrites it while an earlier result may still be read (a depth-2
  pipeline; the hybrid rerank on ``_HostCopy.device_outs``).
- The kernel wrappers' launch counters (``cuda_build.COUNTERS``, where
  each module of wrappers registers its own) advance on every replay by
  what the capture recorded; a capture itself launches nothing and counts
  nothing. The eager call of a miss launches, and counts, as any eager
  call.
- A capture that fails raises (a host sync inside the function, for
  example): nothing falls back to eager. A cache built with
  ``enabled=False`` runs every launch eagerly; ``NEXTSEARCH_CUDA_GRAPHS=0``
  is its default, read once when the index builds its cache, and logged:
  the counterpart of ``JAX_DISABLE_JIT``, for A/B runs and debugging.

Each capture is a span ``graphs.capture`` (utils/profiling.GLOBAL_TRACER),
opened around it; no span opens inside the captured function.

CPU tensors run the function as it is: there is nothing to capture. A
stand-in backend (``CPU_BACKEND``) makes a cache on the CPU go through the
capture and replay logic, so that the tests exercise it without a card.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List

import torch

from ..utils.logging import log
from ..utils.profiling import GLOBAL_TRACER
from .cuda_build import COUNTERS

# A stand-in capture backend for caches on the CPU (the tests install one);
# None runs CPU launches as they are.
CPU_BACKEND = None


def read_counters() -> List[int]:
    """Every registered launch counter's value (COUNTERS' order; the
    list only grows, as modules of wrappers are imported)."""
    return [getattr(obj, attr) for obj, attr in COUNTERS]


def write_counters(values) -> None:
    for (obj, attr), v in zip(COUNTERS, values):
        setattr(obj, attr, v)


def _static_key(v):
    if isinstance(v, torch.Tensor):  # a persistent table, by address
        return ("tensor", id(v), v.data_ptr(), tuple(v.shape), v.dtype)
    return v


def _copy_out(out):
    """A copy of a static output (a tensor or a tuple of tensors)."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    return tuple(o.clone() for o in out)


def _check_out(out) -> None:
    outs = (out,) if isinstance(out, torch.Tensor) else out
    if not (isinstance(outs, tuple)
            and all(isinstance(o, torch.Tensor) for o in outs)):
        raise TypeError("a graphed launch must return a tensor or a tuple "
                        f"of tensors, not {type(out).__name__}")


def _stream_of(streams: Dict[torch.device, Any], device) -> Any:
    s = streams.get(device)
    if s is None:
        s = streams[device] = torch.cuda.Stream(device)
    return s


class CudaGraphs:
    """Capture and replay through torch.cuda.graph."""

    # One side stream per device for every cache's eager call, and one
    # capture stream per device: cuBLAS keeps a workspace (32 MiB on an
    # H100) for each stream it has run on, for the life of the process, so
    # streams per cache would leak them with every reload. The capture
    # stream must lie on the cache's device: torch.cuda.graph's own default
    # is one stream for the whole process, made on whichever card captured
    # first, and a capture for another card on it records nothing of the
    # launches, which go to that card's current stream.
    _side: Dict[torch.device, Any] = {}
    _capture: Dict[torch.device, Any] = {}

    def pool(self, device):
        return torch.cuda.graph_pool_handle()

    def warm(self, fn: Callable, device) -> None:
        cur = torch.cuda.current_stream(device)
        side = _stream_of(self._side, device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn()
        cur.wait_stream(side)

    def capture(self, fn: Callable, pool, device):
        graph = torch.cuda.CUDAGraph()
        # thread_local: only a host sync in this thread's capture is an
        # error (other threads may plan or copy meanwhile)
        with torch.cuda.device(device), torch.cuda.graph(
                graph, pool=pool, stream=_stream_of(self._capture, device),
                capture_error_mode="thread_local"):
            out = fn()
        return graph, out

    def replay(self, graph) -> None:
        graph.replay()


class _Entry:
    __slots__ = ("graph", "inputs", "out", "statics", "delta")

    def __init__(self, graph, inputs, out, statics, delta):
        self.graph, self.inputs, self.out = graph, inputs, out
        self.statics, self.delta = statics, delta


class LaunchCache:
    """One index's graphs, keyed as jax.jit keys its programs. Dropped with
    its index: the graphs, their pool and the tables they hold go with it."""

    def __init__(self, device, backend=None, enabled=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # tensors name their card: cuda:0, not cuda
            self.device = torch.device("cuda", torch.cuda.current_device())
        if backend is None:
            backend = (CudaGraphs() if self.device.type == "cuda"
                       else CPU_BACKEND)
        if enabled is None:
            enabled = os.environ.get("NEXTSEARCH_CUDA_GRAPHS", "1") != "0"
            if not enabled:
                log("graphs", f"NEXTSEARCH_CUDA_GRAPHS=0: launches on "
                    f"{self.device} run eagerly, without CUDA graphs")
        self.enabled = enabled
        self.backend = backend if enabled else None
        self._graphs: Dict[tuple, _Entry] = {}
        self._pool = None
        self._lock = threading.Lock()
        self.captures = 0
        self.replays = 0
        self.copies = 0  # tensors the replays copied in (plan) and out
        self.eager = 0  # launches run as they are (CPU, or switched off)
        self.capture_s = 0.0  # seconds in misses: eager call and capture

    def keys(self) -> List[tuple]:
        """Each captured key: (function name, per-batch (name, shape,
        dtype), statics with tables as ("tensor", ...))."""
        return [(k[0].__name__, k[2], k[1]) for k in self._graphs]

    def run(self, fn: Callable, tensors: Dict[str, torch.Tensor],
            statics: Dict[str, Any]):
        """fn(**tensors, **statics), from its graph where there is one."""
        if self.backend is None:
            self.eager += 1
            return fn(**tensors, **statics)
        names = sorted(tensors)
        for n in names:
            if tensors[n].device != self.device:
                raise ValueError(f"launch cache on {self.device}: tensor "
                                 f"{n} on {tensors[n].device}")
        key = (fn, tuple(sorted((k, _static_key(v))
                                for k, v in statics.items())),
               tuple((n, tuple(tensors[n].shape), tensors[n].dtype)
                     for n in names),
               self.device)
        with self._lock:
            entry = self._graphs.get(key)
            if entry is None:
                # the span lies around the capture: none opens inside fn
                with GLOBAL_TRACER.span("graphs.capture"):
                    entry = self._capture(key, fn, names, tensors, statics)
            else:
                for n, s in zip(names, entry.inputs):
                    s.copy_(tensors[n], non_blocking=True)
            self.backend.replay(entry.graph)
            self.replays += 1
            self.copies += len(names) + (
                1 if isinstance(entry.out, torch.Tensor) else len(entry.out))
            write_counters([c + d for c, d in zip(read_counters(),
                                                  entry.delta)])
            return _copy_out(entry.out)

    def _capture(self, key, fn, names, tensors, statics) -> _Entry:
        t0 = time.perf_counter()
        inputs = [tensors[n].clone() for n in names]

        def call():
            return fn(**dict(zip(names, inputs)), **statics)

        self.backend.warm(call, self.device)
        if self._pool is None:
            self._pool = self.backend.pool(self.device)
        before = read_counters()
        try:
            graph, out = self.backend.capture(call, self._pool, self.device)
        finally:
            recorded = read_counters()
            write_counters(before)  # a capture launches nothing
        _check_out(out)
        entry = _Entry(graph, inputs, out, statics,
                       [r - b for r, b in zip(recorded, before)])
        self._graphs[key] = entry
        self.captures += 1
        dt = time.perf_counter() - t0
        self.capture_s += dt
        log("graphs", f"captured {fn.__name__} "
            f"{[tuple(t.shape) for t in inputs]} in {dt * 1e3:.1f} ms "
            f"({self.captures} graph(s) on {self.device})")
        return entry
