"""The capture cache: each solve shape runs as one replay of a CUDA graph —
the port's counterpart of the JAX package's ``instrument_jit`` (a solve is
one compiled program there, its sweeps under ``lax.scan``).

A solver hands :meth:`GraphCache.run` three things:

- ``inputs``: the per-solve tensors (the state's arrays, the sweep plans,
  the seed and temperature tables). They are data: on a replay each is
  copied into the graph's own buffer first, since a graph keeps the
  addresses it captured;
- ``operands``: large read-only tensors the body reads in place (the
  adjacency, a prepared weight matrix, the sparse graph's arrays). They
  are part of the key by identity, and the cache entry holds them, so an
  operand cannot be freed while a graph still reads its memory;
- ``make_body``: a function called on a miss that returns the body, a
  function from the inputs to a dict of output tensors that reads nothing
  back to the host. ``make_body`` itself may place host-built tables on
  the device; that happens before the capture.

On a miss the body runs once eagerly on a side stream — the warm-up that
``torch.cuda.graphs`` requires, which also loads every kernel library —
and its outputs are the solve's; the capture follows, and every later call
with the same key replays it. ``cuda_graph_captures_total{fn=...}`` counts
the captures (a second capture of one steady shape means the key is
unstable, as a second ``jax_traces_total`` means a retrace). The kernel
wrappers count their launches on the host, which a replay skips: a capture
records what its body launched, takes it back off the counts (nothing ran)
and each replay adds it again. The first capture of each ``fn`` also
records its cost (tensor sizes, pool, the kernels' work) in
``telemetry/costmodel.py``'s book.

:func:`eager` — the counterpart of ``jax.disable_jit()`` — runs every solve
op by op; tests and ``chip_smoke.py`` compare the two. On the CPU the body
always runs eagerly. A capture or a replay that fails raises: nothing falls
back to the eager body.
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

import torch

from kubernetes_rescheduling_tpu_torch.ops import KERNEL_WRAPPERS
from kubernetes_rescheduling_tpu_torch.telemetry import costmodel
from kubernetes_rescheduling_tpu_torch.telemetry.registry import get_registry

Body = Callable[[dict], dict]

_EAGER = contextvars.ContextVar("krt_eager_solves", default=False)


@contextlib.contextmanager
def eager():
    """Run every solve in this context op by op, without capture or replay
    (the counterpart of ``jax.disable_jit()``)."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a host tensor goes to the card through pinned
    memory without waiting, so drawing and uploading a solve's plans reads
    nothing back and never stalls the host behind the card."""
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _identity(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype, str(t.device))


def _launch_counts() -> list[int]:
    return [fn.launches for fn in KERNEL_WRAPPERS]


def _work() -> tuple[float, float]:
    """The kernel wrappers' total work so far (ops/work.py)."""
    return (sum(fn.work_ops for fn in KERNEL_WRAPPERS),
            sum(fn.work_bytes for fn in KERNEL_WRAPPERS))


def _add_launches(counts) -> None:
    for fn, n in zip(KERNEL_WRAPPERS, counts):
        fn.launches += n


@dataclass
class _Entry:
    graph: torch.cuda.CUDAGraph
    inputs: dict
    outputs: dict
    body: Body                # holds the device tables its graph reads
    operands: tuple
    launches: tuple           # per kernel wrapper, per replay
    capture_s: float
    pool_bytes: int           # device memory the capture reserved


# captured solves kept: each holds its graph's memory pool and its
# operands (chip_smoke.py's solve_captured measured pools of 0.7 GB at
# `large` and 1.4 GB at `sparse50k` on an NVIDIA H100 80GB HBM3)
MAX_ENTRIES = 8


class GraphCache:
    """Captured solves by key, the least recently used evicted past
    ``MAX_ENTRIES``."""

    def __init__(self):
        self._entries: OrderedDict[tuple, _Entry] = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()

    def latest(self) -> _Entry | None:
        """The entry captured or replayed last."""
        return next(reversed(self._entries.values()), None)

    @staticmethod
    def _full_key(fn, key, inputs, operands) -> tuple:
        sig = tuple((k, tuple(v.shape), v.dtype, str(v.device)) for k, v in inputs.items())
        return (fn, key, sig, tuple(_identity(t) for t in operands if t is not None))

    def run(self, fn: str, key: tuple, inputs: dict, make_body: Callable[[], Body],
            operands=()) -> dict:
        """The body's outputs for ``inputs``: eagerly on the CPU or under
        :func:`eager`, else by a replay of the graph captured for
        ``(fn, key, the inputs' shapes, the operands' identities)``."""
        devices = {v.device for v in inputs.values()}
        if len(devices) != 1:
            raise ValueError(f"{fn}: inputs on several devices {sorted(map(str, devices))}")
        if devices.pop().type != "cuda" or _EAGER.get():
            return make_body()(inputs)
        full = self._full_key(fn, key, inputs, operands)
        entry = self._entries.get(full)
        if entry is None:
            return self._capture(fn, full, inputs, make_body(), tuple(operands))
        self._entries.move_to_end(full)
        for name, buf in entry.inputs.items():
            buf.copy_(inputs[name])
        entry.graph.replay()
        _add_launches(entry.launches)
        costmodel.republish(fn)
        # the graph overwrites its outputs on the next replay
        return {k: v.clone() for k, v in entry.outputs.items()}

    def _capture(self, fn, full, inputs, body, operands) -> dict:
        static = {k: v.clone() for k, v in inputs.items()}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warm = body(static)
        torch.cuda.current_stream().wait_stream(side)
        # an output that is an input buffer would change at the next replay
        held = {v.untyped_storage().data_ptr() for v in static.values()}
        warm = {k: v.clone() if v.untyped_storage().data_ptr() in held else v
                for k, v in warm.items()}
        # what torch.cuda.graph does on entry, done first so that the
        # reserved memory before and after measures the graph's own pool
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        before, work0 = _launch_counts(), _work()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            outputs = body(static)
        capture_s = time.perf_counter() - t0
        after, work1 = _launch_counts(), _work()
        launches = tuple(a - b for a, b in zip(after, before))
        _add_launches([-n for n in launches])  # the capture ran nothing
        pool_bytes = torch.cuda.memory_reserved() - reserved
        get_registry().counter(
            "cuda_graph_captures_total",
            "solves captured as a CUDA graph (one per solve key; a second "
            "capture of a steady shape means an unstable key)",
            labelnames=("fn",),
        ).labels(fn=fn).inc()
        self._entries[full] = _Entry(graph, static, outputs, body, operands, launches,
                                     capture_s, pool_bytes)
        # the compiled-cost book: the first capture of each fn
        costmodel.record_capture(fn, costmodel.graph_cost(
            static, operands, outputs, ops=work1[0] - work0[0], nbytes=work1[1] - work0[1],
            temp_bytes=pool_bytes))
        while len(self._entries) > MAX_ENTRIES:
            self._entries.popitem(last=False)
        return warm


CACHE = GraphCache()


def launches_per_replay(entry: _Entry) -> dict[str, int]:
    """The kernel launches one replay of ``entry`` stands for, by wrapper."""
    return {fn.__name__: n for fn, n in zip(KERNEL_WRAPPERS, entry.launches)}
