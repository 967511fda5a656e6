"""Nested host-side spans, exported as Chrome trace-event JSON — the port of
``kubernetes_rescheduling_tpu.telemetry.spans``.

``with span("controller/round"):`` wraps any host-side region; spans nest
naturally (the exporter emits complete events — ``ph: "X"`` — whose
nesting Perfetto reconstructs from timestamps per thread). The file loads
in https://ui.perfetto.dev or ``chrome://tracing``. The port puts the JAX
package's span names at the counterpart sites, so a trace of either reads
the same.

``span(..., profile_dir=...)`` runs the region under a ``torch.profiler``
capture (:func:`trace_to`) as well: the host span is recorded AND the
device activity lands in ``profile_dir`` as a Chrome trace.

Span durations also feed the metrics registry (histogram
``span_seconds{span=...}``).

**Hot spans.** ``span(name, hot=True, ...)`` marks a site on a path that
runs every round (the streaming replay, the capture cache). Such a span
records only while tracing is on: while a ``torch.profiler`` session
records in the process (a ``--trace 1`` benchmark window, the ops
plane's ``POST /profile``, ``span(profile_dir=...)``), or after
:meth:`Tracer.enable`. Off, it costs one check and returns a shared
no-op context. On, it also opens a ``torch.profiler.record_function`` of
the same name while a profiler records, so it lands in the same kineto
trace as the device activity, on one clock: the Tracer re-anchors its
wall clock each time tracing turns on.

Every span carries its ``index`` (a sequence number of its tracer), its
``parent`` (the enclosing span's index) and its ``call`` (the index of
the outermost span open on its thread, shared by every span of one entry
call).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterator

import torch

from kubernetes_rescheduling_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    get_registry,
)


@contextlib.contextmanager
def trace_to(log_dir: str | None):
    """A ``torch.profiler`` capture of the region (CPU activity, and CUDA
    activity when the card is there) exported as a Chrome trace under
    ``log_dir``; a no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    prof = start_profiler()
    try:
        yield
    finally:
        stop_profiler(prof, log_dir)


def start_profiler():
    """Start a ``torch.profiler`` capture (CUDA activity too when the card
    is there); :func:`stop_profiler` ends it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def stop_profiler(prof, log_dir: str) -> str:
    """End a capture and export it as ``<log_dir>/trace.json``; returns
    the path."""
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@dataclass(frozen=True)
class SpanEvent:
    """One completed span (Chrome trace-event ``ph: "X"`` semantics)."""

    name: str
    ts_us: float      # wall-clock start, microseconds since the epoch
    dur_us: float
    tid: int
    depth: int
    args: dict[str, Any] = field(default_factory=dict)
    index: int = -1
    parent: int | None = None
    call: int | None = None


def _profiler_recording() -> bool:
    """Whether a ``torch.profiler`` session records in this process."""
    return torch._C._autograd._profiler_enabled()


class _Off:
    """The context a hot span returns while tracing is off: shared,
    stateless, its ``as`` target None."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class Tracer:
    """Collects spans; bounded to ``max_events`` (ring semantics — the
    newest spans win, matching the logger's ring buffer contract)."""

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        max_events: int = 100_000,
    ) -> None:
        self._events: collections.deque[SpanEvent] = collections.deque(
            maxlen=max_events
        )
        self._dropped = 0
        self._max_events = max_events
        self._lock = threading.Lock()
        self._local = threading.local()
        self._registry = registry
        self._seq = itertools.count()
        self._enabled = False
        self._on = False  # tracing at the last hot check
        self._anchor()

    def _anchor(self) -> None:
        # perf_counter gives monotonic durations; the wall anchor places
        # them on the epoch axis (the profiler's), so traces from separate
        # processes, and the kineto trace of this one, align
        self._wall_anchor_ns = time.time_ns()
        self._perf_anchor_ns = time.perf_counter_ns()

    def _now_us(self) -> float:
        return (self._wall_anchor_ns + time.perf_counter_ns() - self._perf_anchor_ns) / 1e3

    def enable(self) -> None:
        """Turn tracing on without a profiler: hot spans and the solve's
        phase times record until :meth:`disable`."""
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def tracing(self) -> bool:
        """Whether hot spans record now; re-anchors the wall clock on the
        turn from off to on."""
        on = self._enabled or _profiler_recording()
        if on and not self._on:
            self._anchor()
        self._on = on
        return on

    def _depth_stack(self) -> list[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, profile_dir: str | None = None, *, hot: bool = False,
             **args: Any):
        """A context that records the region as a span; its ``as`` target
        is the span's ``args`` dict, which the region may add to. A hot
        span records only while :meth:`tracing` (else the target is
        None)."""
        if hot and not self.tracing():
            return _OFF
        return self._span(name, profile_dir, hot, args)

    @contextlib.contextmanager
    def _span(self, name: str, profile_dir: str | None, hot: bool,
              args: dict[str, Any]) -> Iterator[dict[str, Any]]:
        stack = self._depth_stack()
        depth = len(stack)
        index = next(self._seq)
        parent = stack[-1] if stack else None
        call = stack[0] if stack else index
        stack.append(index)
        annotation = None
        if hot and _profiler_recording():
            annotation = torch.profiler.record_function(name)
            annotation.__enter__()
        # stamped after the annotation opens: its start is the kineto
        # event's, less the annotation's own entry
        t0_us = self._now_us()
        t0 = time.perf_counter()
        try:
            if profile_dir is not None:
                with trace_to(profile_dir):
                    yield args
            else:
                yield args
        finally:
            dur_s = time.perf_counter() - t0
            if annotation is not None:
                annotation.__exit__(None, None, None)
            stack.pop()
            ev = SpanEvent(
                name=name,
                ts_us=t0_us,
                dur_us=dur_s * 1e6,
                tid=threading.get_ident(),
                depth=depth,
                args=args,
                index=index,
                parent=parent,
                call=call,
            )
            with self._lock:
                if len(self._events) == self._max_events:
                    self._dropped += 1  # deque evicts the oldest span
                self._events.append(ev)
            reg = self._registry if self._registry is not None else get_registry()
            reg.histogram(
                "span_seconds",
                "wall time of named host-side spans",
                labelnames=("span",),
            ).labels(span=name).observe(dur_s)

    @property
    def events(self) -> list[SpanEvent]:
        with self._lock:
            return list(self._events)

    def tail(self, n: int) -> list[SpanEvent]:
        """The newest ``n`` spans (oldest-first), without copying the whole
        ring — the flight recorder reads this once per round."""
        with self._lock:
            it = itertools.islice(reversed(self._events), max(n, 0))
            return list(it)[::-1]

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def to_chrome(self) -> dict[str, Any]:
        """Chrome trace-event JSON object (Perfetto-loadable)."""
        pid = os.getpid()
        events = [
            {
                "name": ev.name,
                "ph": "X",
                "ts": ev.ts_us,
                "dur": ev.dur_us,
                "pid": pid,
                "tid": ev.tid,
                "args": {**ev.args, "depth": ev.depth, "parent": ev.parent,
                         "call": ev.call},
            }
            for ev in self.events
        ]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str | Path) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_chrome(), default=float))


_default_tracer = Tracer()


def get_tracer() -> Tracer:
    return _default_tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-default tracer; returns the previous one."""
    global _default_tracer
    prev = _default_tracer
    _default_tracer = tracer
    return prev


def span(name: str, profile_dir: str | None = None, *, hot: bool = False, **args: Any):
    """``with span("solve/compile"):`` on the process-default tracer;
    ``hot=True`` for a site that runs every round (:meth:`Tracer.span`)."""
    return _default_tracer.span(name, profile_dir, hot=hot, **args)
