"""Timed phases inside a solve body, on the card and on the CPU.

A solve body calls :func:`phase_mark` at each phase boundary; the time
from one mark to the next is the earlier mark's phase, and :data:`END`
closes the last one. The replay bodies of ``bench/trace.py`` mark
``update`` (the weight scatter); ``dense_solve`` and ``sparse_solve``
mark the rest (``solver/global_solver.py``, ``solver/sparse_solver.py``):

- ``setup``: service aggregates, the pair or edge weights, the input's
  true objective, the first loads and ranking;
- ``hubs`` (sparse only): every hub group of a sweep;
- ``sweeps`` / ``swap_sweeps``: a sweep's chunk passes, the swap phases
  of a swap sweep included;
- ``ranking``: a sweep's load refresh and best-seen objective;
- ``epilogue``: exact re-evaluation, the adopt gate, the scatter back to
  pods and ``load_std``.

How a mark stamps depends on how the body runs (``solver/compiled.py``):

- captured as a CUDA graph: every capture records its marks, whatever
  tracing says, as ``torch.cuda.Event(enable_timing=True,
  external=True)`` made during the capture (the eager warm-up before it
  records none), event-record nodes of the graph (22 a dense replay,
  31 a sparse one at 9 sweeps). So the capture key does not depend on
  tracing, and turning tracing on recaptures nothing: it decides whether
  a replay's times are read. A traced replay's events stay pending until
  the next run of the same ``fn`` or :func:`flush`; each checks the last
  event with ``query()`` and never waits. Complete, the elapsed times go
  into ``solve_phase_device_seconds_total{fn,phase}`` and
  ``solve_phase_rounds_total{fn}``; not yet complete (its events about to
  be recorded again), ``solve_phase_unresolved_total{fn}`` counts it;
- on the CPU, while tracing: ``perf_counter_ns`` stamps, resolved when
  the body returns (the CPU runs it synchronously), into the same
  counters;
- eagerly on the card (``compiled.eager()``): not timed.

Off (no body being recorded on the calling thread), a mark is one check.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator

from kubernetes_rescheduling_tpu_torch.telemetry.registry import MetricsRegistry, get_registry

END = "end"

_local = threading.local()


def phase_mark(name: str) -> None:
    """Start phase ``name`` (or close the last, :data:`END`) in the body
    being recorded on this thread; nothing when none is."""
    marks = getattr(_local, "marks", None)
    if marks is not None:
        marks.mark(name)


class Marks:
    """The marks of one body: ``(phase, stamp)`` in order. ``clock`` is
    ``"host"`` (``perf_counter_ns``) or ``"graph"`` (external timing
    events, made during the capture and recorded again by every replay of
    the graph)."""

    def __init__(self, fn: str, clock: str) -> None:
        self.fn, self.clock = fn, clock
        self.names: list[str] = []
        self.stamps: list = []

    def mark(self, name: str) -> None:
        self.names.append(name)
        if self.clock == "host":
            self.stamps.append(time.perf_counter_ns())
            return
        import torch
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        self.stamps.append(ev)

    def seconds(self) -> dict[str, float]:
        """Phase → seconds between its marks and the next ones, summed;
        the span after an :data:`END` belongs to no phase."""
        out: dict[str, float] = {}
        for i, name in enumerate(self.names[:-1]):
            if name == END:
                continue
            a, b = self.stamps[i], self.stamps[i + 1]
            s = (b - a) * 1e-9 if self.clock == "host" else a.elapsed_time(b) * 1e-3
            out[name] = out.get(name, 0.0) + s
        return out

    def complete(self) -> bool:
        return self.clock == "host" or not self.stamps or self.stamps[-1].query()


@contextmanager
def recording(marks: Marks | None) -> Iterator[Marks | None]:
    """Record this thread's :func:`phase_mark` calls into ``marks`` (None:
    record nothing) inside the block."""
    prev = getattr(_local, "marks", None)
    _local.marks = marks
    try:
        yield marks
    finally:
        _local.marks = prev


_lock = threading.Lock()
_pending: dict[str, list[Marks]] = {}


def submit(marks: Marks) -> None:
    """Hold a traced run's marks until they can be read without a wait;
    host marks are read at once."""
    if marks.clock == "host":
        _publish(marks, get_registry())
        return
    with _lock:
        _pending.setdefault(marks.fn, []).append(marks)


def settle(fn: str, registry: MetricsRegistry | None = None) -> None:
    """Read ``fn``'s pending marks: those complete into the phase
    counters, the rest counted unresolved and dropped. Never waits."""
    if not _pending:
        return
    with _lock:
        held = _pending.pop(fn, None)
    if not held:
        return
    reg = registry if registry is not None else get_registry()
    for marks in held:
        if marks.complete():
            _publish(marks, reg)
        else:
            reg.counter(
                "solve_phase_unresolved_total",
                "traced solve replays whose phase events had not completed when read "
                "(the program never waits for them)",
                labelnames=("fn",),
            ).labels(fn=marks.fn).inc()


def flush(registry: MetricsRegistry | None = None) -> None:
    """Settle every fn's pending marks: for a caller that has synchronized
    the device (what is still running counts unresolved)."""
    with _lock:
        fns = list(_pending)
    for fn in fns:
        settle(fn, registry)


def _publish(marks: Marks, reg: MetricsRegistry) -> None:
    secs = reg.counter(
        "solve_phase_device_seconds_total",
        "seconds of each phase of traced solve bodies (device time on the card, "
        "host time on the CPU)",
        labelnames=("fn", "phase"),
    )
    for phase, s in marks.seconds().items():
        secs.labels(fn=marks.fn, phase=phase).inc(s)
    reg.counter(
        "solve_phase_rounds_total",
        "traced solve bodies whose phase times were read",
        labelnames=("fn",),
    ).labels(fn=marks.fn).inc()
