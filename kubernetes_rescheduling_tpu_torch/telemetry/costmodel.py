"""Compiled-cost book and device-memory accounting — the port of
``kubernetes_rescheduling_tpu.telemetry.costmodel``.

The JAX package asks XLA what it compiled (``cost_analysis``,
``memory_analysis``) at the first compile of each instrumented kernel. A
captured CUDA graph has no such report, so the port records at the first
capture of each graph in ``solver/compiled.py``'s cache what CUDA and
torch expose:

- ``argument_bytes`` / ``output_bytes``: the ``nbytes`` of the captured
  inputs and operands, and of the outputs;
- ``temp_bytes``: the memory the capture reserved (the caching allocator's
  ``memory_reserved`` before and after it — the graph's pool);
- ``flops`` / ``bytes_accessed``: the work of the kernels the body
  launched, from the per-launch formulas of ``ops/work.py`` (the ones
  ``chip_smoke.py``'s bounds use) summed over the capture's launches. Work
  of the body's plain torch ops (gathers, the input cost, the
  re-evaluation) is not counted: torch reports none of it.

Missing against XLA: ``generated_code_bytes`` (a graph's kernels are the
shared libraries' code; nothing is generated per capture), and any cost of
an eager body (the greedy decide runs op by op; it has no entry, as a
``controller_decide`` has one in the JAX package). On the CPU nothing is
captured, so the book stays empty.

The gauges are the port's (the JAX package's names, left; the port's,
right):

    jax_cost_flops                cuda_graph_flops
    jax_cost_bytes_accessed       cuda_graph_bytes_accessed
    jax_hbm_argument_bytes        cuda_graph_argument_bytes
    jax_hbm_output_bytes          cuda_graph_output_bytes
    jax_hbm_temp_bytes            cuda_graph_temp_bytes
    jax_hbm_generated_code_bytes  (none)
    jax_cost_captures_total       cuda_graph_cost_captures_total
    jax_achieved_flops_per_s      cuda_graph_achieved_flops_per_s
    jax_achieved_bytes_per_s      cuda_graph_achieved_bytes_per_s
    jax_arithmetic_intensity      cuda_graph_arithmetic_intensity
    device_hbm_bytes_in_use       device_hbm_bytes_in_use
    device_hbm_peak_bytes_in_use  device_hbm_peak_bytes_in_use

:func:`sample_device_memory` reads the caching allocator's counters
(``torch.cuda.memory_allocated`` / ``max_memory_allocated``: host-side
bookkeeping, no device work). Everything is best-effort: a failed record
never takes down the loop it describes.
"""

from __future__ import annotations

import threading
from typing import Any, Mapping

from kubernetes_rescheduling_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    get_registry,
)

# one row per recorded field: (field, gauge, help)
COST_GAUGES: tuple[tuple[str, str, str], ...] = (
    ("flops", "cuda_graph_flops",
     "operations of the captured graph's kernels (ops/work.py formulas x launches)"),
    ("bytes_accessed", "cuda_graph_bytes_accessed",
     "bytes the captured graph's kernels must move (ops/work.py formulas x launches)"),
    ("argument_bytes", "cuda_graph_argument_bytes",
     "device memory of the captured graph's inputs and operands"),
    ("output_bytes", "cuda_graph_output_bytes",
     "device memory of the captured graph's outputs"),
    ("temp_bytes", "cuda_graph_temp_bytes",
     "device memory the capture reserved (the graph's pool)"),
)


class CostBook:
    """Process-wide cost snapshots of captured graphs, keyed by fn label.

    The book outlives any one registry: tests and the bench harness swap
    registries mid-process while a graph is captured once, so the ops
    plane's ``/metrics`` render republishes the gauges from the book into
    the registry it renders (:func:`republish_book`)."""

    def __init__(self) -> None:
        self._snaps: dict[str, dict[str, float]] = {}
        self._lock = threading.Lock()

    def record(self, fn_label: str, snap: Mapping[str, float]) -> None:
        with self._lock:
            self._snaps[fn_label] = dict(snap)

    def get(self, fn_label: str) -> dict[str, float] | None:
        with self._lock:
            snap = self._snaps.get(fn_label)
            return dict(snap) if snap is not None else None

    def labels(self) -> list[str]:
        with self._lock:
            return sorted(self._snaps)

    def as_dict(self) -> dict[str, dict[str, float]]:
        """fn label -> cost snapshot (the manifest / bundle surface)."""
        with self._lock:
            return {k: dict(v) for k, v in sorted(self._snaps.items())}

    def clear(self) -> None:
        with self._lock:
            self._snaps.clear()


_default_book = CostBook()


def get_costbook() -> CostBook:
    return _default_book


def graph_cost(inputs: Mapping, operands, outputs: Mapping, *, ops: float,
               nbytes: float, temp_bytes: float) -> dict[str, float]:
    """The cost snapshot of one capture: its tensors' sizes, the kernels'
    work and the pool it reserved."""
    def size(ts) -> float:
        return float(sum(t.numel() * t.element_size() for t in ts if t is not None))

    return {
        "flops": float(ops),
        "bytes_accessed": float(nbytes),
        "argument_bytes": size(inputs.values()) + size(operands),
        "output_bytes": size(outputs.values()),
        "temp_bytes": float(temp_bytes),
    }


def record_capture(fn_label: str, snap: Mapping[str, float],
                   registry: MetricsRegistry | None = None) -> bool:
    """Record ``snap`` for ``fn_label`` at its first capture (later
    captures of the label — other shapes — keep the first), count it and
    publish the gauges. Returns whether it was recorded."""
    book = get_costbook()
    if book.get(fn_label) is not None:
        return False
    book.record(fn_label, snap)
    reg = registry if registry is not None else get_registry()
    reg.counter(
        "cuda_graph_cost_captures_total",
        "compiled-cost snapshots recorded (once per captured fn)",
        labelnames=("fn",),
    ).labels(fn=fn_label).inc()
    publish_cost_gauges(reg, fn_label, snap)
    return True


def publish_cost_gauges(registry: MetricsRegistry, fn_label: str,
                        snap: Mapping[str, float]) -> None:
    for field, gauge, help_ in COST_GAUGES:
        registry.gauge(gauge, help_, labelnames=("fn",)).labels(fn=fn_label).set(
            float(snap.get(field, 0.0)))


def republish(fn_label: str, registry: MetricsRegistry | None = None) -> bool:
    """Re-set the cost gauges of one fn from the book into ``registry`` (the
    current default when None), without re-recording."""
    snap = get_costbook().get(fn_label)
    if snap is None:
        return False
    publish_cost_gauges(registry if registry is not None else get_registry(), fn_label, snap)
    return True


def republish_book(registry: MetricsRegistry) -> None:
    """Re-set every recorded fn's cost gauges into ``registry``: the ops
    plane's ``/metrics`` render, so a registry swapped in after a capture
    still shows the book."""
    for label in get_costbook().labels():
        republish(label, registry)


def publish_roofline(registry: MetricsRegistry, fn_label: str,
                     seconds: float) -> dict[str, float] | None:
    """Achieved operations/s and bytes/s of one fenced execution of
    ``fn_label`` against its recorded cost, and its arithmetic intensity.
    None without a snapshot or a usable timing. The timing is the loop's
    per-round decision latency, host clock included: a lower bound on the
    device's rate, honest for trends."""
    if seconds <= 0:
        return None
    snap = get_costbook().get(fn_label)
    if snap is None:
        return None
    flops = snap.get("flops", 0.0)
    nbytes = snap.get("bytes_accessed", 0.0)
    out = {
        "achieved_flops_per_s": flops / seconds,
        "achieved_bytes_per_s": nbytes / seconds,
        "arithmetic_intensity": flops / nbytes if nbytes > 0 else 0.0,
    }
    registry.gauge(
        "cuda_graph_achieved_flops_per_s",
        "achieved operations/s of the last fenced round (recorded work / latency)",
        labelnames=("fn",),
    ).labels(fn=fn_label).set(out["achieved_flops_per_s"])
    registry.gauge(
        "cuda_graph_achieved_bytes_per_s",
        "achieved bytes/s of the last fenced round (recorded bytes / latency)",
        labelnames=("fn",),
    ).labels(fn=fn_label).set(out["achieved_bytes_per_s"])
    registry.gauge(
        "cuda_graph_arithmetic_intensity",
        "captured graph's kernels' operations per byte",
        labelnames=("fn",),
    ).labels(fn=fn_label).set(out["arithmetic_intensity"])
    return out


def sample_device_memory(registry: MetricsRegistry | None = None) -> list[dict[str, Any]]:
    """Each CUDA device's allocator counters as gauges (``memory_allocated``
    and ``max_memory_allocated``: host bookkeeping, no device work); returns
    what was sampled. Without a card: nothing."""
    import torch

    if not torch.cuda.is_available():
        return []
    reg = registry if registry is not None else get_registry()
    samples: list[dict[str, Any]] = []
    for i in range(torch.cuda.device_count()):
        try:
            in_use = torch.cuda.memory_allocated(i)
            peak = torch.cuda.max_memory_allocated(i)
        except Exception:  # noqa: BLE001 — an optional surface
            continue
        label = f"cuda:{i}"
        reg.gauge("device_hbm_bytes_in_use", "live device memory in use (allocator counter)",
                  labelnames=("device",)).labels(device=label).set(float(in_use))
        reg.gauge("device_hbm_peak_bytes_in_use",
                  "peak device memory in use (allocator counter)",
                  labelnames=("device",)).labels(device=label).set(float(peak))
        samples.append({"device": label, "bytes_in_use": in_use, "peak_bytes_in_use": peak})
    return samples


def observe_round_device(registry: MetricsRegistry | None = None, *,
                         fn_labels: tuple[str, ...] = (), seconds: float = 0.0) -> None:
    """The loop's once-a-round hook (its host tail): sample device memory
    and publish the roofline of the first candidate label with a recorded
    cost (which graph ran depends on the algorithm; the caller passes the
    candidates in preference order)."""
    reg = registry if registry is not None else get_registry()
    sample_device_memory(reg)
    for label in fn_labels:
        if publish_roofline(reg, label, seconds) is not None:
            break
