"""What the per-layer readers of the program's own record share: host
spans from the port's tracer, solve phase times and capture seconds from
its registry. Each returns None when the program recorded nothing, as a
program without these spans and counters records nothing."""

from __future__ import annotations

from kubernetes_rescheduling_tpu_torch.telemetry.registry import get_registry
from kubernetes_rescheduling_tpu_torch.telemetry.spans import get_tracer

# the port's streaming entries, one a cell, as the capture cache names them
ENTRIES = ("replay_on_device", "replay_on_device_sparse")


def span_self_ms_a_step(name: str) -> float | None:
    """Self ms a step of the spans named ``name``: each span's duration
    less the part its child spans cover, summed over the window and
    divided by the steps the ``replay/call`` spans ran."""
    events = get_tracer().events
    steps = sum(int(e.args.get("steps", 0)) for e in events if e.name == "replay/call")
    spans = [e for e in events if e.name == name]
    if steps <= 0 or not spans:
        return None
    child_us: dict[int, float] = {}
    for e in events:
        if e.parent is not None:
            child_us[e.parent] = child_us.get(e.parent, 0.0) + e.dur_us
    total_us = sum(e.dur_us - child_us.get(e.index, 0.0) for e in spans)
    return total_us / steps / 1e3


def _series(registry, metric: str) -> list[dict]:
    return [r for r in registry.snapshot() if r["metric"] == metric]


def phase_ms_a_round(phase: str) -> float | None:
    """Device ms a round of one solve phase in the cell's entry: the
    program's ``solve_phase_device_seconds_total`` over its
    ``solve_phase_rounds_total``, after the program reads what is still
    pending (the harness has synchronized by then)."""
    try:  # a program without phase marks has no such module
        from kubernetes_rescheduling_tpu_torch.telemetry import phases
    except ImportError:
        return None
    registry = get_registry()
    phases.flush(registry)
    rounds = {r["labels"]["fn"]: r["value"] for r in _series(registry, "solve_phase_rounds_total")
              if r["labels"].get("fn") in ENTRIES and r["value"] > 0}
    if not rounds:
        return None
    fn = max(rounds, key=rounds.get)
    seconds = [r["value"] for r in _series(registry, "solve_phase_device_seconds_total")
               if r["labels"].get("fn") == fn and r["labels"].get("phase") == phase]
    if not seconds:
        return None
    return seconds[0] / rounds[fn] * 1e3


def capture_seconds() -> float | None:
    """Seconds of the capture cache's misses over every fn, the run's
    set-up included."""
    values = [r["value"] for r in _series(get_registry(), "cuda_graph_capture_seconds_total")]
    return float(sum(values)) if values else None
