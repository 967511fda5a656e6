"""Arithmetic the per-layer readers share."""

from __future__ import annotations

import importlib


def mean_bound_s(kernel: str, launches) -> float:
    """A launch's bound, averaged over a round's launches of ``kernel``:
    ``launches`` lists ``(shape, launches a round)``."""
    count = importlib.import_module(f"perfbench.counts.{kernel}")
    total = sum(n for _, n in launches)
    return sum(n * count.bound_ms(**shape) for shape, n in launches) / total * 1e-3


def roofline_pct(run, kernels) -> float | None:
    """Σ over the traced launches of ``kernels`` of each launch's bound over
    Σ of their measured device time, in percent; None when the trace holds
    none of them or the driver gave no shapes for them. A kernel launched
    at several shapes a round counts each launch at the round's mean."""
    bound = measured = 0.0
    for k in kernels:
        if run.trace is None or k not in run.trace.kernels or not run.kernel_shapes.get(k):
            continue
        n, seconds = run.trace.kernels[k]
        bound += n * mean_bound_s(k, run.kernel_shapes[k])
        measured += seconds
    return 100.0 * bound / measured if measured > 0 else None

