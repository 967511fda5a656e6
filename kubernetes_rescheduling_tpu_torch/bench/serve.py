"""The serving soak — the port of ``kubernetes_rescheduling_tpu.bench.serve``:
drive a :class:`~serving.ServingEngine` with an open-loop arrival process and
account for every request exactly.

Each request gets its own submitting thread, released at its
:func:`~bench.loadgen.open_loop_arrivals` offset (submission never waits on
completion), and the returned block carries the identity the soak tests
pin::

    placed + no_candidate + shed + timed_out == submitted

The latency percentiles are this soak's completed requests only.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Sequence

import numpy as np


def run_serve_soak(engine, services: Sequence[str], arrivals: Sequence[float], *,
                   deadline_ms: float | None = None) -> dict[str, Any]:
    """Submit ``len(arrivals)`` requests open-loop (request ``i`` at offset
    ``arrivals[i]`` seconds, services round-robin) and block until every
    outcome lands. Returns the accounting and latency block; raises
    ``RuntimeError`` if the accounting identity fails (a lost or
    double-counted request is a bug, never a reading)."""
    if not services:
        raise ValueError("run_serve_soak needs at least one service name")
    n = len(arrivals)
    results: list[Any] = [None] * n
    start = time.perf_counter()

    def submit(i: int) -> None:
        delay = float(arrivals[i]) - (time.perf_counter() - start)
        if delay > 0:
            time.sleep(delay)
        results[i] = engine.place(services[i % len(services)], deadline_ms=deadline_ms)

    threads = [threading.Thread(target=submit, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - start

    outcomes: dict[str, int] = {}
    shed_reasons: dict[str, int] = {}
    totals_ms: list[float] = []
    for r in results:
        outcomes[r.outcome] = outcomes.get(r.outcome, 0) + 1
        if r.shed_reason is not None:
            shed_reasons[r.shed_reason] = shed_reasons.get(r.shed_reason, 0) + 1
        if r.outcome in ("placed", "no_candidate"):
            totals_ms.append(r.timings_ms["total"])
    placed = outcomes.get("placed", 0)
    answered = placed + outcomes.get("no_candidate", 0)
    shed = outcomes.get("shed", 0)
    timed_out = outcomes.get("timeout", 0)
    if answered + shed + timed_out != n:
        raise RuntimeError(
            f"serving accounting violated: placed+no_candidate={answered} + shed={shed} "
            f"+ timeout={timed_out} != submitted={n}"
        )
    q = np.percentile(np.asarray(totals_ms), [50, 95, 99]) if totals_ms else (0.0, 0.0, 0.0)
    return {
        "submitted": n,
        "outcomes": outcomes,
        "shed_reasons": shed_reasons,
        "placed": placed,
        "answered": answered,
        "shed": shed,
        "timed_out": timed_out,
        "wall_s": wall_s,
        "placements_per_sec": placed / wall_s if wall_s > 0 else 0.0,
        "p50_ms": float(q[0]),
        "p95_ms": float(q[1]),
        "p99_ms": float(q[2]),
        "results": results,
    }
