"""Latency-budget autotuning — the port of
``kubernetes_rescheduling_tpu.solver.autotune``: spend a time budget, not
a sweep count.

Measure the per-sweep device cost of this config at this problem size on
this card, then pick the sweep count that fills a ``--latency-budget``
(default 100 ms, the per-round limit of PERF.md §2).

Measurement, as in the JAX package: the per-sweep cost is a double slope.
Chained solves — each solve's output state the next one's input, with no
host read between them — separate device time from dispatch; differencing
two sweep counts separates the per-sweep cost from the per-round fixed
cost (objective epilogue, W build, pod scatter). On the card each solve of
a chain is one replay of its captured graph (``solver/compiled.py``, the
counterpart of the JAX package's jitted ``lax.scan``) and a chain is timed
with CUDA events; on the CPU the same chain runs eagerly under the host
clock. Each chained solve draws its plans from the generator of ``(seed,
i)`` (``_random.round_generator``), where the JAX package folds ``i`` into
its key.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from kubernetes_rescheduling_tpu_torch._random import round_generator
from kubernetes_rescheduling_tpu_torch.solver.global_solver import (
    GlobalSolverConfig,
    global_assign,
)


def _chain(solver, state, graph, config, k: int, seed: int):
    """``k`` solves, each on the previous one's state; returns the last
    objective (a device scalar: nothing is read here)."""
    st, obj = state, None
    for i in range(k):
        st, info = solver(st, graph, round_generator(seed, i), config)
        obj = info["objective_after"]
    return obj


def _device_ms_per_round(solver, state, graph, config, k1=2, k2=8):
    """Slope-method device latency of one solver round (min of 2 reps)."""
    cuda = state.device.type == "cuda"

    def timed(k):
        float(_chain(solver, state, graph, config, k, 7))  # capture + warm
        best = float("inf")
        for rep in range(2):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                _chain(solver, state, graph, config, k, 8 + rep)
                end.record()
                end.synchronize()  # completion fence
                ms = start.elapsed_time(end)
            else:
                t = time.perf_counter()
                float(_chain(solver, state, graph, config, k, 8 + rep))  # completion fence
                ms = (time.perf_counter() - t) * 1e3
            best = min(best, ms)
        return best

    return (timed(k2) - timed(k1)) / (k2 - k1)


def tune_sweeps(
    state,
    graph,
    config: GlobalSolverConfig,
    budget_ms: float,
    *,
    solver=global_assign,
    lo: int = 3,
    hi: int = 9,
    max_sweeps: int = 64,
) -> tuple[GlobalSolverConfig, dict]:
    """Pick the sweep count that fills ``budget_ms`` of device time.

    Returns ``(tuned_config, info)`` where info carries the measured
    per-sweep and fixed costs so the decision is auditable. ``solver`` is
    the round function to measure, ``solver(state, graph, generator,
    config) -> (state, info)``: ``global_assign`` (default) or a sparse or
    per-pod wrapper with the same signature.
    """
    if budget_ms <= 0:
        raise ValueError(f"latency budget must be > 0 ms, got {budget_ms}")
    d_lo = _device_ms_per_round(solver, state, graph, dataclasses.replace(config, sweeps=lo))
    d_hi = _device_ms_per_round(solver, state, graph, dataclasses.replace(config, sweeps=hi))
    per_sweep = max((d_hi - d_lo) / (hi - lo), 1e-3)
    fixed = max(d_lo - lo * per_sweep, 0.0)
    sweeps = int((budget_ms - fixed) // per_sweep)
    sweeps = max(1, min(max_sweeps, sweeps))
    info = {
        "budget_ms": float(budget_ms),
        "per_sweep_ms": round(per_sweep, 3),
        "fixed_ms": round(fixed, 3),
        "measured_lo": (lo, round(d_lo, 3)),
        "measured_hi": (hi, round(d_hi, 3)),
        "sweeps": sweeps,
        "predicted_round_ms": round(fixed + sweeps * per_sweep, 3),
    }
    return dataclasses.replace(config, sweeps=sweeps), info
