"""Where one global rescheduling round spends its time on the card.

    python -m kubernetes_rescheduling_tpu_torch.bench.profile [--scenario large]
    python -m kubernetes_rescheduling_tpu_torch.bench.profile --scenario sparse50k

``sparse50k`` is the sparse solver on ``sparse_problem(50_000, 2_000)``;
every other scenario is the dense solver on ``make_backend``. Runs the
default-config solve once to warm up, then once more under
``torch.profiler`` (CPU and CUDA activities), and prints one JSON object:
the wall time of the profiled solve, the summed device time of its kernels,
the device's busy time (the union of its operations' intervals: kernels
that overlap count once) and idle share of the wall time, the launch
count, and the kernels that took the most device time. A third solve runs under
PyTorch's sync debug mode and reports where the host waited for the device
(``file:line`` of each synchronizing call site; the mode does not catch
every kind of sync). Needs a CUDA device.

    python -m kubernetes_rescheduling_tpu_torch.bench.profile --algorithm communication
    python -m kubernetes_rescheduling_tpu_torch.bench.profile --algorithm global [--solver-backend sparse]

``--algorithm`` profiles controller rounds instead (``run_controller``'s
sequential schedule on the scenario, every pod piled on its first node for
a greedy algorithm): one round to warm up, then ``--rounds`` rounds under
the profiler, with the same device figures and each round's phase times.
"""

from __future__ import annotations

import argparse
import json
import time
import warnings

import torch

from kubernetes_rescheduling_tpu_torch.bench.harness import SCENARIOS, make_backend, sparse_problem
from kubernetes_rescheduling_tpu_torch.solver import (
    GlobalSolverConfig,
    global_assign,
    global_assign_sparse,
)
from kubernetes_rescheduling_tpu_torch.solver.global_solver import prepare_weights

SPARSE_SCENARIOS = {"sparse50k": (50_000, 2_000)}


def union_length(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals: time covered
    by at least one of them."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def device_kernels(events) -> list:
    """The profiler's events that are device work: on the card, with
    device time, and not a user annotation (a ``record_function`` span,
    such as the port's hot spans, is mirrored on the card's timeline over
    the work it launched)."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
            and not e.is_user_annotation]


def _trace(fn, top: int) -> dict:
    """``fn()`` under ``torch.profiler``: wall ms (ending in a synchronize),
    device kernel ms, the device's busy ms and idle share, and the busiest
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof.events())
    device_ms = sum(e.device_time_total for e in kernels) / 1e3
    busy_ms = union_length([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        agg = by_name.setdefault(e.name, [0, 0.0])
        agg[0] += 1
        agg[1] += e.device_time_total / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "device": torch.cuda.get_device_name(0),
        "wall_ms": wall_ms,
        "device_kernel_ms": device_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches": len(kernels),
        "top_kernels": [
            {"name": name[:120], "launches": n, "ms": ms} for name, (n, ms) in ranked
        ],
    }


def profile_loop(algorithm: str, scenario: str = "large", seed: int = 0,
                 solver_backend: str = "dense", rounds: int = 3, top: int = 16) -> dict:
    """Controller rounds on the card: one to warm up (the sparse form's
    build, first launches), then ``rounds`` under the profiler."""
    from kubernetes_rescheduling_tpu_torch.bench.controller import _Runtime
    from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig
    from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry

    backend = make_backend(scenario, seed, device="cuda")
    if algorithm != "global":
        backend.inject_imbalance(backend.node_names[0])
    cfg = RescheduleConfig(algorithm=algorithm, max_rounds=rounds + 1, sleep_after_action_s=0.0,
                           seed=seed, solver_backend=solver_backend).validate()
    rt = _Runtime(backend, cfg, device=torch.device("cuda"), registry=MetricsRegistry(),
                  gumbel_rows=None, solver_plans=None)
    rt.sequential_round(1)

    def run():
        for rnd in range(2, rounds + 2):
            rt.sequential_round(rnd)

    out = {"scenario": scenario, "algorithm": algorithm, "solver_backend": solver_backend,
           "rounds": rounds, **_trace(run, top)}
    out["phase_ms"] = [{k: v * 1e3 for k, v in r.phase_s.items()} for r in rt.result.rounds[1:]]
    out["round_wall_ms"] = [r.wall_s * 1e3 for r in rt.result.rounds[1:]]
    return out


def profile_round(scenario: str = "large", seed: int = 0, top: int = 16) -> dict:
    cfg = GlobalSolverConfig()
    if scenario in SPARSE_SCENARIOS:
        state, sgraph = sparse_problem(*SPARSE_SCENARIOS[scenario], seed=seed, device="cuda")

        def solve():
            return global_assign_sparse(state, sgraph, torch.Generator().manual_seed(seed), cfg)
    else:
        backend = make_backend(scenario, seed, device="cuda")
        state, graph = backend.monitor(), backend.comm_graph()
        w_mm = prepare_weights(state, graph, cfg)

        def solve():
            return global_assign(state, graph, torch.Generator().manual_seed(seed), cfg,
                                 w_mm=w_mm)

    solve()
    traced = _trace(solve, top)

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            solve()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync_sites: dict[str, int] = {}
    for w in caught:
        if "synchroniz" in str(w.message).lower():
            site = f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
            sync_sites[site] = sync_sites.get(site, 0) + 1
    return {
        "scenario": scenario,
        **traced,
        "host_syncs": sum(sync_sites.values()),
        "sync_sites": sync_sites,
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scenario", default="large", choices=SCENARIOS + tuple(SPARSE_SCENARIOS))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--algorithm", default=None,
                   help="profile controller rounds of this algorithm instead of a solve")
    p.add_argument("--solver-backend", default="dense", choices=["dense", "sparse"])
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    if args.algorithm is not None:
        out = profile_loop(args.algorithm, args.scenario, args.seed, args.solver_backend,
                           args.rounds)
    else:
        out = profile_round(args.scenario, args.seed)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
