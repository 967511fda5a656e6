"""Where one global rescheduling round spends its time on the card.

    python -m kubernetes_rescheduling_tpu_torch.bench.profile [--scenario large]
    python -m kubernetes_rescheduling_tpu_torch.bench.profile --scenario sparse50k

``sparse50k`` is the sparse solver on ``sparse_problem(50_000, 2_000)``;
every other scenario is the dense solver on ``make_backend``. Runs the
default-config solve once to warm up, then once more under
``torch.profiler`` (CPU and CUDA activities), and prints one JSON object:
the wall time of the profiled solve, the summed device time of its kernels,
the device's idle share of the wall time, the launch count, and the
kernels that took the most device time. A third solve runs under
PyTorch's sync debug mode and reports where the host waited for the device
(``file:line`` of each synchronizing call site; the mode does not catch
every kind of sync). Needs a CUDA device.
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


def profile_round(scenario: str = "large", seed: int = 0, top: int = 16) -> dict:
    from torch.profiler import ProfilerActivity, profile

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
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
    ]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        agg = by_name.setdefault(e.name, [0, 0.0])
        agg[0] += 1
        agg[1] += e.device_time_total / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]

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
        "device": torch.cuda.get_device_name(0),
        "wall_ms": wall_ms,
        "device_kernel_ms": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "kernel_launches": len(kernels),
        "top_kernels": [
            {"name": name[:120], "launches": n, "ms": ms} for name, (n, ms) in ranked
        ],
        "host_syncs": sum(sync_sites.values()),
        "sync_sites": sync_sites,
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scenario", default="large", choices=SCENARIOS + tuple(SPARSE_SCENARIOS))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    print(json.dumps(profile_round(args.scenario, args.seed)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
