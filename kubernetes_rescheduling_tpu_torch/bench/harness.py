"""Scenario factory — the port of ``make_backend`` from
``kubernetes_rescheduling_tpu.bench.harness`` (the reference's µBench
cluster and the synthetic meshes up to ``xlarge``), of ``bench.py``'s
sparse problem (:func:`sparse_problem`) and of its fleet problem
(:func:`make_fleet_problem`), the forecast plane's head-to-head cell
(:func:`run_forecast_headtohead`) and the chaos soak cell
(:func:`run_chaos_soak`).

Same ``default_rng(seed)`` call sequence as the JAX package: one seed
builds the identical cluster in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE
from kubernetes_rescheduling_tpu_torch.backends.sim import LoadModel, SimBackend
from kubernetes_rescheduling_tpu_torch.core.sparsegraph import from_workmodel
from kubernetes_rescheduling_tpu_torch.core.topology import _random_workmodel, state_from_workmodel
from kubernetes_rescheduling_tpu_torch.core.workmodel import Workmodel, mubench_workmodel_c

SCENARIOS = ("mubench", "dense", "powerlaw", "large", "xlarge")


def make_backend(
    scenario: str, seed: int, device: str | torch.device | None = DEFAULT_DEVICE,
    workmodel_path: str | None = None,
) -> SimBackend:
    """Scenario factory: ``mubench`` (the reference's 20 services on 3
    workers), ``dense`` (200 services × 20 nodes), ``powerlaw`` (2k × 200),
    ``large`` (the 10k × 1k north star) and ``xlarge`` (20k × 2k).
    ``workmodel_path`` swaps the scenario's topology for a µBench workmodel
    JSON, keeping its cluster shape and load model."""
    rng = np.random.default_rng(seed)
    override = Workmodel.from_file(workmodel_path) if workmodel_path is not None else None
    if scenario == "mubench":
        # reference cluster: 3 workers of 20 threads (README.md:44-46); the
        # load drives the cordon-induced pile-up on worker1 to ~85% CPU
        return SimBackend(
            workmodel=override or mubench_workmodel_c(),
            node_names=["worker1", "worker2", "worker3"],
            node_cpu_cap_m=20_000.0,
            seed=seed,
            load=LoadModel(entry_rps=100.0, cost_per_req_m=8.0, idle_m=50.0),
            device=device,
        )
    # synthetic meshes: fanout_frac ≈ 1/(mean forward out-degree) keeps the
    # expected request branching factor at ~1
    if scenario == "dense":
        return SimBackend(
            workmodel=override or _random_workmodel(200, rng, powerlaw=False, mean_degree=8.0),
            node_names=[f"worker{i:04d}" for i in range(20)],
            node_cpu_cap_m=20_000.0,
            seed=seed,
            load=LoadModel(idle_m=40.0, cost_per_req_m=5.0, fanout_frac=0.25),
            device=device,
        )
    if scenario == "powerlaw":
        return SimBackend(
            workmodel=override or _random_workmodel(2000, rng, powerlaw=True, mean_degree=4.0),
            node_names=[f"worker{i:04d}" for i in range(200)],
            node_cpu_cap_m=20_000.0,
            seed=seed,
            load=LoadModel(fanout_frac=0.5),
            device=device,
        )
    if scenario == "large":
        return SimBackend(
            workmodel=override or _random_workmodel(10_000, rng, powerlaw=True, mean_degree=4.0),
            node_names=[f"worker{i:04d}" for i in range(1000)],
            node_cpu_cap_m=2_000.0,
            seed=seed,
            load=LoadModel(
                entry_rps=10.0, cost_per_req_m=0.1, idle_m=50.0, fanout_frac=0.5
            ),
            device=device,
        )
    if scenario == "xlarge":
        # 2× the north star on both axes
        return SimBackend(
            workmodel=override or _random_workmodel(20_000, rng, powerlaw=True, mean_degree=4.0),
            node_names=[f"worker{i:04d}" for i in range(2000)],
            node_cpu_cap_m=2_000.0,
            seed=seed,
            load=LoadModel(
                entry_rps=10.0, cost_per_req_m=0.05, idle_m=50.0, fanout_frac=0.5
            ),
            device=device,
        )
    raise ValueError(f"unknown scenario {scenario!r} (known: {', '.join(SCENARIOS)})")


def sparse_problem(
    n_services: int, n_nodes: int, seed: int = 0,
    device: str | torch.device | None = DEFAULT_DEVICE,
):
    """Power-law mesh past the dense form's sizing wall, built straight
    into the block-local sparse form (the JAX package's ``bench.py``
    ``_sparse_problem``; ``sparse_problem(50_000, 2_000)`` is its
    ``sparse50k``): mean degree 4, ``n_nodes`` nodes of 5000 m CPU.
    Returns ``(state, sparse_graph)``."""
    rng = np.random.default_rng(seed)
    wm = _random_workmodel(n_services, rng, powerlaw=True, mean_degree=4.0)
    graph = from_workmodel(wm, device=device)
    state = state_from_workmodel(
        wm,
        node_names=[f"w{i:05d}" for i in range(n_nodes)],
        node_cpu_cap_m=5_000.0,
        seed=seed,
        device=device,
    )
    return state, graph


def make_fleet_problem(
    tenants: int = 16, n_services: int = 2000, n_nodes: int = 256, seed: int = 0,
    device: str | torch.device | None = DEFAULT_DEVICE,
):
    """The JAX package's fleet bench problem: N same-shaped power-law
    tenants, tenant ``t`` built from seed ``seed*1000 + t`` over an
    identical cluster shape (``n_nodes`` nodes of 2000 m CPU). Returns
    ``(states, graphs)``, index-aligned lists."""
    states, graphs = [], []
    for t in range(tenants):
        rng = np.random.default_rng(seed * 1000 + t)
        wm = _random_workmodel(n_services, rng, powerlaw=True, mean_degree=4.0)
        graphs.append(wm.comm_graph(device=device))
        states.append(state_from_workmodel(
            wm, node_names=[f"w{i:03d}" for i in range(n_nodes)], node_cpu_cap_m=2_000.0,
            seed=seed * 1000 + t, device=device,
        ))
    return states, graphs


def run_forecast_headtohead(
    profiles: tuple[str, ...] = ("diurnal-autoscale", "deploy-waves"),
    rounds: int = 40,
    *,
    scenario: str = "dense",
    seed: int = 1,
    churn_seed: int = 7,
    load_noise_frac: float = 0.05,
    forecast=None,
    logger_factory=None,
    registry=None,
    device: str | torch.device | None = DEFAULT_DEVICE,
) -> dict:
    """The forecast plane's cell: ``proactive`` against reactive CAR on
    identically seeded churned clusters, one pair per churn profile.

    Both arms get the same backend, imbalance, churn stream (profile and
    seed), metric-reading noise (``load_noise_frac``: per-pod gaussian
    noise in the simulator's monitor, the regime where the differenced
    model has an edge over persistence) and round seed; only the algorithm
    differs. Returns per profile each arm's mean and final communication
    cost, mean load std, round and move counts, and the proactive arm's
    last forecast block; ``_records`` holds the records."""
    from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller
    from kubernetes_rescheduling_tpu_torch.config import ForecastConfig, RescheduleConfig

    out: dict = {"rounds": rounds, "scenario": scenario, "profiles": {}}
    for profile in profiles:
        arms: dict[str, dict] = {}
        for algo in ("proactive", "communication"):
            backend = make_backend(scenario, seed, device=device)
            if load_noise_frac:
                backend.load = dataclasses.replace(backend.load, noise_frac=load_noise_frac)
            backend.inject_imbalance(backend.node_names[0])
            cfg = RescheduleConfig(
                algorithm=algo, max_rounds=rounds, sleep_after_action_s=0.0, seed=seed,
                elastic=profile, elastic_seed=churn_seed,
                forecast=forecast if forecast is not None else ForecastConfig(),
            )
            logger = logger_factory() if logger_factory is not None else None
            result = run_controller(backend, cfg, device=device, logger=logger,
                                    registry=registry)
            costs = [r.communication_cost for r in result.rounds]
            arms[algo] = {
                "mean_communication_cost": float(np.mean(costs)) if costs else 0.0,
                "final_communication_cost": costs[-1] if costs else None,
                "mean_load_std": (float(np.mean([r.load_std for r in result.rounds]))
                                  if result.rounds else 0.0),
                "rounds": len(result.rounds),
                "skipped_rounds": result.skipped_rounds,
                "moves": result.moves,
                "forecast": next((r.forecast for r in reversed(result.rounds)
                                  if r.forecast is not None), None),
                "records": result.rounds,
            }
        pro, rea = arms["proactive"], arms["communication"]
        out["profiles"][profile] = {
            **{k: {kk: vv for kk, vv in v.items() if kk != "records"} for k, v in arms.items()},
            "proactive_vs_reactive_cost": (
                pro["mean_communication_cost"] / rea["mean_communication_cost"]
                if rea["mean_communication_cost"] > 0 else 1.0
            ),
            "_records": {k: v["records"] for k, v in arms.items()},
        }
    return out


def run_chaos_soak(
    profile: str = "soak",
    rounds: int = 30,
    *,
    scenario: str = "mubench",
    algorithm: str = "communication",
    seed: int = 0,
    chaos_seed: int = 0,
    max_consecutive_failures: int = 3,
    breaker_cooldown_rounds: int = 2,
    failure_budget_per_round: int = 2,
    retry=None,
    logger=None,
    registry=None,
    ops=None,
    device: str | torch.device | None = DEFAULT_DEVICE,
) -> dict:
    """The chaos soak cell: one seeded fault profile against one scenario
    (piled on its first node), with the loop's degraded-mode machinery on.

    The chaos wrapper is built here, not through ``config.chaos``, so the
    report can hold the wrapper's own ``fault_counts`` against the
    registry's ``chaos_faults_total``: every injected fault is counted,
    every round is accounted (``rounds == records + skipped_rounds``), and
    the loop finishes without raising. The run is one ``bench/chaos_soak``
    span. ``ops`` optionally attaches a live ops plane
    (``telemetry.server.OpsPlane``): ``/healthz`` watches the breaker open
    and recover, and an open transition dumps a flight-recorder bundle."""
    from kubernetes_rescheduling_tpu_torch.backends.chaos import with_chaos
    from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller
    from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig
    from kubernetes_rescheduling_tpu_torch.telemetry.spans import span
    from kubernetes_rescheduling_tpu_torch.utils.retry import RetryPolicy

    backend = make_backend(scenario, seed, device=device)
    backend.inject_imbalance(backend.node_names[0])
    chaos = with_chaos(backend, profile, seed=chaos_seed, registry=registry)
    cfg = RescheduleConfig(
        algorithm=algorithm,
        max_rounds=rounds,
        sleep_after_action_s=0.0,
        seed=seed,
        retry=retry if retry is not None else RetryPolicy(max_attempts=2, base_delay_s=0.05),
        max_consecutive_failures=max_consecutive_failures,
        breaker_cooldown_rounds=breaker_cooldown_rounds,
        failure_budget_per_round=failure_budget_per_round,
    )
    with span("bench/chaos_soak", profile=profile):
        result = run_controller(chaos, cfg, device=device, logger=logger, registry=registry,
                                ops=ops)
    fault_counts = dict(getattr(chaos, "fault_counts", {}))
    return {
        "profile": profile,
        "rounds": rounds,
        "records": len(result.rounds),
        "skipped_rounds": result.skipped_rounds,
        "degraded_rounds": result.degraded_rounds,
        "boundary_failures": result.boundary_failures,
        "moves": result.moves,
        "breaker_transitions": result.breaker_transitions,
        "breaker_opens": sum(1 for t in result.breaker_transitions if t["to"] == "open"),
        "breaker_closes": sum(1 for t in result.breaker_transitions if t["to"] == "closed"),
        "fault_counts": fault_counts,
        "faults_injected": sum(fault_counts.values()),
    }
