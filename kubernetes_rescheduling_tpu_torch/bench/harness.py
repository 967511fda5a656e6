"""Scenario factory — the port of ``make_backend`` from
``kubernetes_rescheduling_tpu.bench.harness`` (the reference's µBench
cluster and the synthetic meshes up to ``xlarge``), and of ``bench.py``'s
sparse problem (:func:`sparse_problem`).

Same ``default_rng(seed)`` call sequence as the JAX package: one seed
builds the identical cluster in both packages.
"""

from __future__ import annotations

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
