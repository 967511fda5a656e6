"""The solve contract every global solve shares (``solver/global_solver.py``):
the adopt gate ``adopt`` on its own, and the input's true objective that
the dense, sparse and node-sharded solves all compute through
``input_objective``.

The node-sharded solves run in a gloo group of one spawned process
(``parallel.launch.run_group``). This file imports no JAX."""

import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu_torch.core import sparsegraph as tsg
from kubernetes_rescheduling_tpu_torch.core import topology as ttopo
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState
from kubernetes_rescheduling_tpu_torch.parallel.launch import run_group
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs
from kubernetes_rescheduling_tpu_torch.solver import sparse_solver as tss

PKG = "kubernetes_rescheduling_tpu_torch"
GROUP_TIMEOUT_S = 120.0


def four_pods():
    """Three nodes; pods 0 and 1 on node 0, pod 2 on node 1, and pod 3, not
    valid, on node 2."""
    return ClusterState(
        node_cpu_cap=torch.full((3,), 1000.0),
        node_mem_cap=torch.full((3,), 1e9),
        node_base_cpu=torch.zeros(3),
        node_base_mem=torch.zeros(3),
        node_valid=torch.ones(3, dtype=torch.bool),
        node_lex_rank=torch.arange(3, dtype=torch.int32),
        pod_node=torch.tensor([0, 0, 1, 2], dtype=torch.int32),
        pod_service=torch.arange(4, dtype=torch.int32),
        pod_cpu=torch.full((4,), 100.0),
        pod_mem=torch.zeros(4),
        pod_valid=torch.tensor([True, True, True, False]),
    )


# (targets, raw objective after, input objective, move cost) -> (adopted,
# pod_node, objective_after, move_penalty)
ADOPT_CASES = {
    "a tie keeps the input": (([1, 1, 1, 2], 5.0, 5.0, 0.0), (False, [0, 0, 1, 2], 5.0, 0.0)),
    "a better placement is adopted": (([1, 0, 1, 2], 3.0, 5.0, 0.5),
                                      (True, [1, 0, 1, 2], 3.0, 0.5)),
    "a restart bill past the gain refuses it": (([1, 1, 0, 2], 4.0, 5.0, 0.5),
                                                (False, [0, 0, 1, 2], 5.0, 0.0)),
    "an invalid pod keeps its node and pays nothing": (([1, 1, 1, 0], 1.0, 5.0, 1.0),
                                                       (True, [1, 1, 1, 2], 1.0, 2.0)),
}


@pytest.mark.parametrize("case", list(ADOPT_CASES))
def test_adopt_gate(case):
    (tgt, raw, obj0, move_cost), (improved, pod_node, after, penalty) = ADOPT_CASES[case]
    state = four_pods()
    out = tgs.adopt(state, torch.tensor(tgt, dtype=torch.int32), torch.tensor(raw),
                    torch.tensor(obj0), move_cost)
    assert set(out) == {"pod_node", "objective_before", "objective_after", "improved",
                        "move_penalty"}
    assert bool(out["improved"]) is improved
    assert torch.equal(out["pod_node"], torch.tensor(pod_node, dtype=torch.int32))
    assert float(out["objective_before"]) == obj0
    assert float(out["objective_after"]) == after
    assert float(out["move_penalty"]) == penalty


def true_objective_f64(state, graph, cfg):
    """The input's objective from its definition, in float64: every pod
    pair on two nodes pays its services' call weight (halved: each pair is
    counted twice), plus ``balance_weight`` times the std of CPU % of raw
    capacity over ``capacity_frac``, plus ``overload_weight`` times the %
    of budget over 100 summed over the nodes."""
    svc = state.pod_service.numpy()
    node = state.pod_node.numpy()
    adj = graph.adj.numpy().astype(np.float64)
    comm = 0.5 * np.sum(adj[svc[:, None], svc[None, :]] * (node[:, None] != node[None, :]))
    cap = state.node_cpu_cap.numpy().astype(np.float64)
    used = np.bincount(node, weights=state.pod_cpu.numpy().astype(np.float64),
                       minlength=cap.shape[0])
    pct = used / cap * 100.0
    over = np.maximum(used / (cap * cfg.capacity_frac) * 100.0 - 100.0, 0.0).sum()
    return (comm + cfg.balance_weight * pct.std() / cfg.capacity_frac
            + cfg.overload_weight * over)


@pytest.fixture(scope="module")
def split_input():
    """768 services of 2 replicas on 8 nodes (3 sparse blocks), placed at
    random with a quarter of the pods piled on node 0: replicas split
    across nodes and a node over its budget. Returns the state, both
    graph forms, the config and the dense solve's ``objective_before``."""
    sc = ttopo.synthetic_scenario(n_pods=1536, n_nodes=8, powerlaw=True, replicas=2, seed=12,
                                  node_cpu_cap_m=40_000.0, device="cpu")
    state, graph = sc.state, sc.graph
    sg = tsg.from_comm_graph(graph)
    assert sg.num_blocks > 1 and bool(state.pod_valid.all())
    nodes = state.pod_node[torch.argsort(state.pod_service, stable=True)].reshape(-1, 2)
    assert bool((nodes[:, 0] != nodes[:, 1]).any())
    cfg = tgs.GlobalSolverConfig(sweeps=1, balance_weight=0.5, capacity_frac=0.9)
    dense = tgs.global_assign(state, graph, torch.Generator().manual_seed(0), cfg)[1]
    want = float(dense["objective_before"])
    assert want == pytest.approx(true_objective_f64(state, graph, cfg), rel=1e-5)
    return state, graph, sg, cfg, want


def solve(form, state, graph, sg, cfg, tmp_path):
    gen = torch.Generator().manual_seed(0)
    if form == "dense":
        return tgs.global_assign(state, graph, gen, cfg)[1]
    if form == "sparse":
        return tss.global_assign_sparse(state, sg, gen, cfg)[1]
    if form == "tp-dense":
        lay = tgs.dense_layout(graph.num_services, state.num_nodes, cfg, "cpu")
        plan = tgs.draw_plans(gen, cfg.sweeps, lay.sp, lay.chunk, lay.n_chunks, 1)
        fn, args = "parallel.sharded_global_assign", (state, graph, None)
    else:
        plan = tss.draw_sparse_plans(gen, cfg.sweeps, tss.sparse_layout(sg, cfg))
        fn, args = "parallel.sharded_sparse_assign", (state, sg, None)
    (_, info), = run_group(f"{PKG}.{fn}", (1, 1), args, dict(config=cfg, plan=plan),
                           rendezvous=str(tmp_path / "rdzv"), timeout_s=GROUP_TIMEOUT_S)
    return info


@pytest.mark.parametrize("form", ["dense", "sparse", "tp-dense", "tp-sparse"])
def test_every_solve_prices_the_input_alike(form, split_input, tmp_path):
    """Each solve's ``objective_before`` is the dense solve's (which is the
    float64 definition's) within rel 1e-5, and no solve ends worse."""
    state, graph, sg, cfg, want = split_input
    info = solve(form, state, graph, sg, cfg, tmp_path)
    assert float(info["objective_before"]) == pytest.approx(want, rel=1e-5)
    assert float(info["objective_after"]) <= float(info["objective_before"])
