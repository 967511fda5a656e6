"""The port's optimality-gap oracles against the JAX package's: the three
fast cases of tests/test_optimum.py on the port's states and solver, and
the brute-force and MILP optima of both packages equal at rel 1e-9 (the
same float64 host arithmetic on the same f32 inputs; the MILP's HiGHS
objective is an exact sum of integer weights)."""

import jax
import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu.core.state import ClusterState as JState
from kubernetes_rescheduling_tpu.core.state import CommGraph as JGraph
from kubernetes_rescheduling_tpu.oracle import optimum as jopt
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.oracle.optimum import brute_force_optimum, milp_optimum
from kubernetes_rescheduling_tpu_torch.solver import GlobalSolverConfig, global_assign
from kubernetes_rescheduling_tpu_torch.solver.global_solver import exact_comm_cost


def _tiny_instance(S, N, seed, cap_m=1e9, *, state_cls=ClusterState, graph_cls=CommGraph,
                   **kw):
    """tests/test_optimum.py's instance, built by either package."""
    rng = np.random.default_rng(seed)
    rel = {
        f"s{i}": [f"s{j}" for j in range(S) if j != i and rng.random() < 0.5]
        for i in range(S)
    }
    graph = graph_cls.from_relation(rel, names=[f"s{i}" for i in range(S)], **kw)
    state = state_cls.build(
        node_names=[f"n{i}" for i in range(N)],
        node_cpu_cap=[cap_m] * N,
        node_mem_cap=[2**33] * N,
        pod_services=list(range(S)),
        pod_nodes=rng.integers(0, N, S).tolist(),
        pod_cpu=[100.0] * S,
        pod_mem=[0.0] * S,
        pod_names=[f"s{i}-0" for i in range(S)],
        **kw,
    )
    return state, graph


def test_brute_force_matches_milp_on_comm():
    for seed in range(4):
        state, graph = _tiny_instance(7, 3, seed, device="cpu")
        _, bf = brute_force_optimum(state, graph, balance_weight=0.0, overload_weight=0.0)
        milp, proven = milp_optimum(state, graph)
        assert proven
        assert bf == pytest.approx(milp, abs=1e-6)


def test_brute_force_capacity_binding():
    # 6 services x 100m, nodes cap 250m -> min 3 nodes needed; the
    # unconstrained optimum (all on one node, cut 0) must be excluded
    state, graph = _tiny_instance(6, 3, seed=1, cap_m=250.0, device="cpu")
    a, obj = brute_force_optimum(state, graph, balance_weight=0.0, overload_weight=0.0)
    loads = np.bincount(a, weights=np.full(6, 100.0), minlength=3)
    assert (loads <= 250.0).all()
    assert obj > 0.0
    milp, proven = milp_optimum(state, graph)
    assert proven
    assert obj == pytest.approx(milp, abs=1e-6)


def test_solver_gap_small_instances_fast():
    """tests/test_optimum.py's tier-1 pin on the port's solver: 4 tiny
    instances, aggregate gap <= 5%, at least 3 exactly optimal."""
    total_solver = total_opt = 0.0
    exact_hits = 0
    for seed in range(4):
        state, graph = _tiny_instance(8, 3, seed, cap_m=350.0, device="cpu")
        cfg = GlobalSolverConfig(sweeps=9, balance_weight=0.0)
        new_state, _ = global_assign(state, graph, torch.Generator().manual_seed(seed), cfg)
        S = graph.num_services
        assign = torch.zeros(S, dtype=torch.int64)
        assign[new_state.pod_service[:S].long()] = new_state.pod_node[:S].long()
        solver_cost = float(exact_comm_cost(graph.adj[:S, :S], torch.ones(S), assign))
        _, opt = brute_force_optimum(state, graph, balance_weight=0.0, overload_weight=0.0)
        assert solver_cost >= opt - 1e-6  # the oracle really is a bound
        total_solver += solver_cost
        total_opt += opt
        exact_hits += solver_cost <= opt + 1e-6
    assert total_solver <= total_opt * 1.05
    assert exact_hits >= 3


@pytest.mark.parametrize("S,N,seed,cap_m,bw", [
    (7, 3, 0, 1e9, 0.0),
    (6, 3, 1, 250.0, 0.0),
    (8, 3, 2, 350.0, 0.5),
    (6, 4, 3, 300.0, 1.0),
])
def test_optima_equal_jax(S, N, seed, cap_m, bw):
    t_state, t_graph = _tiny_instance(S, N, seed, cap_m, device="cpu")
    j_state, j_graph = _tiny_instance(S, N, seed, cap_m, state_cls=JState, graph_cls=JGraph)
    kw = dict(balance_weight=bw, overload_weight=10.0, capacity_frac=0.9)
    t_a, t_obj = brute_force_optimum(t_state, t_graph, **kw)
    j_a, j_obj = jopt.brute_force_optimum(j_state, j_graph, **kw)
    assert t_obj == pytest.approx(j_obj, rel=1e-9)
    np.testing.assert_array_equal(t_a, j_a)
    t_milp, t_proven = milp_optimum(t_state, t_graph, capacity_frac=0.9)
    j_milp, j_proven = jopt.milp_optimum(j_state, j_graph, capacity_frac=0.9)
    assert t_proven and j_proven
    assert t_milp == pytest.approx(j_milp, rel=1e-9, abs=1e-12)


def test_jax_instance_is_the_same_instance():
    t_state, t_graph = _tiny_instance(7, 3, 0, device="cpu")
    j_state, j_graph = _tiny_instance(7, 3, 0, state_cls=JState, graph_cls=JGraph)
    np.testing.assert_array_equal(t_graph.adj.numpy(), np.asarray(j_graph.adj))
    np.testing.assert_array_equal(t_state.pod_node.numpy(), np.asarray(j_state.pod_node))
    assert jax.numpy.asarray(j_state.pod_node).shape == tuple(t_state.pod_node.shape)
