"""The port's sparse graph against the JAX package's: one edge list builds
identical arrays and static metadata in both, and the exact cut sums agree
with each other and with the dense metric.

Tolerances: arrays are compared exactly (the construction is the same
host numpy in both packages); cost sums at rel 1e-6, the JAX package's own bar
(tests/test_sparse_solver.py), because f32 sums over the edge list may
associate differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu.core import sparsegraph as jsg
from kubernetes_rescheduling_tpu.core import topology as jtopo
from kubernetes_rescheduling_tpu.solver import sparse_solver as jss
from kubernetes_rescheduling_tpu_torch import convert
from kubernetes_rescheduling_tpu_torch.bench.harness import sparse_problem
from kubernetes_rescheduling_tpu_torch.core import sparsegraph as tsg
from kubernetes_rescheduling_tpu_torch.core import topology as ttopo
from kubernetes_rescheduling_tpu_torch.objectives import communication_cost
from kubernetes_rescheduling_tpu_torch.solver.global_solver import exact_comm_cost
from kubernetes_rescheduling_tpu_torch.solver.sparse_solver import sparse_pod_comm_cost

ARRAYS = ("w_local", "u_ids", "edges_src", "edges_dst", "edges_w", "perm", "inv",
          "service_valid")
STATIC = ("block_toff", "block_ntiles", "hub_blocks", "regular_blocks", "zero_toff", "bu",
          "reg_tiles", "num_services", "names")


def random_edges(S, mean_degree, seed, weights=False):
    """tests/test_sparse_solver.py's ``_random_graph``."""
    rng = np.random.default_rng(seed)
    E = int(S * mean_degree / 2)
    src = rng.integers(0, S, size=E)
    dst = rng.integers(0, S, size=E)
    w = rng.integers(1, 5, size=E).astype(np.float64) if weights else np.ones(E)
    return src, dst, w


def star_edges(S=512, arms=300, bg_seed=10):
    """A star (service 0 calls ``arms`` others) over a random background:
    with bu=128, reg_tiles=1 the star's block becomes a hub block."""
    bg_src, bg_dst, _ = random_edges(S, 3.0, seed=bg_seed)
    src = np.concatenate([np.zeros(arms, dtype=np.int64), bg_src])
    dst = np.concatenate([np.arange(1, arms + 1, dtype=np.int64), bg_dst])
    return src, dst, np.ones(len(src))


def assert_same_graph(t, j):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    for name in STATIC:
        assert getattr(t, name) == getattr(j, name), name
    assert (t.dense_adj is None) == (j.dense_adj is None)
    if t.dense_adj is not None:
        np.testing.assert_array_equal(t.dense_adj.numpy(), np.asarray(j.dense_adj))
    assert (t.sp, t.num_blocks, t.u_reg, t.weight_bytes()) == (
        j.sp, j.num_blocks, j.u_reg, j.weight_bytes())


@pytest.mark.parametrize("case", ["defaults", "star_hub", "unsorted", "weighted", "single"])
def test_from_edges_matches_jax(case):
    kw = {}
    if case == "defaults":
        (src, dst, w), S = random_edges(700, 4.0, seed=2), 700
    elif case == "star_hub":
        (src, dst, w), S = star_edges(), 512
        kw = dict(bu=128, reg_tiles=1)
    elif case == "unsorted":
        (src, dst, w), S = random_edges(600, 4.0, seed=3), 600
        kw = dict(degree_sort=False, reg_tiles=4)
    elif case == "weighted":
        (src, dst, w), S = random_edges(600, 4.0, seed=5, weights=True), 600
        kw = dict(bu=128, reg_tiles=8)
    else:  # one block: carries the dense adjacency for delegation
        (src, dst, w), S = random_edges(200, 4.0, seed=4), 200
    j = jsg.from_edges(src, dst, w, S, **kw)
    t = tsg.from_edges(src, dst, w, S, device="cpu", **kw)
    assert_same_graph(t, j)
    if case == "star_hub":
        assert t.hub_blocks[0] == 0 and int(t.perm[0]) == 0  # the star's block


def test_from_workmodel_large_matches_jax():
    """The 10k-service power-law mesh of the ``large`` scenario, built
    straight from the call graph: 40 blocks, hub blocks included."""
    j_wm = jtopo._random_workmodel(10_000, np.random.default_rng(0), powerlaw=True,
                                   mean_degree=4.0)
    t_wm = ttopo._random_workmodel(10_000, np.random.default_rng(0), powerlaw=True,
                                   mean_degree=4.0)
    j = jsg.from_workmodel(j_wm)
    t = tsg.from_workmodel(t_wm, device="cpu")
    assert t.num_blocks == 40 and len(t.hub_blocks) > 0
    assert_same_graph(t, j)


def test_from_comm_graph_round_trip():
    scn = ttopo.synthetic_scenario(n_pods=300, n_nodes=8, powerlaw=True, seed=1, device="cpu")
    sg = tsg.from_comm_graph(scn.graph)
    assert sg.device == scn.graph.adj.device
    S = sg.num_services
    assert torch.equal(sg.to_dense().adj, scn.graph.adj[:S, :S])


def test_carried_across_graph_equals_port_build():
    """``convert.sparse_graph_from_arrays`` of a JAX graph gives the port's
    own build, field for field."""
    src, dst, w = star_edges()
    j = jsg.from_edges(src, dst, w, 512, bu=128, reg_tiles=1)
    arrays = {k: np.asarray(getattr(j, k)) for k in ARRAYS}
    arrays["dense_adj"] = None
    carried = convert.sparse_graph_from_arrays(
        {**arrays, **{k: getattr(j, k) for k in STATIC}}, device="cpu"
    )
    assert_same_graph(carried, j)


def test_sparse_pair_comm_cost_matches_jax_and_dense():
    """tests/test_sparse_solver.py:92's instance: random assignments and
    replica counts mapped to sorted space."""
    scn = ttopo.synthetic_scenario(n_pods=200, n_nodes=10, powerlaw=True, seed=3, device="cpu")
    t = tsg.from_comm_graph(scn.graph)
    j = jsg.from_comm_graph(jtopo.synthetic_scenario(n_pods=200, n_nodes=10, powerlaw=True,
                                                     seed=3).graph)
    S = t.num_services
    rng = np.random.default_rng(0)
    perm = np.clip(t.perm.numpy(), 0, S - 1)
    real = t.perm.numpy() < S
    for _ in range(3):
        assign = rng.integers(0, 10, size=S).astype(np.int32)
        rv = rng.integers(1, 4, size=S).astype(np.float32)
        a_s, rv_s = assign[perm], rv[perm] * real
        got = float(tsg.sparse_pair_comm_cost(t, torch.as_tensor(a_s), torch.as_tensor(rv_s)))
        want = float(jsg.sparse_pair_comm_cost(j, jnp.asarray(a_s), jnp.asarray(rv_s)))
        dense = float(exact_comm_cost(scn.graph.adj[:S, :S], torch.as_tensor(rv),
                                      torch.as_tensor(assign)))
        assert got == pytest.approx(want, rel=1e-6)
        assert got == pytest.approx(dense, rel=1e-6)


@pytest.mark.parametrize("collapse", [False, True])
def test_sparse_pod_comm_cost_matches_jax_and_dense(collapse):
    """Both branches of the pod-level cost (tests/test_sparse_solver.py:313):
    a split placement with unplaced pods takes the general count, its
    per-service collapse the edge-list cut."""
    kw = dict(n_pods=240, n_nodes=8, powerlaw=True, seed=11, replicas=3)
    t_scn = ttopo.synthetic_scenario(**kw, device="cpu")
    j_scn = jtopo.synthetic_scenario(**kw)
    rng = np.random.default_rng(1)
    nodes = rng.integers(0, 8, size=t_scn.state.num_pods)
    nodes[rng.random(t_scn.state.num_pods) < 0.1] = -1
    if collapse:
        ps = t_scn.state.pod_service.numpy()
        first = {}
        for p, s in enumerate(ps):
            first.setdefault(int(s), int(nodes[p]))
        nodes = np.asarray([first[int(s)] for s in ps])
    nodes = nodes.astype(np.int32)
    t_state = t_scn.state.replace(pod_node=torch.as_tensor(nodes))
    j_state = j_scn.state.replace(pod_node=jnp.asarray(nodes))
    t = tsg.from_comm_graph(t_scn.graph)
    j = jsg.from_comm_graph(j_scn.graph)
    got = float(sparse_pod_comm_cost(t_state, t))
    assert got == pytest.approx(float(jss.sparse_pod_comm_cost(j_state, j)), rel=1e-6)
    assert got == pytest.approx(float(communication_cost(t_state, t_scn.graph)), rel=1e-6)


def test_sparse_problem_matches_jax_bench_problem():
    """``sparse_problem`` is ``bench.py``'s ``_sparse_problem`` (:602-623),
    here at 3,000 services × 64 nodes: the same state and graph."""
    rng = np.random.default_rng(0)
    wm = jtopo._random_workmodel(3000, rng, powerlaw=True, mean_degree=4.0)
    j = jsg.from_workmodel(wm)
    j_state = jtopo.state_from_workmodel(wm, node_names=[f"w{i:05d}" for i in range(64)],
                                         node_cpu_cap_m=5_000.0, seed=0)
    t_state, t = sparse_problem(3000, 64, device="cpu")
    assert_same_graph(t, j)
    for name in ("node_cpu_cap", "node_mem_cap", "node_base_cpu", "node_valid", "pod_node",
                 "pod_service", "pod_cpu", "pod_mem", "pod_valid"):
        np.testing.assert_array_equal(getattr(t_state, name).numpy(),
                                      np.asarray(getattr(j_state, name)), err_msg=name)
    assert t_state.node_names == j_state.node_names
