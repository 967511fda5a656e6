"""The port's cluster state, scenario constructors, simulator snapshot and
metrics against the JAX package's, from the same seeds.

Scenario constructors use the same numpy ``default_rng(seed)`` call sequence, so arrays
must be IDENTICAL. Float metrics agree within rel 1e-6: f32 sums may run in
another order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu.bench import harness as jharness
from kubernetes_rescheduling_tpu.core import state as jstate
from kubernetes_rescheduling_tpu.core import topology as jtopo
from kubernetes_rescheduling_tpu.core import workmodel as jwm
from kubernetes_rescheduling_tpu.objectives import metrics as jmetrics
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu_torch import convert
from kubernetes_rescheduling_tpu_torch.bench import harness as tharness
from kubernetes_rescheduling_tpu_torch.core import state as tstate
from kubernetes_rescheduling_tpu_torch.core import topology as ttopo
from kubernetes_rescheduling_tpu_torch.core import workmodel as twm
from kubernetes_rescheduling_tpu_torch.objectives import metrics as tmetrics
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs


def jax_state_arrays(st) -> dict:
    out = {k: np.asarray(getattr(st, k)) for k in convert.STATE_ARRAYS}
    out.update(node_names=st.node_names, pod_names=st.pod_names)
    return out


def assert_state_equal(t_state, j_state):
    for k in convert.STATE_ARRAYS:
        got = getattr(t_state, k).cpu().numpy()
        want = np.asarray(getattr(j_state, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert t_state.node_names == tuple(j_state.node_names)
    assert t_state.pod_names == tuple(j_state.pod_names)


def assert_graph_equal(t_graph, j_graph):
    np.testing.assert_array_equal(t_graph.adj.cpu().numpy(), np.asarray(j_graph.adj))
    np.testing.assert_array_equal(
        t_graph.service_valid.cpu().numpy(), np.asarray(j_graph.service_valid)
    )
    assert t_graph.names == tuple(j_graph.names)


@pytest.mark.parametrize("scenario", ["dense", "powerlaw"])
@pytest.mark.parametrize("seed", [0, 3])
def test_make_backend_matches_jax(scenario, seed):
    jb = jharness.make_backend(scenario, seed)
    tb = tharness.make_backend(scenario, seed, device="cpu")
    assert_state_equal(tb.monitor(), jb.monitor())
    assert_graph_equal(tb.comm_graph(), jb.comm_graph())


def test_large_workmodel_matches_jax():
    """The 10k-service north-star mesh: same topology from the same seed
    (compared as relations; the dense adjacencies are 400 MB each)."""
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    j = jtopo._random_workmodel(10_000, rng_j, powerlaw=True, mean_degree=4.0)
    t = ttopo._random_workmodel(10_000, rng_t, powerlaw=True, mean_degree=4.0)
    assert t.relation() == j.relation()
    assert t.directed_relation() == j.directed_relation()
    assert t.names == j.names
    with pytest.raises(ValueError, match="unknown scenario"):
        tharness.make_backend("xlarge", 0, device="cpu")


@pytest.mark.parametrize(
    "scenario_fn", ["dense_200x20", "powerlaw_2000x200"]
)
def test_topology_constructors_match_jax(scenario_fn):
    j = getattr(jtopo, scenario_fn)(seed=2)
    t = getattr(ttopo, scenario_fn)(seed=2, device="cpu")
    assert t.name == j.name
    assert_state_equal(t.state, j.state)
    assert_graph_equal(t.graph, j.graph)


@pytest.mark.parametrize("kw", [
    dict(n_pods=60, n_nodes=6, seed=5, node_cpu_cap_m=1500.0, imbalance_frac=0.5),
    dict(n_pods=90, n_nodes=10, seed=1, replicas=3, powerlaw=True),
    dict(n_pods=40, n_nodes=4, seed=0, imbalance_frac=0.0),
])
def test_synthetic_scenario_and_derived_match_jax(kw):
    j = jtopo.synthetic_scenario(**kw)
    t = ttopo.synthetic_scenario(**kw, device="cpu")
    assert_state_equal(t.state, j.state)
    assert_graph_equal(t.graph, j.graph)
    S = t.graph.num_services
    for name in ("node_cpu_used", "node_mem_used", "node_cpu_pct"):
        np.testing.assert_allclose(
            getattr(t.state, name)().numpy(), np.asarray(getattr(j.state, name)()),
            rtol=1e-6, err_msg=name,
        )
    np.testing.assert_array_equal(
        t.state.service_node_counts(S).numpy(), np.asarray(j.state.service_node_counts(S))
    )
    for name in ("communication_cost", "load_std", "capacity_violation"):
        f_t, f_j = getattr(tmetrics, name), getattr(jmetrics, name)
        args_t = (t.state, t.graph) if name == "communication_cost" else (t.state,)
        args_j = (j.state, j.graph) if name == "communication_cost" else (j.state,)
        assert float(f_t(*args_t)) == pytest.approx(float(f_j(*args_j)), rel=1e-6, abs=1e-6)


def test_padding_and_unassigned_pods_match_jax():
    """Padded capacities, an unplaced pod and a dead node: the derived sums
    drop exactly what the JAX package drops."""
    kw = dict(
        node_names=["b", "a", "c"], node_cpu_cap=[1000.0, 2000.0, 0.0],
        node_mem_cap=[1e9, 2e9, 1e9], pod_services=[0, 1, 1, 2],
        pod_nodes=[0, -1, 2, 1], pod_cpu=[100.5, 200.25, 300.0, 50.0],
        pod_mem=[1.0, 2.0, 3.0, 4.0], node_alive=[True, True, False],
        node_base_cpu=[10.0, 0.0, 5.0], node_capacity=5, pod_capacity=7,
    )
    j = jstate.ClusterState.build(**kw)
    t = tstate.ClusterState.build(**kw, device="cpu")
    assert_state_equal(t, j)
    for name in ("node_cpu_used", "node_mem_used", "node_cpu_pct"):
        np.testing.assert_array_equal(getattr(t, name)().numpy(),
                                      np.asarray(getattr(j, name)()), err_msg=name)
    np.testing.assert_array_equal(t.service_node_counts(4).numpy(),
                                  np.asarray(j.service_node_counts(4)))
    assert float(tmetrics.load_std(t)) == pytest.approx(float(jmetrics.load_std(j)), rel=1e-6)


def test_segment_sum_is_sequential_per_segment():
    vals = torch.tensor([0.1, 1e8, -1e8, 0.2, 0.3, 5.0])
    idx = torch.tensor([1, 0, 0, 1, 3, 1])
    out = tstate.segment_sum(vals, idx, 3)  # index 3 is out of range: dropped
    assert out.tolist() == [np.float32(1e8) + np.float32(-1e8),
                            float(np.float32(np.float32(np.float32(0.1) + np.float32(0.2))
                                             + np.float32(5.0))),
                            0.0]


def test_comm_graph_from_relation_matches_jax():
    wm = jwm.mubench_workmodel_c()
    t = twm.Workmodel(
        services=tuple(twm.ServiceSpec(name=s.name, callees=s.callees) for s in wm.services)
    )
    assert t.relation() == wm.relation()
    assert_graph_equal(t.comm_graph(capacity=24, device="cpu"), wm.comm_graph(capacity=24))
    # a callee outside the service names is an external endpoint: no edge;
    # a self-call neither; padding rows stay invalid
    rel = {"a": ["b", "ext", "a"], "b": []}
    kw = dict(names=["a", "b"], capacity=3)
    assert_graph_equal(tstate.CommGraph.from_relation(rel, **kw, device="cpu"),
                       jstate.CommGraph.from_relation(rel, **kw))


def test_kahn_and_entry_rate_match_jax():
    rng = np.random.default_rng(4)
    j = jtopo._random_workmodel(300, rng, powerlaw=False, mean_degree=5.0)
    t = ttopo._random_workmodel(300, np.random.default_rng(4), powerlaw=False, mean_degree=5.0)
    # a cycle, so the cycle-breaking rule is exercised
    rel = {**t.directed_relation(), "s299": ["s0"]}
    assert twm.kahn_traversal(rel, t.names) == jwm.kahn_traversal(rel, j.names)
    assert twm.propagate_entry_rate(
        t, entry_service="s0", entry_rps=50.0, fanout_frac=0.5
    ) == jwm.propagate_entry_rate(j, entry_service="s0", entry_rps=50.0, fanout_frac=0.5)


def test_convert_round_trip():
    j = jtopo.synthetic_scenario(n_pods=80, n_nodes=8, seed=6, replicas=2)
    arrays = jax_state_arrays(j.state)
    t_state = convert.state_from_arrays(arrays, device="cpu")
    assert_state_equal(t_state, j.state)
    for k in convert.STATE_ARRAYS:  # and back, unchanged
        np.testing.assert_array_equal(getattr(t_state, k).numpy(), arrays[k])
    g_arrays = {"adj": np.asarray(j.graph.adj), "service_valid": np.asarray(
        j.graph.service_valid), "names": j.graph.names}
    t_graph = convert.graph_from_arrays(g_arrays, device="cpu")
    assert_graph_equal(t_graph, j.graph)
    with pytest.raises(KeyError):
        convert.state_from_arrays({"pod_node": arrays["pod_node"]}, device="cpu")


def test_config_from_dict_carries_the_jax_config():
    jcfg = jgs.GlobalSolverConfig(sweeps=5, balance_weight=0.25, move_cost=1.5,
                                  fused_epilogue="interpret", chunk_size=64)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    tcfg = convert.config_from_dict(fields)
    assert tcfg.fused_epilogue == "on"
    for f in dataclasses.fields(tcfg):
        if f.name != "fused_epilogue":
            assert getattr(tcfg, f.name) == fields[f.name], f.name
    # every JAX default carries over unchanged
    defaults = {f.name: getattr(jgs.GlobalSolverConfig(), f.name)
                for f in dataclasses.fields(jgs.GlobalSolverConfig)}
    assert convert.config_from_dict(defaults) == tgs.GlobalSolverConfig()
    with pytest.raises(KeyError):
        convert.config_from_dict({"no_such_knob": 1})


def test_solver_helpers_match_jax():
    j = jtopo.synthetic_scenario(n_pods=90, n_nodes=10, seed=1, replicas=3)
    t = ttopo.synthetic_scenario(n_pods=90, n_nodes=10, seed=1, replicas=3, device="cpu")
    S = t.graph.num_services
    for got, want in zip(tgs._service_aggregates(t.state, S),
                         jgs._service_aggregates(j.state, S)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(tgs.input_comm_cost(t.state, t.graph)) == pytest.approx(
        float(jgs.input_comm_cost(j.state, j.graph)), rel=1e-6)
    for got, want in zip(tgs.comm_cost_collapse(t.state, t.graph),
                         jgs.comm_cost_collapse(j.state, j.graph)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    rv = np.arange(S, dtype=np.float32) % 3
    assign = (np.arange(S) * 7 % 10).astype(np.int32)
    assert float(tgs.exact_comm_cost(t.graph.adj, torch.as_tensor(rv),
                                     torch.as_tensor(assign))) == pytest.approx(
        float(jgs.exact_comm_cost(j.graph.adj, jnp.asarray(rv), jnp.asarray(assign))),
        rel=1e-6)
    assert float(tgs.total_pair_weight(t.graph.adj, torch.as_tensor(rv))) == pytest.approx(
        float(jgs.total_pair_weight(j.graph.adj, jnp.asarray(rv))), rel=1e-6)
    tgt = torch.as_tensor(np.asarray(j.state.pod_node)[::-1].copy())
    assert float(tgs.pod_restart_bill(t.state, tgt, 2.0)) == float(
        jgs.pod_restart_bill(j.state, jnp.asarray(tgt.numpy()), 2.0))
    loads = np.linspace(0, 3000, 10).astype(np.float32)
    cap = np.full(10, 2000.0, np.float32)
    nv = np.arange(10) != 3
    assert float(tgs.pct_balance_terms(torch.as_tensor(loads), torch.as_tensor(cap),
                                       torch.as_tensor(nv), 0.5, 10.0)) == pytest.approx(
        float(jgs.pct_balance_terms(jnp.asarray(loads), jnp.asarray(cap), jnp.asarray(nv),
                                    0.5, 10.0)), rel=1e-6)
    for s, c in ((10_000, 0), (300, 0), (2560, 0), (40, 16)):
        assert tgs.auto_chunk(s, c) == jgs.auto_chunk(s, c)
    W_t = tgs.build_pair_weights(t.graph.adj, torch.as_tensor(rv), SP=32, dtype=torch.bfloat16)
    W_j = jgs.build_pair_weights(j.graph.adj, jnp.asarray(rv), SP=32, dtype=jnp.bfloat16)
    np.testing.assert_array_equal(W_t.float().numpy(), np.asarray(W_j, np.float32))
