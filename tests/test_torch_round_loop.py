"""The port's ``run_rounds`` against the JAX package's and against the
port's dict-world reference oracle (``oracle/reference_oracle.py``), on the
patterns of tests/test_round_loop.py; the port's oracle loop is held to
the JAX test's own ``oracle_loop`` once. Exact: placements, per-round
decisions and the per-round communication cost (integer pair counts) are
equal; the per-round load spread too (the same f32 sums of pod loads in pod
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_round_loop import oracle_loop as jax_oracle_loop

from kubernetes_rescheduling_tpu.core import topology as jtopo
from kubernetes_rescheduling_tpu.core.workmodel import mubench_workmodel_c as j_wm_c
from kubernetes_rescheduling_tpu.policies import POLICY_IDS
from kubernetes_rescheduling_tpu.solver import round_loop as jrl
from kubernetes_rescheduling_tpu.solver import run_rounds as j_run_rounds
from kubernetes_rescheduling_tpu_torch import oracle
from kubernetes_rescheduling_tpu_torch.core import topology as ttopo
from kubernetes_rescheduling_tpu_torch.core.state import UNASSIGNED, ClusterState
from kubernetes_rescheduling_tpu_torch.core.workmodel import mubench_workmodel_c as t_wm_c
from kubernetes_rescheduling_tpu_torch.objectives import communication_cost
from kubernetes_rescheduling_tpu_torch.solver import round_loop as trl
from kubernetes_rescheduling_tpu_torch.solver import run_rounds

TEL = ("moved", "most_hazard", "victim", "service", "target", "communication_cost", "load_std")


def jax_gumbel_rows(key, rounds, n):
    """The random policy's noise row of each round of JAX ``run_rounds``:
    ``gumbel(split(key, rounds)[r], (n,))``."""
    return torch.as_tensor(np.stack(
        [np.asarray(jax.random.gumbel(k, (n,))) for k in jax.random.split(key, rounds)]
    ))


def oracle_loop(state, graph, relation, policy, rounds, threshold=30.0):
    """tests/test_round_loop.py's reference-semantics loop on the port's
    oracle and tensor states (the same deliberate fixes as
    ``solver.round_loop``: a real snapshot edit, a skip instead of a
    crash)."""
    trace = []
    for _ in range(rounds):
        snap = oracle.to_snapshot(state, graph)
        most, hazard = oracle.detection(snap, threshold)
        victim = oracle.pick_max_pod(snap, most) if most else None
        if victim is None:
            trace.append(None)
            continue
        svc = victim.service
        group = state.pod_valid & (state.pod_service == graph.names.index(svc))
        removed = state.replace(pod_node=torch.where(group, UNASSIGNED, state.pod_node))
        snap2 = oracle.to_snapshot(removed, graph)
        if len(hazard) == len(snap.nodes_name):
            trace.append(None)
            continue
        if policy == "communication":
            target = oracle.choose_communication(snap2, relation, svc, hazard)
        else:
            target = getattr(oracle, f"choose_{policy}")(snap2, hazard)
        t_idx = state.node_names.index(target)
        state = removed.replace(pod_node=torch.where(group, t_idx, removed.pod_node))
        trace.append((most, victim.index, svc, target))
    return state, trace


def assert_same_rounds(t_final, t_tel, j_final, j_tel):
    np.testing.assert_array_equal(t_final.pod_node.numpy(), np.asarray(j_final.pod_node))
    for k in TEL:
        np.testing.assert_array_equal(getattr(t_tel, k).numpy(), np.asarray(getattr(j_tel, k)),
                                      err_msg=k)


@pytest.mark.parametrize("policy", ["spread", "binpack", "kubescheduling", "communication"])
def test_round_loop_matches_jax_and_oracle(policy):
    """tests/test_round_loop.py:63 for the port: 6 rounds on the imbalanced
    µBench scenario, against JAX ``run_rounds`` and the oracle trace."""
    j_scn = jtopo.mubench_scenario(imbalanced=True)
    t_scn = ttopo.mubench_scenario(imbalanced=True, device="cpu")
    rounds = 6
    j_final, j_tel = j_run_rounds(j_scn.state, j_scn.graph, jnp.asarray(POLICY_IDS[policy]),
                                  jax.random.PRNGKey(0), rounds=rounds)
    t_final, t_tel = run_rounds(t_scn.state, t_scn.graph, POLICY_IDS[policy], rounds=rounds,
                                device="cpu")
    assert_same_rounds(t_final, t_tel, j_final, j_tel)
    exp_final, exp_trace = oracle_loop(t_scn.state, t_scn.graph, t_wm_c().relation(), policy,
                                       rounds)
    np.testing.assert_array_equal(t_final.pod_node.numpy(), exp_final.pod_node.numpy())
    names, nodes = t_scn.graph.names, t_scn.state.node_names
    for r, step in enumerate(exp_trace):
        if step is None:
            assert not bool(t_tel.moved[r])
            continue
        most, victim_idx, svc, target = step
        assert bool(t_tel.moved[r])
        assert nodes[int(t_tel.most_hazard[r])] == most
        assert int(t_tel.victim[r]) == victim_idx
        assert names[int(t_tel.service[r])] == svc
        assert nodes[int(t_tel.target[r])] == target


def _piled():
    """The µBench services all on worker1 of 5000m nodes: 40% there, so
    every round has a hazard and a victim."""
    from kubernetes_rescheduling_tpu.core.topology import state_from_workmodel as j_sfw

    kw = dict(all_on_node=0, node_cpu_cap_m=5000.0)
    return (j_sfw(j_wm_c(), **kw), j_wm_c().comm_graph(),
            ttopo.state_from_workmodel(t_wm_c(), **kw, device="cpu"),
            t_wm_c().comm_graph(device="cpu"))


@pytest.mark.parametrize("instance", ["mubench", "piled"])
@pytest.mark.parametrize("key_seed", [0, 42])
def test_random_policy_matches_jax_stream(key_seed, instance):
    """The random policy with each round's gumbel row taken from JAX's
    ``split(key, rounds)``: the same moves, and no target is a hazard node
    (tests/test_round_loop.py:152)."""
    if instance == "mubench":
        j_scn = jtopo.mubench_scenario(imbalanced=True)
        t_scn = ttopo.mubench_scenario(imbalanced=True, device="cpu")
        j_state, j_graph, t_state, t_graph = j_scn.state, j_scn.graph, t_scn.state, t_scn.graph
    else:
        j_state, j_graph, t_state, t_graph = _piled()
    key = jax.random.PRNGKey(key_seed)
    j_final, j_tel = j_run_rounds(j_state, j_graph, jnp.asarray(POLICY_IDS["random"]),
                                  key, rounds=10)
    t_final, t_tel = run_rounds(t_state, t_graph, POLICY_IDS["random"], rounds=10,
                                gumbel=jax_gumbel_rows(key, 10, 3), device="cpu")
    assert_same_rounds(t_final, t_tel, j_final, j_tel)
    moved = t_tel.moved.numpy()
    assert moved.any() == (instance == "piled")
    assert (t_tel.target.numpy()[moved] != t_tel.most_hazard.numpy()[moved]).all()


def test_random_policy_default_draws_depend_on_seed_and_round_only():
    """Without injected rows, round r's noise comes from the generator of
    (seed, r): two runs agree, and the first k rounds of a longer run are
    the k rounds of a shorter one."""
    _, _, t_state, t_graph = _piled()
    pid = POLICY_IDS["random"]
    a_final, a = run_rounds(t_state, t_graph, pid, 5, rounds=8, device="cpu")
    b_final, b = run_rounds(t_state, t_graph, pid, 5, rounds=8, device="cpu")
    _, c = run_rounds(t_state, t_graph, pid, 5, rounds=3, device="cpu")
    assert torch.equal(a_final.pod_node, b_final.pod_node)
    for k in ("moved", "most_hazard", "victim", "target"):
        assert torch.equal(getattr(a, k), getattr(b, k))
        assert torch.equal(getattr(a, k)[:3], getattr(c, k))
    moved = a.moved
    assert bool(moved.any())
    assert (a.target[moved] != a.most_hazard[moved]).all()


def _pair(seed: int, cap: float):
    from kubernetes_rescheduling_tpu.core.topology import state_from_workmodel as j_sfw

    return (j_sfw(j_wm_c(), seed=seed, node_cpu_cap_m=cap), j_wm_c().comm_graph(),
            ttopo.state_from_workmodel(t_wm_c(), seed=seed, node_cpu_cap_m=cap, device="cpu"),
            t_wm_c().comm_graph(device="cpu"))


@pytest.mark.parametrize("policy", ["spread", "binpack", "kubescheduling", "communication"])
def test_port_oracle_loop_matches_the_jax_oracle_loop(policy):
    """The port's oracle loop and the JAX test's, on the piled µBench
    cluster (a hazard every round): the same trace and final placement."""
    j_state, j_graph, t_state, t_graph = _piled()
    rel = j_wm_c().relation()
    j_final, j_trace = jax_oracle_loop(j_state, j_graph, rel, policy, 5)
    t_final, t_trace = oracle_loop(t_state, t_graph, rel, policy, 5)
    assert t_trace == j_trace and any(step is not None for step in t_trace)
    np.testing.assert_array_equal(t_final.pod_node.numpy(), np.asarray(j_final.pod_node))


def test_car_reduces_comm_cost_from_random_start():
    """tests/test_round_loop.py:107 for the port, and equal to JAX."""
    j_state, j_graph, t_state, t_graph = _pair(7, 2000.0)
    before = float(communication_cost(t_state, t_graph))
    j_final, j_tel = j_run_rounds(j_state, j_graph, jnp.asarray(POLICY_IDS["communication"]),
                                  jax.random.PRNGKey(0), rounds=10)
    t_final, t_tel = run_rounds(t_state, t_graph, POLICY_IDS["communication"], rounds=10,
                                device="cpu")
    assert_same_rounds(t_final, t_tel, j_final, j_tel)
    assert bool(t_tel.moved.any())
    assert float(communication_cost(t_final, t_graph)) <= before


def test_stable_cluster_is_noop():
    """tests/test_round_loop.py:122: big capacities, nothing over 30%, so
    every round is a no-op."""
    j_state, j_graph, t_state, t_graph = _pair(1, 1e6)
    j_final, j_tel = j_run_rounds(j_state, j_graph, jnp.asarray(POLICY_IDS["communication"]),
                                  jax.random.PRNGKey(0), rounds=5)
    t_final, t_tel = run_rounds(t_state, t_graph, POLICY_IDS["communication"], rounds=5,
                                device="cpu")
    assert_same_rounds(t_final, t_tel, j_final, j_tel)
    assert not bool(t_tel.moved.any())
    assert torch.equal(t_final.pod_node, t_state.pod_node)


def test_all_hazard_skips_moves():
    """tests/test_round_loop.py:137: tiny capacities, every node hazardous,
    so moves are skipped and every Deployment is kept."""
    j_state, j_graph, t_state, t_graph = _pair(1, 300.0)
    j_final, j_tel = j_run_rounds(j_state, j_graph, jnp.asarray(POLICY_IDS["spread"]),
                                  jax.random.PRNGKey(0), rounds=3)
    t_final, t_tel = run_rounds(t_state, t_graph, POLICY_IDS["spread"], rounds=3, device="cpu")
    assert_same_rounds(t_final, t_tel, j_final, j_tel)
    assert not bool(t_tel.moved.any())
    assert int(t_final.pod_valid.sum()) == int(t_state.pod_valid.sum())
    assert (t_tel.most_hazard >= 0).all() and (t_tel.victim >= 0).all()


def test_finite_guard_matches_jax():
    kw = dict(node_names=["a", "b"], node_cpu_cap=[1000.0, 1000.0], node_mem_cap=[1e9, 1e9],
              pod_services=[0, 0, 1, 1], pod_nodes=[0, 1, 0, 1],
              pod_cpu=[np.nan, -5.0, np.inf, 120.0], pod_mem=[1.0, -np.inf, 2.0, 3.0],
              node_base_cpu=[np.nan, -3.0], node_base_mem=[np.inf, 1.0])
    from kubernetes_rescheduling_tpu.core.state import ClusterState as JState

    j = jrl.finite_guard(JState.build(**kw))
    t = trl.finite_guard(ClusterState.build(**kw, device="cpu"))
    for k in ("pod_cpu", "pod_mem", "node_base_cpu", "node_base_mem"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)), err_msg=k)


@pytest.mark.parametrize("policy", ["spread", "binpack", "kubescheduling", "communication",
                                    "random"])
def test_decide_matches_jax_on_the_seeded_synthetic_state(policy):
    """``decide`` on a power-law instance with 40 nodes piled a quarter
    onto node 0, at thresholds that hit none, one and several nodes."""
    kw = dict(n_pods=300, n_nodes=40, powerlaw=True, seed=4, node_cpu_cap_m=1500.0)
    j_scn, t_scn = jtopo.synthetic_scenario(**kw), ttopo.synthetic_scenario(**kw, device="cpu")
    key = jax.random.PRNGKey(9)
    g = torch.tensor(np.asarray(jax.random.gumbel(key, (40,))))
    for thr in (5.0, 10.0, 30.0, 99.0):
        j = jrl.decide(j_scn.state, j_scn.graph, jnp.asarray(POLICY_IDS[policy]),
                       jnp.asarray(thr), key)
        t = trl.decide(t_scn.state, t_scn.graph, POLICY_IDS[policy], thr, g)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
