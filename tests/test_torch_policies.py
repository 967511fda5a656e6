"""The port's greedy decision pieces against the JAX package's, on the same
instances: hazard detection, victim and Deployment group, the masked
lexicographic argmax on tied rows, the per-node features and the target
node of all five policies.

Instances: the reference's imbalanced µBench scenario, its balanced twin,
and a hand-built state with exact ties everywhere (equal node loads, a
CPU percent of exactly .5, equal pod loads on one node, equal affinities
and a node ordering that differs from the name ordering), plus a seeded
random state. Every comparison is exact: the decisions are integer
indices, and the features are the same f32 values (sums of pod loads in
pod order, integer counts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu.core import state as jstate
from kubernetes_rescheduling_tpu.core import topology as jtopo
from kubernetes_rescheduling_tpu.policies import hazard as jhazard
from kubernetes_rescheduling_tpu.policies import proactive as jproactive
from kubernetes_rescheduling_tpu.policies import scoring as jscoring
from kubernetes_rescheduling_tpu.policies import victim as jvictim
from kubernetes_rescheduling_tpu_torch.core import state as tstate
from kubernetes_rescheduling_tpu_torch.core import topology as ttopo
from kubernetes_rescheduling_tpu_torch.policies import hazard as thazard
from kubernetes_rescheduling_tpu_torch.policies import proactive as tproactive
from kubernetes_rescheduling_tpu_torch.policies import scoring as tscoring
from kubernetes_rescheduling_tpu_torch.policies import victim as tvictim

# six nodes whose name order differs from their index order; n4 has no
# capacity and n2 is dead. n3 and n1 carry equal loads (ties in pct, free
# CPU and pod count); n5 sits at exactly 30.5% (rounds half to even to 30).
TIED_NODES = ["n3", "n1", "n5", "n0", "n4", "n2"]
TIED_KW = dict(
    node_names=TIED_NODES,
    node_cpu_cap=[1000.0, 1000.0, 1000.0, 1000.0, 0.0, 1000.0],
    node_mem_cap=[4e9] * 6,
    node_alive=[True, True, True, True, True, False],
    # pods: service s on node n with CPU c
    pod_services=[0, 1, 2, 3, 0, 1, 4, 5, 2, 3],
    pod_nodes=[0, 0, 0, 1, 1, 1, 2, 3, 3, 3],
    pod_cpu=[150.0, 150.0, 100.0, 150.0, 150.0, 100.0, 305.0, 50.0, 50.0, 50.0],
    pod_mem=[1e6] * 10,
    node_base_cpu=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
)
TIED_RELATION = {"a": ["b", "c"], "b": ["a", "d"], "c": ["a"], "d": ["b", "e"],
                 "e": ["d"], "f": []}
TIED_NAMES = ["a", "b", "c", "d", "e", "f"]


def _random_kw(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    N, P = 7, 40
    return dict(
        node_names=[f"w{i}" for i in rng.permutation(N)],
        node_cpu_cap=rng.choice([800.0, 1000.0, 1200.0], size=N).tolist(),
        node_mem_cap=[8e9] * N,
        pod_services=rng.integers(0, 12, size=P).tolist(),
        pod_nodes=rng.integers(0, N, size=P).tolist(),
        pod_cpu=(rng.integers(1, 8, size=P) * 25.0).tolist(),
        pod_mem=[1e6] * P,
    )


def _random_relation(seed: int):
    rng = np.random.default_rng(seed + 100)
    names = [f"s{i}" for i in range(12)]
    rel = {n: [] for n in names}
    for _ in range(20):
        i, j = rng.integers(0, 12, size=2)
        if i != j:
            rel[names[i]].append(names[j])
    return rel, names


def _instance(name: str):
    """(jax state, jax graph, port state, port graph)."""
    if name in ("mubench", "mubench_balanced"):
        imb = name == "mubench"
        j = jtopo.mubench_scenario(imbalanced=imb)
        t = ttopo.mubench_scenario(imbalanced=imb, device="cpu")
        return j.state, j.graph, t.state, t.graph
    if name == "tied":
        kw, rel, names = TIED_KW, TIED_RELATION, TIED_NAMES
    else:
        seed = int(name.removeprefix("random"))
        kw, (rel, names) = _random_kw(seed), _random_relation(seed)
    return (jstate.ClusterState.build(**kw), jstate.CommGraph.from_relation(rel, names=names),
            tstate.ClusterState.build(**kw, device="cpu"),
            tstate.CommGraph.from_relation(rel, names=names, device="cpu"))


INSTANCES = ["mubench", "mubench_balanced", "tied", "random3", "random8"]


@pytest.mark.parametrize("threshold", [30.0, 30.9, 40.0, 5.0])
@pytest.mark.parametrize("name", INSTANCES)
def test_detect_hazard_matches_jax(name, threshold):
    j_state, _, t_state, _ = _instance(name)
    j_most, j_mask = jhazard.detect_hazard(j_state, threshold)
    t_most, t_mask = thazard.detect_hazard(t_state, threshold)
    assert int(t_most) == int(j_most)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))


def test_tied_instance_has_the_ties_it_claims():
    """The tied instance really ties: two nodes at 40%, one at 30.5% that
    rounds to 30, and the first most-hazardous node is index 0, not the
    equally loaded index 1."""
    _, _, t_state, _ = _instance("tied")
    pct = t_state.node_cpu_pct().tolist()
    assert pct[0] == pct[1] == 40.0 and pct[2] == 30.5
    from kubernetes_rescheduling_tpu_torch.objectives.metrics import node_cpu_pct_rounded

    assert node_cpu_pct_rounded(t_state).tolist()[:4] == [40, 40, 30, 15]
    most, mask = thazard.detect_hazard(t_state, 30.0)
    assert int(most) == 0 and mask.tolist() == [True, True, True, False, False, False]


@pytest.mark.parametrize("name", INSTANCES)
def test_pick_victim_and_group_match_jax(name):
    j_state, _, t_state, _ = _instance(name)
    for node in range(t_state.num_nodes):
        j_v = jvictim.pick_victim(j_state, jnp.asarray(node))
        t_v = tvictim.pick_victim(t_state, torch.tensor(node))
        assert int(t_v) == int(j_v), node
        np.testing.assert_array_equal(
            tvictim.deployment_group(t_state, t_v).numpy(),
            np.asarray(jvictim.deployment_group(j_state, j_v)),
        )
    # -1 (no victim) gives an empty group in both
    assert not tvictim.deployment_group(t_state, torch.tensor(-1)).any()
    assert not bool(jvictim.deployment_group(j_state, jnp.asarray(-1)).any())


def test_victim_ties_resolve_to_the_first_pod():
    """Node 0 of the tied instance holds two pods of 150m: pod 0 wins."""
    _, _, t_state, _ = _instance("tied")
    assert int(tvictim.pick_victim(t_state, torch.tensor(0))) == 0
    assert int(tvictim.pick_victim(t_state, torch.tensor(3))) == 7


LEX_CASES = {
    "all_tied": ([[1, 1, 1, 1], [2, 2, 2, 2]], [1, 1, 1, 1]),
    "first_key_tie_second_breaks": ([[3, 5, 5, 1], [0, 1, 2, 9]], [1, 1, 1, 1]),
    "both_tied_after_first": ([[3, 5, 5, 5], [0, 2, 2, 1]], [1, 1, 1, 1]),
    "best_masked_out": ([[9, 5, 5, 1], [0, 1, 1, 0]], [0, 1, 1, 1]),
    "empty_mask": ([[1, 2, 3, 4], [0, 0, 0, 0]], [0, 0, 0, 0]),
    "single_candidate": ([[1, 2, 3, 4], [0, 0, 0, 0]], [0, 0, 1, 0]),
    "negative_inf_keys": ([[-np.inf, -np.inf, 2, -np.inf], [1, 1, 1, 1]], [1, 1, 0, 1]),
    "float_ties": ([[0.1 + 0.2, 0.3, 0.30000001, 0.3], [0, 0, 0, 0]], [1, 1, 1, 1]),
}


@pytest.mark.parametrize("case", sorted(LEX_CASES))
def test_lex_argmax_on_tied_rows(case):
    keys, mask = LEX_CASES[case]
    j = jscoring.lex_argmax([jnp.asarray(np.float32(k)) for k in keys],
                            jnp.asarray(np.array(mask, bool)))
    t = tscoring.lex_argmax([torch.tensor(np.float32(k)) for k in keys],
                            torch.tensor(np.array(mask, bool)))
    assert int(t) == int(j)


def test_lex_argmax_random_ties_match_jax():
    """200 seeded rows of small integer keys (ties everywhere)."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 12))
        keys = [rng.integers(0, 3, size=n).astype(np.float32) for _ in range(2)]
        mask = rng.random(n) < 0.7
        j = jscoring.lex_argmax([jnp.asarray(k) for k in keys], jnp.asarray(mask))
        t = tscoring.lex_argmax([torch.from_numpy(k) for k in keys], torch.from_numpy(mask))
        assert int(t) == int(j)


@pytest.mark.parametrize("name", INSTANCES)
def test_node_features_match_jax(name):
    j_state, j_graph, t_state, t_graph = _instance(name)
    for svc in range(min(t_graph.num_services, 6)):
        jf = jscoring.node_features(j_state, j_graph, jnp.asarray(svc))
        tf = tscoring.node_features(t_state, t_graph, torch.tensor(svc, dtype=torch.int32))
        assert set(tf) == set(jf)
        for k in jf:
            np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]), err_msg=k)


@pytest.mark.parametrize("policy", jscoring.POLICY_NAMES)
@pytest.mark.parametrize("name", INSTANCES)
def test_choose_node_matches_jax(name, policy):
    """Every policy, every service, hazard mask from detection (and an
    all-hazard mask, where no node is a candidate). The ``random`` policy
    takes its gumbel row from jax's key."""
    j_state, j_graph, t_state, t_graph = _instance(name)
    pid = jscoring.POLICY_IDS[policy]
    _, j_mask = jhazard.detect_hazard(j_state, 30.0)
    masks = [np.asarray(j_mask), np.ones(t_state.num_nodes, bool)]
    for svc in range(t_graph.num_services):
        key = jax.random.PRNGKey(svc)
        g = np.asarray(jax.random.gumbel(key, (t_state.num_nodes,)))
        for m in masks:
            j = jscoring.choose_node(jnp.asarray(pid), j_state, j_graph, jnp.asarray(svc),
                                     jnp.asarray(m), key)
            t = tscoring.choose_node(pid, t_state, t_graph, torch.tensor(svc),
                                     torch.tensor(m), torch.from_numpy(g.copy()))
            assert int(t) == int(j), (svc, m.tolist())


def test_policy_tables_match_jax():
    assert tscoring.POLICY_NAMES == jscoring.POLICY_NAMES
    assert tscoring.POLICY_IDS == jscoring.POLICY_IDS
    from kubernetes_rescheduling_tpu.config import ForecastConfig

    for algo in (*jscoring.POLICY_NAMES, "proactive"):
        assert tproactive.scoring_policy(algo) == jproactive.scoring_policy(algo, ForecastConfig())
        assert (tproactive.scoring_policy_id(algo)
                == jproactive.scoring_policy_id(algo, ForecastConfig()))


@pytest.mark.parametrize("name", INSTANCES)
def test_policy_key_table_matches_jax(name):
    j_state, j_graph, t_state, t_graph = _instance(name)
    key = jax.random.PRNGKey(3)
    g = np.asarray(jax.random.gumbel(key, (t_state.num_nodes,)))
    jf = jscoring.node_features(j_state, j_graph, jnp.asarray(1))
    tf = tscoring.node_features(t_state, t_graph, torch.tensor(1))
    j1, j2 = jscoring.policy_key_table(jf, j_state, key)
    t1, t2 = tscoring.policy_key_table(tf, t_state, torch.from_numpy(g.copy()))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))
