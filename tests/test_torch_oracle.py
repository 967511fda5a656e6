"""The port's dict-world reference oracle against the JAX package's, on
seeded µBench and power-law snapshots: every function's answer is exactly
equal (the snapshots hold the same f32 loads, summed in pod order by both
packages, so the rounded percentages, the tie-breaks and the costs agree
bit for bit)."""

import dataclasses

import numpy as np
import pytest

from kubernetes_rescheduling_tpu import oracle as joracle
from kubernetes_rescheduling_tpu.core import topology as jtopo
from kubernetes_rescheduling_tpu_torch import oracle as toracle
from kubernetes_rescheduling_tpu_torch.core import topology as ttopo

SCENARIOS = {
    "mubench": lambda topo, **kw: topo.mubench_scenario(imbalanced=True, seed=3, **kw),
    "mubench_balanced": lambda topo, **kw: topo.mubench_scenario(imbalanced=False, seed=1,
                                                                 **kw),
    "powerlaw": lambda topo, **kw: topo.synthetic_scenario(
        n_pods=300, n_nodes=12, powerlaw=True, mean_degree=4.0, seed=5, **kw),
    "powerlaw_replicas": lambda topo, **kw: topo.synthetic_scenario(
        n_pods=240, n_nodes=9, powerlaw=True, replicas=3, seed=8, **kw),
}


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def snapshots(request):
    make = SCENARIOS[request.param]
    j_scn, t_scn = make(jtopo), make(ttopo, device="cpu")
    return (joracle.to_snapshot(j_scn.state, j_scn.graph),
            toracle.to_snapshot(t_scn.state, t_scn.graph),
            t_scn.graph.to_relation())


def test_to_snapshot_equal(snapshots):
    j, t, _ = snapshots
    assert t.nodes_name == j.nodes_name
    assert [dataclasses.asdict(p) for p in t.pods] == [dataclasses.asdict(p) for p in j.pods]
    assert t.cluster == j.cluster


@pytest.mark.parametrize("threshold", [0.0, 10.0, 30.0, 60.0, 101.0])
def test_detection_equal(snapshots, threshold):
    j, t, _ = snapshots
    assert toracle.detection(t, threshold) == joracle.detection(j, threshold)


def test_pick_max_pod_equal_on_every_node(snapshots):
    j, t, _ = snapshots
    for node in j.nodes_name + ["absent-node"]:
        jp, tp = joracle.pick_max_pod(j, node), toracle.pick_max_pod(t, node)
        assert (tp is None and jp is None) or dataclasses.asdict(tp) == dataclasses.asdict(jp)


def _hazard_sets(snap):
    """Hazard lists to choose under: the detected one at 30 %, none, and
    every node but the last (the candidates then tie-break among one)."""
    return [joracle.detection(snap, 30.0)[1], [], snap.nodes_name[:-1]]


@pytest.mark.parametrize("policy", ["spread", "binpack", "kubescheduling"])
def test_choose_equal(snapshots, policy):
    j, t, _ = snapshots
    for hazard in _hazard_sets(j):
        if len(hazard) == len(j.nodes_name):
            continue
        got = getattr(toracle, f"choose_{policy}")(t, hazard)
        assert got == getattr(joracle, f"choose_{policy}")(j, hazard)


def test_choose_random_equal_on_one_stream(snapshots):
    j, t, _ = snapshots
    hazard = joracle.detection(j, 30.0)[1]
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    assert [toracle.choose_random(t, hazard, tr) for _ in range(20)] == \
        [joracle.choose_random(j, hazard, jr) for _ in range(20)]


def test_choose_communication_equal_for_every_service(snapshots):
    j, t, rel = snapshots
    for hazard in _hazard_sets(j):
        for svc in sorted({p.service for p in j.pods}):
            assert toracle.choose_communication(t, rel, svc, hazard) == \
                joracle.choose_communication(j, rel, svc, hazard)


def test_all_hazard_raises_in_both(snapshots):
    j, t, rel = snapshots
    every = list(j.nodes_name)
    for pkg, snap in ((joracle, j), (toracle, t)):
        with pytest.raises(RuntimeError, match="No candidate nodes"):
            pkg.choose_spread(snap, every)
        with pytest.raises(RuntimeError, match="No candidate nodes"):
            pkg.choose_communication(snap, rel, snap.pods[0].service, every)


def test_cost_and_std_equal(snapshots):
    j, t, rel = snapshots
    assert toracle.communication_cost(t, rel) == joracle.communication_cost(j, rel)
    assert toracle.node_std(t) == joracle.node_std(j)


def test_exports_match_the_jax_oracle():
    assert set(joracle.__all__) <= set(toracle.__all__)
    assert set(toracle.__all__) - set(joracle.__all__) == {"forecast"}
