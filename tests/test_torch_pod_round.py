"""The controller's pod round (``placement_unit="pod"``) and the simulator
calls it and the reconcile plane need (``apply_pod_moves``,
``external_move``, ``restore_placement``, the boundary's passthrough),
against the JAX package on the CPU.

The pod solve's per-sweep plans come from jax's key stream: the JAX pod
round solves with ``fold_in(PRNGKey(seed), round)`` on the pod-level graph,
which the sparse solver hands to the dense one when it is one block.

Bars: every record's services moved, landings, objectives and costs are
exactly equal (integer pair weights); the load spread within rel 1e-6 (an
f32 standard deviation whose reductions may run in another order); the
simulator's event logs are equal.
"""

import json
import random

import jax
import numpy as np
import pytest
from test_torch_controller import DECISIONS, assert_same_records
from test_torch_global_solver import jax_plan
from test_torch_sparse_solver import jax_sparse_plan
from test_torch_state import assert_state_equal

from kubernetes_rescheduling_tpu.backends.base import MoveRequest as JMove
from kubernetes_rescheduling_tpu.backends.sim import LoadModel as JLoad
from kubernetes_rescheduling_tpu.backends.sim import SimBackend as JSim
from kubernetes_rescheduling_tpu.bench.boundary import BoundaryClient as JBoundary
from kubernetes_rescheduling_tpu.bench.controller import run_controller as j_run
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.core import topology as jtopo
from kubernetes_rescheduling_tpu.core import workmodel as jwm
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu_torch.backends.base import MoveRequest as TMove
from kubernetes_rescheduling_tpu_torch.backends.sim import LoadModel as TLoad
from kubernetes_rescheduling_tpu_torch.backends.sim import SimBackend as TSim
from kubernetes_rescheduling_tpu_torch.bench.boundary import BoundaryClient as TBoundary
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.core import topology as ttopo
from kubernetes_rescheduling_tpu_torch.core import workmodel as twm
from kubernetes_rescheduling_tpu_torch.objectives import communication_cost
from kubernetes_rescheduling_tpu_torch.solver import sparse_solver as tss
from kubernetes_rescheduling_tpu_torch.solver.global_solver import GlobalSolverConfig
from kubernetes_rescheduling_tpu_torch.solver.pod_mode import pod_level_graph
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry


def synthetic_backends(n_pods=240, n_nodes=8, replicas=3, seed=1):
    """Simulators over ``synthetic_scenario(n_pods, n_nodes, replicas=...,
    seed=...)``'s mesh and skewed placement (a quarter of the pods piled on
    the first node), in both packages."""
    out = []
    for topo, sim, load, dev in ((jtopo, JSim, JLoad, {}), (ttopo, TSim, TLoad,
                                                          {"device": "cpu"})):
        wm = topo._random_workmodel(n_pods // replicas, np.random.default_rng(seed),
                                    powerlaw=False, mean_degree=6.0, replicas=replicas)
        scn = topo.synthetic_scenario(n_pods=n_pods, n_nodes=n_nodes, replicas=replicas,
                                      seed=seed, **dev)
        b = sim(workmodel=wm, node_names=list(scn.state.node_names), seed=seed,
                load=load(idle_m=40.0, cost_per_req_m=5.0, fanout_frac=0.25), **dev)
        placement = np.asarray(scn.state.pod_node)
        for pod, node in zip(b._pods, placement):
            pod[1] = int(node)
        out.append(b)
    return out


def stuck_backends():
    """tests/test_pod_mode.py:145's capacity-stuck fixture: A (4 replicas)
    calls B, every A pod away from B, and no 250m node can take A's whole
    400m Deployment."""
    out = []
    for wm_mod, sim in ((jwm, JSim), (twm, TSim)):
        wm = wm_mod.Workmodel(services=(
            wm_mod.ServiceSpec(name="A", callees=("B",), replicas=4, cpu_request_millicores=100),
            wm_mod.ServiceSpec(name="B", replicas=1, cpu_request_millicores=100),
        ), source="test")
        kw = {"device": "cpu"} if sim is TSim else {}
        b = sim(workmodel=wm, node_names=["n0", "n1", "n2", "n3"], node_cpu_cap_m=250.0,
                seed=0, **kw)
        for pod in b._pods:
            pod[1] = {"A-0": 1, "A-1": 1, "A-2": 2, "A-3": 2, "B-0": 0}[pod[2]]
        out.append(b)
    return out


def pod_plans(backend, seed: int, cfg: GlobalSolverConfig):
    """The pod solve's plans of each round from jax's key stream, on the
    pod-level graph of the backend's pod set."""
    state = backend.monitor()
    pod_graph = pod_level_graph(state, backend.comm_graph())
    N = state.num_nodes

    def plans(rnd: int):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
        if pod_graph.num_blocks <= 1:
            return jax_plan(key, jgs.GlobalSolverConfig(sweeps=cfg.sweeps),
                            pod_graph.num_services, N, inline=False)
        return jax_sparse_plan(key, cfg.sweeps, tss.sparse_layout(pod_graph, cfg), N)

    return plans


def pod_pair(backends, seed=0, rounds=3, **kw):
    jb, tb = backends
    base = dict(algorithm="global", placement_unit="pod", max_rounds=rounds,
                sleep_after_action_s=0.0, seed=seed, **kw)
    j = j_run(jb, JConfig(**base), registry=JRegistry())
    tcfg = TConfig(**base)
    t = t_run(tb, tcfg, device="cpu", registry=TRegistry(),
              solver_plans=pod_plans(tb, seed, GlobalSolverConfig(sweeps=tcfg.global_solver_iters)))
    return j, t


@pytest.mark.parametrize("fixture", ["synthetic", "stuck"])
def test_pod_round_matches_jax(fixture):
    """Three pod rounds: the services moved, the replica landings, the
    objectives and the costs equal the JAX package's, one ``pod_moves``
    wave in each round that moved, and the cost ends below its start. The
    stuck fixture runs with capacity enforced, where only a split of A's
    replicas helps."""
    kw = {} if fixture == "synthetic" else dict(enforce_capacity=True, capacity_frac=1.0)
    backends = synthetic_backends() if fixture == "synthetic" else stuck_backends()
    jb, tb = backends
    graph = tb.comm_graph()
    before = float(communication_cost(tb.monitor(), graph))
    j, t = pod_pair(backends, **kw)
    assert_same_records(t, j)
    assert tb.events == jb.events and tb.clock_s == jb.clock_s
    assert_state_equal(tb.monitor(), jb.monitor())
    # one pod_moves wave in each round that moved, none in the others
    waves = [e for e in tb.events if e["event"] == "pod_moves"]
    moved = [r for r in t.rounds if r.moved]
    assert len(t.rounds) == 3 and len(waves) == len(moved)
    assert [e["pods"] for e in waves] == [len(r.applied_moves) for r in moved]
    assert t.rounds[0].moved
    for r in t.rounds:
        assert r.objective_after <= r.objective_before
    after = float(communication_cost(tb.monitor(), graph))
    assert after < before
    if fixture == "stuck":
        # the budget holds on the realized cluster, not only in the plan
        assert float(tb.monitor().node_cpu_used().max()) <= 250.0 + 1e-6


def test_pod_round_config_rules_match_jax():
    for kw in (dict(algorithm="communication", placement_unit="pod"),
               dict(algorithm="global", placement_unit="pod", global_moves_cap=2)):
        with pytest.raises(ValueError) as j_err:
            JConfig(**kw).validate()
        with pytest.raises(ValueError) as t_err:
            TConfig(**kw).validate()
        assert str(t_err.value).split(" (")[0] == str(j_err.value).split(" (")[0]


def test_pod_graph_cache_rebuilds_on_a_new_pod_set():
    """The pod graph is cached on the raw backend per (graph, pod set): a
    second run reuses it, and a changed pod set rebuilds it."""
    _, tb = synthetic_backends()
    cfg = TConfig(algorithm="global", placement_unit="pod", max_rounds=1,
                  sleep_after_action_s=0.0, reconcile_enabled=False)
    t_run(tb, cfg, device="cpu", registry=TRegistry())
    slot = tb._solver_caches[("pod_graph", None)]
    first = slot["value"]
    t_run(tb, cfg, device="cpu", registry=TRegistry())
    assert slot["value"] is first
    tb._pods.pop()  # one pod fewer
    tb._service_pods = [[p for p in pods if p in tb._pods] for pods in tb._service_pods]
    t_run(tb, cfg, device="cpu", registry=TRegistry())
    assert slot["value"] is not first


def test_sim_pod_waves_external_moves_and_restore_match_jax():
    jb, tb = synthetic_backends(n_pods=60, n_nodes=5)
    names = [p[2] for p in tb._pods]
    nodes = tb.node_names
    moves = [dict(service=n.rsplit("-", 1)[0], pod=n, target_node=nodes[i % 5])
             for i, n in enumerate(names[::3])]
    moves.append(dict(service="s0", pod="nope-0", target_node=nodes[1]))
    moves.append(dict(service="s1", pod=names[1], target_node="worker9999"))
    assert tb.apply_pod_moves([TMove(**m) for m in moves]) == jb.apply_pod_moves(
        [JMove(**m) for m in moves])
    saved = tb.monitor()
    for seed in range(4):
        assert tb.external_move_random(random.Random(seed)) == jb.external_move_random(
            random.Random(seed))
    assert tb.external_move(names[0], nodes[2]) == jb.external_move(names[0], nodes[2])
    assert tb.external_move(names[0], "nowhere") is jb.external_move(names[0], "nowhere") \
        is False
    assert_state_equal(tb.monitor(), jb.monitor())
    j_saved = jb.monitor().replace(pod_node=jax.numpy.asarray(saved.pod_node.numpy()))
    assert tb.restore_placement(saved) == jb.restore_placement(j_saved)
    assert_state_equal(tb.monitor(), jb.monitor())
    assert tb.events == jb.events and tb.clock_s == jb.clock_s
    # successive snapshots share their name tuples (the guard's memos)
    assert tb.monitor().pod_names is tb.monitor().pod_names


def test_boundary_passthrough_and_raw_backend():
    """Calls the boundary does not wrap reach the backend un-retried, and
    the raw backend unwraps ``inner`` layers, as in the JAX package."""
    jb, tb = stuck_backends()

    class Layer:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, name):
            return getattr(self.inner, name)

    for sim, boundary_cls, move in ((jb, JBoundary, JMove), (tb, TBoundary, TMove)):
        bc = boundary_cls(Layer(Layer(sim)))
        assert bc.raw_backend is sim
        assert bc.apply_pod_moves([move(service="A", pod="A-0", target_node="n0")]) == {
            "A-0": "n0"}
        assert bc.external_move("B-0", "n3") is True
        bc.admission_reject("duplicate_pod")
        assert bc.round_failures == bc.total_failures == 1
        bc.solver_cache("pod_graph")["x"] = 1
        assert sim._solver_caches[next(iter(sim._solver_caches))] == {"x": 1}
    assert tb.events == jb.events


def test_pod_records_name_the_jax_keys():
    """The pod round's record carries the JAX record's keys."""
    j, t = pod_pair(stuck_backends(), rounds=1, enforce_capacity=True)
    assert set(t.rounds[0].as_dict()) - {"phase_s"} <= set(j.rounds[0].as_dict())
    assert all(getattr(t.rounds[0], k) == getattr(j.rounds[0], k) for k in DECISIONS)


def test_cli_placement_unit_pod(capsys):
    """``reschedule --placement-unit pod`` as in the JAX command."""
    from kubernetes_rescheduling_tpu_torch import cli

    assert cli.main(["reschedule", "--algorithm", "global", "--scenario", "mubench",
                     "--rounds", "2", "--placement-unit", "pod",
                     "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert len(out["rounds"]) == 2 and out["moves"] >= 1
    assert all(r["objective_after"] <= r["objective_before"] for r in out["rounds"])
    with pytest.raises(SystemExit, match="requires algorithm='global'"):
        cli.main(["reschedule", "--placement-unit", "pod", "--device", "cpu"])
