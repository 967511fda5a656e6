"""The simulator's device twin (``backends/sim_device.py``) against the JAX
package's twin and against the port's own simulator, after
tests/test_scan.py's oracle tests.

The same seeded simulators are built in both packages (the same
``default_rng`` call sequence), so states, decisions and landings must be
EQUAL: ``scheduler_choice`` and ``apply_decision`` on a snapshot, pinned and
``affinityOnly``, before and after churn; and seeded move trajectories
through :func:`sim_step` give the placements and loads the port's
``SimBackend`` serves after the same moves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu.backends import sim as jsim
from kubernetes_rescheduling_tpu.backends import sim_device as jsd
from kubernetes_rescheduling_tpu.backends.base import MoveRequest as JMove
from kubernetes_rescheduling_tpu.core import state as jstate
from kubernetes_rescheduling_tpu.core import workmodel as jwm
from kubernetes_rescheduling_tpu_torch import convert
from kubernetes_rescheduling_tpu_torch.backends import sim as tsim
from kubernetes_rescheduling_tpu_torch.backends import sim_device as tsd
from kubernetes_rescheduling_tpu_torch.backends.base import MoveRequest as TMove
from kubernetes_rescheduling_tpu_torch.core import workmodel as twm

# timing-only record fields: everything else of a record must be equal
TIMING = {"decision_latencies_s", "decision_latency_s", "wall_s", "phase_s", "pipeline"}


def strip(record) -> dict:
    return {k: v for k, v in record.as_dict().items() if k not in TIMING}


def to_jax_state(t_state):
    """The JAX package's ClusterState of a port snapshot, array for array."""
    return jstate.ClusterState(
        **{k: jnp.asarray(getattr(t_state, k).cpu().numpy()) for k in convert.STATE_ARRAYS},
        node_names=t_state.node_names, pod_names=t_state.pod_names,
    )


def sim_pair(n_nodes: int, seed: int = 0, cap_m: float = 20_000.0, prefix: str = "sn"):
    """tests/test_scan.py's simulator in both packages: µBench on
    ``n_nodes`` nodes, every pod piled on the first."""
    out = []
    for sim, wm in ((jsim, jwm), (tsim, twm)):
        kw = {} if sim is jsim else {"device": "cpu"}
        b = sim.SimBackend(
            workmodel=wm.mubench_workmodel_c(),
            node_names=[f"{prefix}{i}" for i in range(n_nodes)],
            node_cpu_cap_m=cap_m, seed=seed,
            load=sim.LoadModel(entry_rps=100.0, cost_per_req_m=8.0, idle_m=50.0), **kw,
        )
        b.inject_imbalance(b.node_names[0])
        out.append(b)
    return out


def churn_both(jb, tb) -> None:
    """The same churn on both simulators: a drained node, a deploy, a
    teardown (index compaction) and a scale-up, under padded capacities."""
    for b, wm in ((jb, jwm), (tb, twm)):
        b.set_capacities(node=32, pod=64, service=32)
        b.drain_node(b.node_names[3])
        b.deploy_service(wm.ServiceSpec(name="extra", callees=("s1", "s4"), replicas=2))
        b.teardown_service("s2")
        b.scale_replicas("s5", 3)


@pytest.mark.parametrize("churned", [False, True])
@pytest.mark.parametrize("seed", [1, 4])
def test_scheduler_choice_matches_jax_and_the_simulator(seed, churned):
    """The least-allocated node among alive, non-excluded ones — the first
    of equals — as the JAX twin and the simulator's own choice pick it; -1
    when nothing is eligible."""
    jb, tb = sim_pair(17, seed=seed)
    if churned:
        churn_both(jb, tb)
    t_state, _ = tsd.twin_of(tb)
    j_state = to_jax_state(t_state)
    n = t_state.num_nodes
    rng = np.random.default_rng(seed)
    sets = [(), (0, 1), (0, 1, 2, 4)] + [tuple(rng.choice(17, size=5, replace=False))
                                           for _ in range(4)]
    for excl in sets:
        hazard = np.zeros(n, dtype=bool)
        hazard[list(excl)] = True
        got = int(tsd.scheduler_choice(t_state, torch.from_numpy(hazard)))
        assert got == int(jsd.scheduler_choice(j_state, jnp.asarray(hazard)))
        want = tb._scheduler_choice(exclude=tuple(tb.node_names[j] for j in excl))
        assert got == (-1 if want is None else want)
    assert int(tsd.scheduler_choice(t_state, torch.ones(n, dtype=torch.bool))) == -1


@pytest.mark.parametrize("churned", [False, True])
@pytest.mark.parametrize("pinned", [True, False])
def test_apply_decision_matches_jax(pinned, churned):
    """Seeded decisions — live targets, a drained target, no-op victims and
    targets — give the JAX twin's new placement, landing and moved flag."""
    jb, tb = sim_pair(16, seed=3)
    if churned:
        churn_both(jb, tb)
    t_state, _ = tsd.twin_of(tb)
    j_state = to_jax_state(t_state)
    rng = np.random.default_rng(5)
    valid = np.flatnonzero(t_state.pod_valid.numpy())
    n = t_state.num_nodes
    for _ in range(30):
        victim = int(rng.choice(valid)) if rng.random() > 0.15 else -1
        target = int(rng.integers(-1, n))
        hazard = rng.random(n) < 0.3
        t_out = tsd.apply_decision(t_state, torch.tensor(victim), torch.tensor(0),
                                   torch.tensor(target), torch.from_numpy(hazard),
                                   pinned=pinned)
        j_out = jsd.apply_decision(j_state, jnp.asarray(victim), jnp.asarray(0),
                                   jnp.asarray(target), jnp.asarray(hazard), pinned=pinned)
        np.testing.assert_array_equal(t_out[0].pod_node.numpy(), np.asarray(j_out[0].pod_node))
        assert int(t_out[1]) == int(j_out[1]) and bool(t_out[2]) == bool(j_out[2])
        t_state, j_state = t_out[0], j_out[0]


@pytest.mark.parametrize("seed", [7, 11])
def test_sim_step_follows_the_simulator(seed):
    """tests/test_scan.py:156 on the port: a seeded 24-round trajectory
    through :func:`sim_step` and through the simulator stays equal —
    placements and loads — across pinned moves onto full nodes, moves aimed
    at a drained node (no-ops on both sides) and the affinityOnly landing."""
    _, tb = sim_pair(16, seed=seed, cap_m=700.0)   # tiny capacities: nodes run full
    tb.drain_node(tb.node_names[5])                 # a dead target to aim at
    state, _ = tsd.twin_of(tb)
    assert torch.equal(state.pod_node, tb.monitor().pod_node)
    rng = np.random.default_rng(seed)
    svc_arr, valid, n = state.pod_service.numpy(), state.pod_valid.numpy(), state.num_nodes
    for rnd in range(24):
        svc = int(rng.integers(len(tb.workmodel.services)))
        victim = int(np.flatnonzero(valid & (svc_arr == svc))[0])
        target = 5 if rnd % 4 == 3 else int(rng.integers(n))
        affinity = rnd % 3 == 1
        hazard = np.zeros(n, dtype=bool)
        hazard[rng.choice(n, size=4, replace=False)] = True
        state, snap = tsd.sim_step(
            state, (torch.tensor(victim), torch.tensor(svc), torch.tensor(target),
                    torch.from_numpy(hazard)), pinned=not affinity)
        tb.apply_move(TMove(
            service=tb.workmodel.services[svc].name, target_node=tb.node_names[target],
            hazard_nodes=tuple(tb.node_names[j] for j in np.flatnonzero(hazard)),
            mechanism="affinityOnly" if affinity else "nodeName"))
        observed = tb.monitor()
        assert torch.equal(snap.pod_node, observed.pod_node), rnd
        assert torch.equal(snap.pod_valid, observed.pod_valid), rnd
        assert torch.equal(snap.pod_cpu, observed.pod_cpu), rnd


def test_twin_after_churn_tracks_the_simulator():
    """tests/test_scan.py:211 on the port: after deploys, a teardown (index
    compaction) and autoscaling under a padded service bucket, a rebuilt
    twin scores the layout the backend serves and tracks it move for move;
    and it equals the JAX package's twin of the same simulator."""
    jb, tb = sim_pair(4, seed=3)
    churn_both(jb, tb)
    state, graph = tsd.twin_of(tb)
    j_state, j_graph = jsd.twin_of(jb)
    np.testing.assert_array_equal(graph.adj.numpy(), np.asarray(j_graph.adj))
    assert graph.names == tuple(j_graph.names) == tb.comm_graph().names
    for k in convert.STATE_ARRAYS:
        np.testing.assert_array_equal(getattr(state, k).numpy(), np.asarray(getattr(j_state, k)))
    g2, idx = tsim.workload_layout(tb.workmodel, tb.service_capacity, "cpu")
    assert g2.names == graph.names and graph.num_services == 32
    svc_arr, valid = state.pod_service.numpy(), state.pod_valid.numpy()
    alive = tb.alive_node_names()
    for rnd, name in enumerate(("s1", "s5", "extra", "s19")):
        svc = idx[name]
        victim = int(np.flatnonzero(valid & (svc_arr == svc))[0])
        target = tb.node_names.index(alive[rnd % len(alive)])
        hazard = torch.zeros(state.num_nodes, dtype=torch.bool)
        state, snap = tsd.sim_step(state, (torch.tensor(victim), torch.tensor(svc),
                                           torch.tensor(target), hazard))
        tb.apply_move(TMove(service=name, target_node=tb.node_names[target],
                            mechanism="nodeName"))
        jb.apply_move(JMove(service=name, target_node=jb.node_names[target],
                            mechanism="nodeName"))
        observed = tb.monitor()
        assert torch.equal(snap.pod_node, observed.pod_node), name
        np.testing.assert_array_equal(observed.pod_node.numpy(),
                                      np.asarray(jb.monitor().pod_node))


def test_scan_compatible_only_for_a_raw_noise_free_simulator():
    _, tb = sim_pair(4)
    assert tsd.scan_compatible(tb) is True
    tb.load.noise_frac = 0.1
    assert tsd.scan_compatible(tb) is False

    class Wrapped:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, name):
            return getattr(self.inner, name)

    _, tb2 = sim_pair(4)
    assert tsd.scan_compatible(Wrapped(tb2)) is False
