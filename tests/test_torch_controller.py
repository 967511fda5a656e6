"""The port's control loop against the JAX package's: the simulator, the
boundary and breaker, the greedy and global ``run_controller`` and the
``reschedule`` command, on the patterns of tests/test_bench.py and
tests/test_resilience.py.

Randomness comes from JAX's own key stream: the ``random`` policy's noise
row of each decision is ``gumbel(sub, (N,))`` for the ``sub`` keys that
``_greedy_round`` splits off ``fold_in(PRNGKey(seed), round)``, and each
global round's per-sweep plans are built from that round's key as
tests/test_torch_global_solver.py::jax_plan and
tests/test_torch_sparse_solver.py::jax_sparse_plan build them.

Bars: decisions (hazard node, moved services, targets, landings, breaker
state, skips) and the simulator's event log are exactly equal; the
communication cost is exactly equal (integer pair counts); the load spread
is within rel 1e-6 (an f32 standard deviation whose reductions may run in
another order); global rounds' objectives are exactly equal.

Under faults the JAX runs turn the reconcile and admission planes off
while the port runs at its default (both on); on these faults the planes
change no decision (``test_jax_planes_left_out_do_not_move_decisions``),
and ``test_default_config_matches_jax_default`` holds the defaults to each
other.
"""

import json

import jax
import numpy as np
import pytest
import torch
from test_torch_global_solver import jax_plan
from test_torch_sparse_solver import jax_sparse_plan
from test_torch_state import assert_graph_equal, assert_state_equal

from kubernetes_rescheduling_tpu.backends import sim as jsim
from kubernetes_rescheduling_tpu.backends.base import MoveRequest as JMove
from kubernetes_rescheduling_tpu.bench.controller import run_controller as j_run
from kubernetes_rescheduling_tpu.bench.harness import make_backend as j_make
from kubernetes_rescheduling_tpu.cli import main as j_cli
from kubernetes_rescheduling_tpu.config import ReconcileConfig
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu.utils.retry import RetryPolicy as JRetry
from kubernetes_rescheduling_tpu_torch import cli as t_cli
from kubernetes_rescheduling_tpu_torch.backends.base import MoveRequest as TMove
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend as t_make
from kubernetes_rescheduling_tpu_torch.config import FleetConfig as TFleetConfig
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.config import ServingConfig as TServingConfig
from kubernetes_rescheduling_tpu_torch.config import ShadowConfig as TShadowConfig
from kubernetes_rescheduling_tpu_torch.core.sparsegraph import from_comm_graph
from kubernetes_rescheduling_tpu_torch.objectives import communication_cost
from kubernetes_rescheduling_tpu_torch.solver import sparse_solver as tss
from kubernetes_rescheduling_tpu_torch.solver.global_solver import GlobalSolverConfig
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry
from kubernetes_rescheduling_tpu_torch.utils.retry import RetryPolicy as TRetry

DECISIONS = ("round", "moved", "most_hazard", "service", "target", "services_moved",
             "applied_moves", "degraded", "breaker_state", "boundary_failures",
             "objective_before", "objective_after", "solver_improved")
NO_PLANES = dict(reconcile=ReconcileConfig(enabled=False, admission=False))


def jax_greedy_gumbel(seed: int, n: int):
    """The noise row of decision ``i`` of round ``rnd`` in the JAX loop:
    ``key = fold_in(PRNGKey(seed), rnd)``, then ``key, sub = split(key)``
    once per decision."""
    def rows(rnd: int, i: int) -> torch.Tensor:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
        for _ in range(i + 1):
            key, sub = jax.random.split(key)
        return torch.tensor(np.asarray(jax.random.gumbel(sub, (n,))))
    return rows


def assert_same_records(t_result, j_result):
    assert len(t_result.rounds) == len(j_result.rounds)
    for t, j in zip(t_result.rounds, j_result.rounds):
        for k in DECISIONS:
            assert getattr(t, k) == getattr(j, k), (t.round, k)
        assert t.communication_cost == j.communication_cost, t.round
        assert t.load_std == pytest.approx(j.load_std, rel=1e-6), t.round
    assert t_result.skipped_rounds == j_result.skipped_rounds
    assert t_result.breaker_transitions == j_result.breaker_transitions
    assert t_result.boundary_failures == j_result.boundary_failures


def greedy_pair(policy: str, k: int, seed: int = 1, rounds: int = 8, registry=None):
    """tests/test_bench.py:51's run in both packages: µBench with the
    cordon imbalance on worker1."""
    jb, tb = j_make("mubench", seed), t_make("mubench", seed, device="cpu")
    jb.inject_imbalance("worker1")
    tb.inject_imbalance("worker1")
    kw = dict(algorithm=policy, max_rounds=rounds, sleep_after_action_s=0.0, seed=seed,
              moves_per_round=k)
    j = j_run(jb, JConfig(**kw), registry=JRegistry())
    t = t_run(tb, TConfig(**kw), device="cpu", registry=registry or TRegistry(),
              gumbel_rows=jax_greedy_gumbel(seed, len(tb.node_names)))
    return jb, tb, j, t


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("policy", ["spread", "binpack", "random", "kubescheduling",
                                    "communication"])
def test_greedy_controller_matches_jax(policy, k):
    jb, tb, j, t = greedy_pair(policy, k)
    assert_same_records(t, j)
    assert tb.events == jb.events
    assert tb.clock_s == jb.clock_s
    assert_state_equal(tb.monitor(), jb.monitor())
    assert len(t.rounds) == 8 and t.moves >= 1 and t.decisions_per_sec > 0
    if k == 3:
        assert max(len(r.services_moved) for r in t.rounds) > 1


def test_jax_planes_left_out_do_not_move_decisions():
    """On a clean simulator the JAX run at its default config (reconcile
    and admission on) decides exactly as with both planes off — the planes
    this port leaves out change no decision here."""
    runs = []
    for extra in ({}, NO_PLANES):
        jb = j_make("mubench", 1)
        jb.inject_imbalance("worker1")
        runs.append(j_run(jb, JConfig(algorithm="communication", max_rounds=8,
                                      sleep_after_action_s=0.0, seed=1, moves_per_round=3,
                                      **extra), registry=JRegistry()))
    a, b = runs
    for ra, rb in zip(a.rounds, b.rounds):
        for k in DECISIONS:
            assert getattr(ra, k) == getattr(rb, k), k
        assert ra.communication_cost == rb.communication_cost


def test_controller_host_reads_per_round():
    """One batched fence per decision, one round-end transfer per executed
    round, and — with admission on, the default — one admission read per
    monitor (the startup probe and each round's post-move snapshot); with
    admission off, none. Nothing else is read back."""
    reg = TRegistry()
    _, _, _, t = greedy_pair("communication", 3, registry=reg)
    decisions = sum(r.decisions for r in t.rounds)
    assert reg.value("device_transfers_total", site="fence") == decisions
    assert reg.value("device_transfers_total", site="round_end") == len(t.rounds)
    assert reg.value("device_transfers_total", site="admission") == len(t.rounds) + 1
    assert reg.value("device_transfers_total", site="reconcile") == 0
    assert reg.value("rounds_total", algorithm="communication") == len(t.rounds)
    assert reg.value("services_moved_total", algorithm="communication") == sum(
        len(r.services_moved) for r in t.rounds)
    tb = t_make("mubench", 1, device="cpu")
    tb.inject_imbalance("worker1")
    off = TRegistry()
    t_run(tb, TConfig(algorithm="communication", max_rounds=8, sleep_after_action_s=0.0,
                      seed=1, moves_per_round=3, reconcile_admission=False,
                      reconcile_enabled=False), device="cpu", registry=off)
    assert off.value("device_transfers_total", site="admission") == 0
    for site in ("fence", "round_end"):
        assert off.value("device_transfers_total", site=site) == reg.value(
            "device_transfers_total", site=site)


@pytest.mark.parametrize("algorithm", ["communication", "global"])
def test_default_config_matches_jax_default(algorithm):
    """The port's default config is the JAX package's default on the sim
    loop (admission and the intent ledger on, explanations on with a
    logger): the same records, reconcile blocks included."""
    seed = 2
    jb, tb = j_make("mubench", seed), t_make("mubench", seed, device="cpu")
    jb.inject_imbalance("worker1")
    tb.inject_imbalance("worker1")
    kw = dict(algorithm=algorithm, max_rounds=3, sleep_after_action_s=0.0, seed=seed)
    assert (TConfig().reconcile_admission, TConfig().reconcile_enabled,
            TConfig().repair_budget_per_round, TConfig().max_quarantine_frac,
            TConfig().explain, TConfig().explain_top_k) == (
        JConfig().reconcile.admission, JConfig().reconcile.enabled,
        JConfig().reconcile.repair_budget_per_round, JConfig().reconcile.max_quarantine_frac,
        JConfig().obs.explain, JConfig().obs.explain_top_k)
    j = j_run(jb, JConfig(**kw), registry=JRegistry())
    seam = ({"solver_plans": _global_plans(tb, seed, 9, "dense")[0]} if algorithm == "global"
            else {"gumbel_rows": jax_greedy_gumbel(seed, 3)})
    t = t_run(tb, TConfig(**kw), device="cpu", registry=TRegistry(), **seam)
    assert_same_records(t, j)
    assert [r.reconcile for r in t.rounds] == [r.reconcile for r in j.rounds]
    assert tb.events == jb.events


def _global_plans(backend, seed: int, sweeps: int, solver_backend: str):
    graph = backend.comm_graph()
    S, N = graph.num_services, len(backend.node_names)
    sgraph = from_comm_graph(graph)
    layout = tss.sparse_layout(sgraph, GlobalSolverConfig(sweeps=sweeps))

    def plans(rnd: int):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
        if solver_backend == "sparse" and sgraph.num_blocks > 1:
            return jax_sparse_plan(key, sweeps, layout, N)
        # dense rounds, and sparse graphs of one block (which the sparse
        # solver hands to the dense one)
        return jax_plan(key, jgs.GlobalSolverConfig(sweeps=sweeps), S, N, inline=False)

    return plans, sgraph.num_blocks


@pytest.mark.parametrize("scenario,solver_backend,sweeps", [
    ("mubench", "dense", 9),
    ("mubench", "sparse", 9),
    # 8 blocks: the sparse solver proper. 3 sweeps (one swap sweep) keep
    # the JAX compile of the 2000-service solve short
    ("powerlaw", "sparse", 3),
    ("powerlaw", "dense", 3),
])
def test_global_controller_matches_jax(scenario, solver_backend, sweeps):
    """tests/test_bench.py:73's run (2 global rounds, seed 2) in both
    packages, at balance weight 0: placements, moved services, objectives
    and costs equal, and the cost never rises."""
    seed = 2
    jb, tb = j_make(scenario, seed), t_make(scenario, seed, device="cpu")
    before = float(communication_cost(tb.monitor(), tb.comm_graph()))
    kw = dict(algorithm="global", max_rounds=2, sleep_after_action_s=0.0, seed=seed,
              solver_backend=solver_backend, global_solver_iters=sweeps)
    j = j_run(jb, JConfig(**kw), registry=JRegistry())
    plans, blocks = _global_plans(tb, seed, sweeps, solver_backend)
    assert (blocks > 1) == (scenario == "powerlaw")
    t = t_run(tb, TConfig(**kw), device="cpu", registry=TRegistry(), solver_plans=plans)
    assert_same_records(t, j)
    assert tb.events == jb.events
    assert_state_equal(tb.monitor(), jb.monitor())
    assert t.rounds[0].moved
    for r in t.rounds:
        assert r.objective_after <= r.objective_before
    assert t.rounds[-1].communication_cost <= before


def test_moves_per_round_all_routes_through_the_solver():
    """``moves_per_round="all"`` takes a greedy algorithm through the global
    solver, as in the JAX package."""
    seed = 2
    jb, tb = j_make("mubench", seed), t_make("mubench", seed, device="cpu")
    kw = dict(algorithm="communication", moves_per_round="all", max_rounds=1,
              sleep_after_action_s=0.0, seed=seed)
    j = j_run(jb, JConfig(**kw), registry=JRegistry())
    plans, _ = _global_plans(tb, seed, 9, "dense")
    t = t_run(tb, TConfig(**kw), device="cpu", registry=TRegistry(), solver_plans=plans)
    assert_same_records(t, j)
    assert t.rounds[0].objective_before is not None


class FaultyBackend:
    """A simulator whose n-th ``monitor`` / ``apply_move`` calls (1-based,
    per kind) raise ``ConnectionError``."""

    def __init__(self, inner, monitor_fails=(), move_fails=()):
        self.inner = inner
        self.monitor_fails, self.move_fails = set(monitor_fails), set(move_fails)
        self.monitors = self.moves = 0

    def monitor(self):
        self.monitors += 1
        if self.monitors in self.monitor_fails:
            raise ConnectionError("monitor unavailable")
        return self.inner.monitor()

    def apply_move(self, move):
        self.moves += 1
        if self.moves in self.move_fails:
            raise ConnectionError("apply unavailable")
        return self.inner.apply_move(move)

    def comm_graph(self):
        return self.inner.comm_graph()

    def advance(self, seconds):
        self.inner.advance(seconds)


@pytest.mark.parametrize("schedule", [
    # round 2's monitor fails, round 3's move and monitor fail: the breaker
    # opens in round 3, round 4 is a counted skip, round 5's half-open
    # probe closes it
    dict(monitor_fails=(3, 4), move_fails=(3,)),
    # the startup probe fails once; a failed half-open probe re-opens
    dict(monitor_fails=(1, 4, 5, 6), move_fails=(3,)),
])
def test_boundary_breaker_matches_jax(schedule):
    """The same fault schedule through both controllers: the breaker opens,
    rounds are skipped and counted, a half-open probe closes it, and every
    record (degraded, breaker state, failures) agrees."""
    kw = dict(algorithm="communication", max_rounds=8, sleep_after_action_s=0.0, seed=1,
              max_consecutive_failures=2, breaker_cooldown_rounds=2)
    jb, tb = j_make("mubench", 1), t_make("mubench", 1, device="cpu")
    jb.inject_imbalance("worker1")
    tb.inject_imbalance("worker1")
    j = j_run(FaultyBackend(jb, **schedule),
              JConfig(**kw, retry=JRetry(max_attempts=1), **NO_PLANES), registry=JRegistry())
    t = t_run(FaultyBackend(tb, **schedule), TConfig(**kw, retry=TRetry(max_attempts=1)),
              device="cpu", registry=TRegistry())
    assert_same_records(t, j)
    assert t.skipped_rounds >= 1
    assert len(t.rounds) + t.skipped_rounds == 8
    assert [x["to"] for x in t.breaker_transitions][:1] == ["open"]
    assert t.breaker_transitions[-1]["to"] == "closed"
    assert any(r.degraded for r in t.rounds)
    assert tb.events == jb.events


@pytest.mark.parametrize("scenario,seed", [("mubench", 0), ("mubench", 1), ("dense", 4),
                                           ("xlarge", 0)])
def test_sim_backend_matches_jax(scenario, seed, monkeypatch):
    """``make_backend`` builds the same cluster in both packages. At
    ``xlarge`` (20k services) the JAX backend's dense 20k² adjacency is not
    built (its layout function is stubbed here) and the port's graph is
    built only when asked for; the snapshot and the call graph are
    compared."""
    if scenario == "xlarge":
        monkeypatch.setattr(jsim, "workload_layout", lambda wm, cap: (
            None, {n: i for i, n in enumerate(wm.names)}))
    jb, tb = j_make(scenario, seed), t_make(scenario, seed, device="cpu")
    assert tb.workmodel.directed_relation() == jb.workmodel.directed_relation()
    assert tb.node_names == jb.node_names
    assert_state_equal(tb.monitor(), jb.monitor())
    if scenario != "xlarge":
        assert_graph_equal(tb.comm_graph(), jb.comm_graph())
    jb.inject_imbalance(jb.node_names[-1])
    tb.inject_imbalance(tb.node_names[-1])
    jb.advance(2.5)
    tb.advance(2.5)
    assert_state_equal(tb.monitor(), jb.monitor())
    assert tb.events == jb.events and tb.clock_s == jb.clock_s
    # the port keeps the propagated rates between snapshots: a load change
    # must still show in the next one
    jb.load.entry_rps *= 3.0
    tb.load.entry_rps *= 3.0
    assert_state_equal(tb.monitor(), jb.monitor())


MOVES = [
    dict(service="s3", target_node="worker2", mechanism="nodeName"),
    dict(service="s5", target_node="worker3", mechanism="nodeSelector"),
    dict(service="s0", target_node="worker1", hazard_nodes=("worker1",),
         mechanism="affinityOnly"),
    dict(service="s7", target_node="worker3", hazard_nodes=("worker2", "worker3"),
         mechanism="affinityOnly"),
    dict(service="s9", target_node="worker1", hazard_nodes=("worker1", "worker2", "worker3"),
         mechanism="affinityOnly"),
    dict(service="nope", target_node="worker1"),
    dict(service="s1", target_node="worker9"),
    dict(service="s2", target_node="worker3", pod="s2-0"),
    dict(service="s2", target_node="worker1", pod="s2-7"),
]


@pytest.mark.parametrize("workmodel", ["builtin", "replicated"])
def test_apply_move_matches_jax(workmodel, tmp_path):
    """Each mechanism — pinned (nodeName, nodeSelector), the scheduler's
    choice under affinityOnly (every node excluded too) — plus an unknown
    service, an unknown node and single-replica moves: equal landings,
    events, clock and snapshots. ``replicated`` reads a µBench workmodel
    file with 3 replicas of s2 and s7."""
    path = None
    if workmodel == "replicated":
        stanzas = {f"s{i}": {"external_services": [{"services": [f"s{i + 1}"]}] if i < 9 else [],
                             "cpu-requests": "250m", "replicas": 3 if i in (2, 7) else 1}
                   for i in range(10)}
        path = tmp_path / "wm.json"
        path.write_text(json.dumps(stanzas))
    jb = j_make("mubench", 0, workmodel_path=path and str(path))
    tb = t_make("mubench", 0, device="cpu", workmodel_path=path and str(path))
    for i, mv in enumerate(MOVES):
        if i == 4:  # the scheduler's choice follows a load change
            jb.load.cost_per_req_m = tb.load.cost_per_req_m = 40.0
        assert tb.apply_move(TMove(**mv)) == jb.apply_move(JMove(**mv)), mv
        assert_state_equal(tb.monitor(), jb.monitor())
    assert tb.events == jb.events and tb.clock_s == jb.clock_s
    assert any(e["pods"] > 1 for e in tb.events) == (workmodel == "replicated")


def test_cli_reschedule_matches_jax(capsys):
    """tests/test_bench.py:232's command (the ``car`` alias) on the port,
    with the same JSON keys and decisions as the JAX command's. The
    records carry the JAX record's keys for what the port computes, plus
    the port's ``phase_s`` timing field."""
    argv = ["reschedule", "--algorithm", "car", "--backend", "sim", "--rounds", "2",
            "--seed", "1", "--imbalance"]
    assert j_cli(argv) == 0
    j_out = json.loads(capsys.readouterr().out)
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    t_out = json.loads(capsys.readouterr().out)
    assert t_out["algorithm"] == j_out["algorithm"] == "communication"
    assert len(t_out["rounds"]) == 2
    assert set(t_out) <= set(j_out)
    for t, j in zip(t_out["rounds"], j_out["rounds"]):
        assert set(t) - {"phase_s"} <= set(j)
        for k in DECISIONS + ("communication_cost", "moves"):
            if k in j:
                assert t[k] == j[k], k
    for k in ("moves", "skipped_rounds", "degraded_rounds", "boundary_failures",
              "breaker_transitions"):
        assert t_out[k] == j_out[k], k


@pytest.mark.parametrize("solver_backend", ["dense", "sparse"])
def test_cli_reschedule_global(capsys, solver_backend):
    assert t_cli.main(["reschedule", "--algorithm", "global", "--scenario", "mubench",
                       "--rounds", "2", "--solver-backend", solver_backend,
                       "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["algorithm"] == "global" and len(out["rounds"]) == 2
    assert all(r["objective_after"] <= r["objective_before"] for r in out["rounds"])


REFUSED = [
    # proactive is carried; what the JAX package refuses of it, it refuses
    (dict(algorithm="proactive", scan_block=4), "pinning greedy algorithm"),
    # the k8s backend is carried: churn on a live cluster is refused, as in
    # the JAX package
    (dict(backend="k8s", elastic="steady"), "churn injection requires the hermetic sim"),
    # chaos is carried: an unknown profile is refused with with_chaos's message
    (dict(chaos="tsunami"), "unknown chaos profile 'tsunami'"),
    # the port carries churn and both schedules now; what the JAX package
    # refuses of them, it refuses too
    (dict(elastic="tsunami"), "unknown churn profile"),
    # shadow mode is carried: chaos on the replayed trace is refused
    (dict(shadow=TShadowConfig(enabled=True), chaos="soak"),
     "shadow mode cannot compose with chaos"),
    # fleet mode and its dp plane are carried: the mesh plane's rule refuses
    # a ratio below 1, as in the JAX package
    (dict(fleet=TFleetConfig(tenants=4, plane="dp"), slo_mesh_imbalance_ratio=0.5),
     "slo_mesh_imbalance_ratio must be 0"),
    # the serving plane is carried: it scores with the greedy machinery only
    (dict(serving=TServingConfig(enabled=True), algorithm="global"),
     "serving.enabled requires a greedy algorithm"),
    (dict(pipeline=True, pipeline_depth=3), "depth must be 2"),
    (dict(scan_block=8, algorithm="kubescheduling"), "pinning greedy algorithm"),
]


@pytest.mark.parametrize("kw,match", REFUSED, ids=[next(iter(kw)) for kw, _ in REFUSED])
def test_config_refuses_planes_it_does_not_carry(kw, match):
    """Every plane the port lacks is refused by ``validate()`` with its
    ROADMAP item, a carried plane's configuration the JAX package refuses
    is refused for its reason, and ``run_controller`` refuses either before
    touching the backend."""
    cfg = TConfig(**kw)
    with pytest.raises(ValueError, match=match):
        cfg.validate()

    class Untouched:
        def __getattr__(self, name):
            raise AssertionError(f"backend.{name} called")

    with pytest.raises(ValueError, match=match):
        t_run(Untouched(), cfg, device="cpu")


@pytest.mark.parametrize("plane", ["solver_restarts", "solver_tp"])
def test_config_runs_restarts_and_tp(plane):
    """``solver_restarts`` and ``solver_tp`` are carried: validate()
    accepts them. Two global rounds of best-of-2 restarts (seed 2, µBench)
    fed the JAX loop's per-restart plans (``split(fold_in(key, round), 2)``)
    equal the JAX loop's records; a tp of 2 on one process fails at the
    solve with the JAX package's message (the node-sharded rounds over a
    process group are tests/test_torch_parallel.py's)."""
    seed = 2
    kw = dict(algorithm="global", max_rounds=2, sleep_after_action_s=0.0, seed=seed,
              **{plane: 2})
    TConfig(**kw).validate()
    tb = t_make("mubench", seed, device="cpu")
    if plane == "solver_tp":
        with pytest.raises(ValueError, match="tp=2 does not divide the 1 available devices"):
            t_run(tb, TConfig(**kw), device="cpu", registry=TRegistry())
        return
    jb = j_make("mubench", seed)
    j = j_run(jb, JConfig(**kw), registry=JRegistry())
    S, N = tb.comm_graph().num_services, len(tb.node_names)

    def plans(rnd):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), rnd), 2)
        return [jax_plan(k, jgs.GlobalSolverConfig(), S, N, inline=False) for k in keys]

    t = t_run(tb, TConfig(**kw), device="cpu", registry=TRegistry(), solver_plans=plans)
    assert_same_records(t, j)
    assert tb.events == jb.events
    assert all(r.objective_before is None and r.objective_after is not None for r in t.rounds)


def test_cli_refuses_what_the_port_does_not_carry():
    # --place needs the ops server in front of it, as in the JAX command
    with pytest.raises(SystemExit, match=r"--place requires --serve"):
        t_cli.main(["reschedule", "--place", "--device", "cpu"])
    # the k8s backend cannot pin one replica: the JAX command's clean exit
    with pytest.raises(SystemExit, match="--placement-unit pod requires the sim backend"):
        t_cli.main(["reschedule", "--backend", "k8s", "--placement-unit", "pod",
                    "--algorithm", "global", "--device", "cpu"])


def test_run_controller_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    tb = t_make("mubench", 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_run(tb, TConfig(max_rounds=1))


def test_device_kind_names_the_device():
    """Measured records are keyed by the device's name and count: the CUDA
    card's name where there is one, ``cpu`` otherwise."""
    from kubernetes_rescheduling_tpu_torch.backends.base import device_kind

    if torch.cuda.is_available():
        assert device_kind() == f"{torch.cuda.get_device_name(0)}x{torch.cuda.device_count()}"
    else:
        assert device_kind() == "cpux1"
        assert device_kind(4) == "cpux4"
