"""Decision explanations against the JAX package on the CPU:
``decide_explain``'s bundle, the records' ``explanations`` with a logger
attached (greedy, global capped and uncapped, pod rounds), the
consistency audit, and the host module (``telemetry/explain.py``).

Bars: bundles and explanations are exactly equal — indices, CPU percents
and scores are the same f32 values, and the global round's gains are the
same host numpy sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_controller import _global_plans, assert_same_records, jax_greedy_gumbel
from test_torch_pod_round import pod_plans, stuck_backends
from test_torch_policies import INSTANCES, _instance

from kubernetes_rescheduling_tpu.bench.controller import run_controller as j_run
from kubernetes_rescheduling_tpu.bench.harness import make_backend as j_make
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.core.state import ClusterState as JState
from kubernetes_rescheduling_tpu.core.state import CommGraph as JGraph
from kubernetes_rescheduling_tpu.solver import round_loop as jrl
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu.telemetry import explain as jexplain
from kubernetes_rescheduling_tpu.utils.logging import StructuredLogger as JLogger
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend as t_make
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState as TState
from kubernetes_rescheduling_tpu_torch.core.state import CommGraph as TGraph
from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS, POLICY_NAMES
from kubernetes_rescheduling_tpu_torch.solver import round_loop as trl
from kubernetes_rescheduling_tpu_torch.solver.global_solver import GlobalSolverConfig
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry
from kubernetes_rescheduling_tpu_torch.telemetry import explain as texplain
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger as TLogger


def tie_instance(names):
    """Seven nodes, every pod on the first (the hazard); the six empty
    candidates tie on every policy's primary key, so the lexicographic
    winner is decided by the tie-break — at index 6 for ``spread`` when the
    names descend, for ``binpack`` when they ascend."""
    kw = dict(node_names=names, node_cpu_cap=[1000.0] * 7, node_mem_cap=[4e9] * 7,
              pod_services=[0, 1, 2, 0], pod_nodes=[0, 0, 0, 0],
              pod_cpu=[200.0, 150.0, 100.0, 200.0], pod_mem=[1e6] * 4)
    rel = {"a": ["b"], "b": ["c"], "c": []}
    return (JState.build(**kw), JGraph.from_relation(rel, names=["a", "b", "c"]),
            TState.build(**kw, device="cpu"),
            TGraph.from_relation(rel, names=["a", "b", "c"], device="cpu"))


DESCENDING = [f"n{i}" for i in range(7, 0, -1)]
ASCENDING = [f"n{i}" for i in range(1, 8)]


def explain_both(j_state, j_graph, t_state, t_graph, policy, thr, key, top_k):
    pid = POLICY_IDS[policy]
    j = jrl.decide_explain(j_state, j_graph, jnp.asarray(pid), jnp.asarray(thr), key,
                           top_k=top_k)
    g = torch.tensor(np.asarray(jax.random.gumbel(key, (t_state.num_nodes,))))
    t = trl.decide_explain(t_state, t_graph, pid, thr, g, top_k=top_k)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the same decision as decide
    for a, b in zip(t[:5], trl.decide(t_state, t_graph, pid, thr, g)):
        assert torch.equal(a, b)
    return t


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_decide_explain_matches_jax(policy):
    """Bundles exactly equal on the policy tests' instances, at thresholds
    that hit no node and several, top-k 1, 3 and more than the nodes; and
    on the tie instances, where more than k candidates tie on the primary
    key and the chosen node must take the last slot."""
    key = jax.random.PRNGKey(11)
    for name in INSTANCES:
        for thr in (30.0, 5.0, 99.0):
            for top_k in (1, 3, 9):
                explain_both(*_instance(name), policy, thr, key, top_k)
    for names in (DESCENDING, ASCENDING):
        t = explain_both(*tie_instance(names), policy, 30.0, key, 3)
        target, bundle = int(t[4]), t[5].numpy()
        assert target >= 0 and target in bundle[2].astype(int).tolist()
        forced = (policy, names) in (("spread", DESCENDING), ("binpack", ASCENDING))
        if forced:
            assert target == 6 and int(bundle[2, -1]) == 6


def logged_run(pkg, backend, cfg_kw, **kw):
    run, config, logger, registry = (
        (j_run, JConfig, JLogger, JRegistry) if pkg == "jax"
        else (t_run, TConfig, TLogger, TRegistry))
    log = logger()
    extra = {} if pkg == "jax" else {"device": "cpu", **kw}
    return run(backend, config(**cfg_kw), registry=registry(), logger=log, **extra), log


def assert_same_explanations(t, j, t_log, j_log):
    assert_same_records(t, j)
    for a, b in zip(t.rounds, j.rounds):
        assert a.explanations == b.explanations, a.round
        assert a.explanations and all(texplain.explanation_consistent(e)
                                      for e in a.explanations)
    strip = ("ts",)
    events = [[{k: v for k, v in r.items() if k not in strip and k != "decision_latency_s"}
               for r in log.records] for log in (t_log, j_log)]
    assert events[0] == events[1]


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_greedy_explanations_match_jax(policy):
    """µBench with worker1 piled, 3 moves a round for 4 rounds, a logger
    on: every record's explanations and every logged event (decisions and
    rounds, in order) equal the JAX run's."""
    seed = 1
    jb, tb = j_make("mubench", seed), t_make("mubench", seed, device="cpu")
    jb.inject_imbalance("worker1")
    tb.inject_imbalance("worker1")
    kw = dict(algorithm=policy, max_rounds=4, sleep_after_action_s=0.0, seed=seed,
              moves_per_round=3)
    j, j_log = logged_run("jax", jb, kw)
    t, t_log = logged_run("torch", tb, kw,
                          gumbel_rows=jax_greedy_gumbel(seed, len(tb.node_names)))
    assert_same_explanations(t, j, t_log, j_log)
    assert sum(len(r.explanations) for r in t.rounds) == sum(r.decisions for r in t.rounds)


@pytest.mark.parametrize("cap", ["all", 2])
def test_global_explanations_match_jax(cap):
    """Global rounds, uncapped (candidates scored by their individual
    gains) and capped (by the wave cap's gains)."""
    seed = 2
    jb, tb = j_make("mubench", seed), t_make("mubench", seed, device="cpu")
    jb.inject_imbalance("worker1")
    tb.inject_imbalance("worker1")
    kw = dict(algorithm="global", max_rounds=3, sleep_after_action_s=0.0, seed=seed,
              balance_weight=0.5, global_moves_cap=cap)
    j, j_log = logged_run("jax", jb, kw)
    plans, _ = _global_plans(tb, seed, 9, "dense")
    t, t_log = logged_run("torch", tb, kw, solver_plans=plans)
    assert_same_explanations(t, j, t_log, j_log)
    assert any(c["score"] != 0.0 for r in t.rounds for e in r.explanations
               for c in e["candidates"])


def test_pod_explanations_match_jax():
    jb, tb = stuck_backends()
    kw = dict(algorithm="global", placement_unit="pod", max_rounds=2,
              sleep_after_action_s=0.0, enforce_capacity=True)
    j, j_log = logged_run("jax", jb, kw)
    t, t_log = logged_run("torch", tb, kw, solver_plans=pod_plans(tb, 0, GlobalSolverConfig()))
    assert_same_explanations(t, j, t_log, j_log)
    assert t.rounds[0].explanations[0]["kind"] == "pod"


def test_explain_adds_no_host_transfer():
    """The bundles ride the round-end transfer: a greedy run with a logger
    reads the device exactly as often as one without; explain=False or no
    logger records no explanation."""
    counts = []
    for cfg_kw, with_logger in ((dict(), True), (dict(), False), (dict(explain=False), True)):
        tb = t_make("mubench", 1, device="cpu")
        tb.inject_imbalance("worker1")
        reg = TRegistry()
        res = t_run(tb, TConfig(algorithm="communication", max_rounds=4, moves_per_round=3,
                                sleep_after_action_s=0.0, seed=1, **cfg_kw),
                    device="cpu", registry=reg, logger=TLogger() if with_logger else None)
        counts.append({site: reg.value("device_transfers_total", site=site)
                       for site in ("fence", "round_end", "admission")})
        assert bool(res.rounds[0].explanations) == (with_logger and cfg_kw == {})
    assert counts[0] == counts[1] == counts[2]


def test_explain_host_module_matches_jax(tmp_path):
    """``iter_decisions``, ``check_decisions``, ``summarize_decisions`` and
    ``load_decisions`` give the JAX package's output on the same logged
    stream, and an inconsistent explanation is caught."""
    tb = t_make("mubench", 1, device="cpu")
    tb.inject_imbalance("worker1")
    path = tmp_path / "events.jsonl"
    res = t_run(tb, TConfig(algorithm="communication", max_rounds=3, sleep_after_action_s=0.0,
                            seed=1), device="cpu", registry=TRegistry(),
                logger=TLogger(path=path))
    decisions = texplain.load_decisions(path)
    assert decisions == jexplain.load_decisions(path)
    assert len(decisions) == sum(len(r.explanations) for r in res.rounds)
    records = [{"record": r.as_dict()} for r in res.rounds]
    assert texplain.iter_decisions(records) == jexplain.iter_decisions(records)
    bad = dict(decisions[0], chosen=decisions[0]["candidates"][-1]["node"])
    stream = decisions + [bad]
    assert texplain.check_decisions(stream) == jexplain.check_decisions(stream)
    assert texplain.summarize_decisions(stream) == jexplain.summarize_decisions(stream)
    assert texplain.check_decisions(stream)[1] == ([bad] if not jexplain.explanation_consistent(
        bad) else [])
