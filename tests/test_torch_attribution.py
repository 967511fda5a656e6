"""Cost attribution on both packages: tests/test_attribution.py's cases,
written once over a package namespace and run on the JAX package and on
the port (CPU); the port's attribution bundle against the JAX package's
``communication_cost_attribution`` on the same snapshots; and the loop's
attribution gate (a logger attached turns attribution on, as in the JAX
loop) pinned record for record against the JAX loop.

Bars: the bundle's edge rows (service and node indices, and the integer
costs) are exactly the JAX package's, ties included — ``lax.top_k`` puts
the lower flat index first among equal values and the port's row-blocked
top-k merges by the same rule; the totals, tail and node-pair matrix
within rel 1e-6 (row blocks sum in another order; exact here, where
weights and counts are integers). With a logger attached the two loops'
records are equal, ``attribution`` included.
"""

import json
import types

import jax
import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu.backends import sim as jsim
from kubernetes_rescheduling_tpu.bench.controller import run_controller as j_run
from kubernetes_rescheduling_tpu.bench.harness import make_backend as j_make
from kubernetes_rescheduling_tpu.bench.harness import run_chaos_soak as j_soak
from kubernetes_rescheduling_tpu.config import ObsConfig as JObs
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.core import state as jstate
from kubernetes_rescheduling_tpu.core import workmodel as jwm
from kubernetes_rescheduling_tpu.objectives import metrics as jmetrics
from kubernetes_rescheduling_tpu.telemetry import attribution as jattr
from kubernetes_rescheduling_tpu.telemetry import registry as jregistry
from kubernetes_rescheduling_tpu.telemetry import server as jserver
from kubernetes_rescheduling_tpu.telemetry import watchdog as jwatchdog
from kubernetes_rescheduling_tpu.telemetry.flight_recorder import FlightRecorder as JRecorder
from kubernetes_rescheduling_tpu.utils.logging import StructuredLogger as JLogger
from kubernetes_rescheduling_tpu.utils.retry import RetryPolicy as JRetry
from kubernetes_rescheduling_tpu_torch.backends import sim as tsim
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend as t_make
from kubernetes_rescheduling_tpu_torch.bench.harness import run_chaos_soak as t_soak
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.core import state as tstate
from kubernetes_rescheduling_tpu_torch.core import workmodel as twm
from kubernetes_rescheduling_tpu_torch.objectives import metrics as tmetrics
from kubernetes_rescheduling_tpu_torch.telemetry import attribution as tattr
from kubernetes_rescheduling_tpu_torch.telemetry import registry as tregistry
from kubernetes_rescheduling_tpu_torch.telemetry import server as tserver
from kubernetes_rescheduling_tpu_torch.telemetry import watchdog as twatchdog
from kubernetes_rescheduling_tpu_torch.telemetry.flight_recorder import FlightRecorder as TRecorder
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger as TLogger
from kubernetes_rescheduling_tpu_torch.utils.retry import RetryPolicy as TRetry


def _j_config(attribution=True, attribution_top_k=8, **kw):
    return JConfig(obs=JObs(attribution=attribution, attribution_top_k=attribution_top_k), **kw)


PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", attr=jattr, metrics=jmetrics, state=jstate, sim=jsim, wm=jwm,
        registry=jregistry, server=jserver, watchdog=jwatchdog, Logger=JLogger,
        Recorder=JRecorder, make=lambda scn, seed: j_make(scn, seed),
        config=_j_config, asarray=np.asarray,
        run=lambda backend, cfg, **kw: j_run(backend, cfg, **kw),
        soak=lambda **kw: j_soak(retry=JRetry(max_attempts=1), **kw),
        build_kw={},
    ),
    "torch": types.SimpleNamespace(
        name="torch", attr=tattr, metrics=tmetrics, state=tstate, sim=tsim, wm=twm,
        registry=tregistry, server=tserver, watchdog=twatchdog, Logger=TLogger,
        Recorder=TRecorder, make=lambda scn, seed: t_make(scn, seed, device="cpu"),
        config=lambda **kw: TConfig(**kw), asarray=lambda t: t.numpy(),
        run=lambda backend, cfg, **kw: t_run(backend, cfg, device="cpu", **kw),
        soak=lambda **kw: t_soak(retry=TRetry(max_attempts=1), device="cpu", **kw),
        build_kw={"device": "cpu"},
    ),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture()
def registry(pkg):
    prev = pkg.registry.set_registry(pkg.registry.MetricsRegistry())
    try:
        yield pkg.registry.get_registry()
    finally:
        pkg.registry.set_registry(prev)


def _two_svc_state(pkg):
    """svc0: 2 replicas on n0 + 1 on n1 (split); svc1: 1 replica on n2."""
    graph = pkg.state.CommGraph.from_relation({"a": ["b"], "b": []}, names=["a", "b"],
                                              **pkg.build_kw)
    state = pkg.state.ClusterState.build(
        node_names=["n0", "n1", "n2"], node_cpu_cap=[1000.0] * 3, node_mem_cap=[1e9] * 3,
        pod_services=[0, 0, 0, 1], pod_nodes=[0, 0, 1, 2], pod_cpu=[10.0] * 4,
        pod_mem=[1.0] * 4, **pkg.build_kw)
    return state, graph


def _decode(pkg, bundle, state, graph, k):
    return pkg.attr.decode_attribution(
        pkg.asarray(bundle), node_names=state.node_names, service_names=graph.names, top_k=k,
        num_nodes=state.num_nodes, num_services=graph.num_services)


# ---------------- the device bundle ----------------


def test_node_pair_matrix_decomposes_the_scalar(pkg):
    backend = pkg.make("mubench", 2)
    state, graph = backend.monitor(), backend.comm_graph()
    cost = float(pkg.metrics.communication_cost(state, graph))
    m = pkg.asarray(pkg.metrics.node_pair_cost_matrix(state, graph))
    assert cost > 0
    assert 0.5 * m.sum() == pytest.approx(cost, rel=1e-5)
    assert np.allclose(np.diag(m), 0.0) and np.allclose(m, m.T)


def test_attribution_bundle_matches_numpy_recompute(pkg):
    backend = pkg.make("mubench", 2)
    state, graph = backend.monitor(), backend.comm_graph()
    k = 6
    attr = _decode(pkg, pkg.metrics.communication_cost_attribution(state, graph, top_k=k),
                   state, graph, k)
    cost = float(pkg.metrics.communication_cost(state, graph))
    assert attr["total"] == pytest.approx(cost, rel=1e-5)
    assert pkg.attr.attribution_consistent(attr, communication_cost=cost)
    num_s = graph.num_services
    occ = pkg.asarray(state.service_node_counts(num_s))
    sv = pkg.asarray(graph.service_valid)
    adj = pkg.asarray(graph.adj) * sv[:, None] * sv[None, :]
    tot = occ.sum(axis=1)
    contrib = adj * (tot[:, None] * tot[None, :] - occ @ occ.T)
    upper = sorted((contrib[i, j] for i in range(num_s) for j in range(i + 1, num_s)
                    if contrib[i, j] > 0), reverse=True)
    got = [e["cost"] for e in attr["edges"]]
    assert got == pytest.approx(upper[:len(got)])
    assert attr["tail"] == pytest.approx(sum(upper) - sum(got), abs=1e-3)


def test_attribution_dominant_node_pair_with_split_replicas(pkg):
    state, graph = _two_svc_state(pkg)
    attr = _decode(pkg, pkg.metrics.communication_cost_attribution(state, graph, top_k=2),
                   state, graph, 2)
    assert attr["total"] == pytest.approx(3.0)
    [edge] = attr["edges"]
    assert {edge["src_service"], edge["dst_service"]} == {"a", "b"}
    assert {edge["src_node"], edge["dst_node"]} == {"n0", "n2"}
    assert edge["cost"] == pytest.approx(3.0)
    assert sum(attr["ingress"].values()) == pytest.approx(3.0)
    assert sum(attr["egress"].values()) == pytest.approx(3.0)


def test_attribution_consistency_catches_tampering(pkg):
    state, graph = _two_svc_state(pkg)
    attr = _decode(pkg, pkg.metrics.communication_cost_attribution(state, graph, top_k=2),
                   state, graph, 2)
    ok = pkg.attr.attribution_consistent
    assert ok(attr)
    bad = json.loads(json.dumps(attr))
    bad["edges"][0]["cost"] += 1.0
    assert not ok(bad)
    bad2 = json.loads(json.dumps(attr))
    bad2["ingress"]["n0"] += 5.0
    assert not ok(bad2)
    assert not ok(attr, communication_cost=99.0)
    withmoves = json.loads(json.dumps(attr))
    withmoves["moves"] = [{"service": "a", "cost_delta": -2.0,
                           "edges": [{"peer": "b", "delta": -2.0}]}]
    withmoves["objective_delta"] = -2.0
    assert ok(withmoves)
    withmoves["moves"][0]["edges"][0]["delta"] = 1.0
    assert not ok(withmoves)


# ---------------- placement timeline / move provenance ----------------


def test_timeline_move_deltas_telescope(pkg):
    state, graph = _two_svc_state(pkg)
    tl = pkg.attr.PlacementTimeline()
    tl.bind(state, graph)
    assert tl._model_total() == pytest.approx(3.0)
    block = tl.observe_round(1, [("a", "n2")])
    [mv] = block["moves"]
    assert mv["from"] == "n0" and mv["to"] == "n2"
    assert mv["cost_delta"] == pytest.approx(-3.0)
    assert sum(e["delta"] for e in mv["edges"]) == pytest.approx(-3.0)
    assert block["objective_delta"] == pytest.approx(-3.0)
    assert block["model_total"] == pytest.approx(0.0)
    block2 = tl.observe_round(2, [("b", "n1")])
    assert block2["objective_delta"] == pytest.approx(3.0)
    assert block2["model_total"] == pytest.approx(3.0)
    assert [n for _, n in tl.residency["a"]] == ["n0", "n2"]
    assert tl.render_residency()


def test_timeline_pod_level_and_unknown_names_are_safe(pkg):
    state, graph = _two_svc_state(pkg)
    tl = pkg.attr.PlacementTimeline()
    tl.bind(state, graph)
    block = tl.observe_round(1, [("a", "n1")], pod_level=True)
    assert block["objective_delta"] is None and block["moves"][0]["cost_delta"] is None
    assert tl.observe_round(2, [("ghost", "nowhere")])["moves"][0]["cost_delta"] is None


# ---------------- gauges: cardinality-bounded publication ----------------


def _fake_attr():
    return {
        "total": 10.0, "tail": 0.0,
        "edges": [{"src_service": "a", "dst_service": "b", "src_node": "n0", "dst_node": "n1",
                   "cost": 6.0},
                  {"src_service": "a", "dst_service": "c", "src_node": "n0", "dst_node": "n2",
                   "cost": 4.0}],
        "node_pairs": [["n0", "n1", 12.0], ["n1", "n0", 12.0], ["n0", "n2", 8.0],
                       ["n2", "n0", 8.0]],
        "ingress": {"n0": 5.0, "n1": 3.0, "n2": 2.0},
        "egress": {"n0": 5.0, "n1": 3.0, "n2": 2.0},
    }


def test_publish_attribution_zeroes_stale_pairs(pkg, registry):
    pkg.attr.publish_attribution(registry, _fake_attr(), top_k=4)
    pair = registry.gauge("comm_cost_node_pair", labelnames=("src", "dst"))
    assert pair.labels(src="n0", dst="n1").value == pytest.approx(12.0)
    assert pair.labels(src="n1", dst="n0").value == 0.0
    attr2 = _fake_attr()
    attr2["node_pairs"] = [["n0", "n2", 20.0], ["n2", "n0", 20.0]]
    pkg.attr.publish_attribution(registry, attr2, top_k=4)
    assert pair.labels(src="n0", dst="n1").value == 0.0
    assert pair.labels(src="n0", dst="n2").value == pytest.approx(20.0)
    edge = registry.gauge("comm_cost_edge_topk", labelnames=("rank",))
    assert len(edge._children) == 4
    assert edge.labels(rank="0").value == pytest.approx(6.0)
    assert edge.labels(rank="3").value == 0.0


# ---------------- watchdog: attribution_drift ----------------


def _rec(attr):
    return types.SimpleNamespace(decision_latency_s=0.01, communication_cost=attr["total"],
                                 attribution=attr)


def test_watchdog_attribution_drift_fires_and_recovers(pkg, registry):
    logger = pkg.Logger(name="t")
    wd = pkg.watchdog.Watchdog(pkg.watchdog.SLORules(attribution_drift_frac=0.5,
                                                     max_retraces=0),
                               registry=registry, logger=logger)
    assert any(v["rule"] == "attribution_drift" for v in wd.observe_round(_rec(_fake_attr())))
    assert not wd.healthy
    fam = registry.counter("slo_violations_total", labelnames=("rule",))
    assert fam.labels(rule="attribution_drift").value == 1
    ok = _fake_attr()
    ok["edges"][0]["cost"] = 4.0
    wd.observe_round(_rec(ok))
    assert wd.healthy
    events = [r["event"] for r in logger.records]
    assert "slo_violation" in events and "slo_recovered" in events


def test_watchdog_drift_rule_off_by_default(pkg, registry):
    wd = pkg.watchdog.Watchdog(pkg.watchdog.SLORules(max_retraces=0), registry=registry)
    wd.observe_round(_rec(_fake_attr()))
    assert wd.healthy


def test_config_attribution_knobs(pkg):
    cfg = pkg.config(attribution=False, attribution_top_k=4)
    obs = cfg.obs if pkg.name == "jax" else cfg
    assert obs.attribution is False and obs.attribution_top_k == 4
    defaults = pkg.config()
    obs = defaults.obs if pkg.name == "jax" else defaults
    assert obs.attribution is True and obs.attribution_top_k == 8
    with pytest.raises(ValueError):
        pkg.config(attribution_top_k=0).validate()


# ---------------- controller integration ----------------


def _backend(pkg, n_nodes):
    b = pkg.sim.SimBackend(
        workmodel=pkg.wm.mubench_workmodel_c(), node_names=[f"w{i}" for i in range(n_nodes)],
        node_cpu_cap_m=20_000.0, seed=0,
        load=pkg.sim.LoadModel(entry_rps=100.0, cost_per_req_m=8.0, idle_m=50.0),
        **pkg.build_kw)
    b.inject_imbalance(b.node_names[0])
    return b


def test_controller_attribution_soak_acceptance(pkg, registry):
    """A seeded greedy soak records a consistent attribution every round,
    in ONE round-end transfer a round (no transfer of its own), within the
    gauges' cardinality budget, and the book carries the latest."""
    rounds = 6
    cfg = pkg.config(algorithm="communication", max_rounds=rounds, sleep_after_action_s=0.0,
                     seed=1, attribution_top_k=5)
    pkg.attr.get_attribution_book().clear()
    result = pkg.run(_backend(pkg, 4), cfg, logger=pkg.Logger(name="t"))
    assert len(result.rounds) == rounds
    for rec in result.rounds:
        assert pkg.attr.attribution_consistent(rec.attribution,
                                               communication_cost=rec.communication_cost)
        assert rec.as_dict()["attribution"]["total"] == rec.attribution["total"]
    checked, bad = pkg.attr.check_attribution([r.as_dict() for r in result.rounds])
    assert checked == rounds and bad == []
    fam = registry.counter("device_transfers_total", labelnames=("site",))
    assert fam.labels(site="round_end").value == rounds
    assert fam.labels(site="attribution").value == 0
    n = 4
    pair = registry.gauge("comm_cost_node_pair", labelnames=("src", "dst"))
    assert 0 < len(pair._children) <= n * (n - 1) // 2
    for name in ("comm_cost_node_ingress", "comm_cost_node_egress"):
        assert 0 < len(registry.gauge(name, labelnames=("node",))._children) <= n
    assert len(registry.gauge("comm_cost_edge_topk", labelnames=("rank",))._children) == 5
    book = pkg.attr.get_attribution_book().as_dict()
    assert book["communication"]["round"] == rounds
    assert book["communication"]["total"] == pytest.approx(result.rounds[-1].attribution["total"])
    text = "\n".join(pkg.attr.render_edges(result.rounds[-1].attribution)
                     + pkg.attr.render_heatmap(result.rounds[-1].attribution)
                     + pkg.attr.render_provenance([r.as_dict() for r in result.rounds]))
    assert "edge attribution" in text and "node-pair heatmap" in text


def test_global_round_attribution_and_provenance(pkg, registry):
    cfg = pkg.config(algorithm="global", max_rounds=2, sleep_after_action_s=0.0, seed=3,
                     balance_weight=0.5)
    result = pkg.run(_backend(pkg, 5), cfg, logger=pkg.Logger(name="t"))
    assert [r for r in result.rounds if r.applied_moves]
    for rec in result.rounds:
        attr = rec.attribution
        assert pkg.attr.attribution_consistent(attr, communication_cost=rec.communication_cost)
        assert len(attr["moves"]) == len(rec.applied_moves)
        if attr["moves"]:
            assert attr["objective_delta"] == pytest.approx(
                sum(m["cost_delta"] for m in attr["moves"]), abs=1e-3)


def test_bare_loop_records_no_attribution(pkg, registry):
    cfg = pkg.config(algorithm="communication", max_rounds=2, sleep_after_action_s=0.0)
    result = pkg.run(_backend(pkg, 6), cfg)
    assert all(r.attribution is None for r in result.rounds)
    fam = registry.counter("device_transfers_total", labelnames=("site",))
    assert fam.labels(site="attribution").value == 0


def test_attribution_off_switch(pkg, registry):
    cfg = pkg.config(algorithm="communication", max_rounds=2, sleep_after_action_s=0.0,
                     attribution=False)
    result = pkg.run(_backend(pkg, 7), cfg, logger=pkg.Logger(name="t"))
    assert all(r.attribution is None for r in result.rounds)


def test_chaos_soak_attribution_stays_consistent(pkg, registry):
    report = pkg.soak(profile="soak", rounds=20, seed=1, chaos_seed=0,
                      max_consecutive_failures=3, logger=pkg.Logger(name="t"),
                      registry=registry)
    assert report["records"] + report["skipped_rounds"] == 20
    fam = registry.counter("device_transfers_total", labelnames=("site",))
    assert fam.labels(site="round_end").value == report["records"]
    assert fam.labels(site="attribution").value == 0


def test_flight_recorder_bundle_carries_attribution(pkg, registry, tmp_path):
    cfg = pkg.config(algorithm="communication", max_rounds=3, sleep_after_action_s=0.0, seed=1)
    fr = pkg.Recorder(capacity=8, bundle_dir=tmp_path, registry=registry)
    result = pkg.run(_backend(pkg, 8), cfg, logger=pkg.Logger(name="t"))
    for r in result.rounds:
        fr.record_round(round=r.round, digest="x", record=r.as_dict())
    bundle = json.loads(fr.dump("crash", error="boom").read_text())
    checked, bad = pkg.attr.check_attribution(bundle["rounds"])
    assert checked == 3 and bad == []
    assert bundle["attribution"] and bundle["manifest"]["attribution"]
    assert pkg.attr.residency_from_rounds(bundle["rounds"])


# ---------------- the port against the JAX package ----------------


def _tied_state(n_services: int, n_nodes: int, seed: int):
    """A random placement of unit-weight services: every edge's
    contribution is a small integer, so the top-k meets long runs of
    ties."""
    rng = np.random.default_rng(seed)
    rel = {f"s{i}": [f"s{j}" for j in rng.choice(n_services, size=3, replace=False) if j != i]
           for i in range(n_services)}
    names = [f"s{i}" for i in range(n_services)]
    pods = np.repeat(np.arange(n_services), 2)
    nodes = rng.integers(0, n_nodes, size=pods.size)
    kw = dict(node_names=[f"n{i}" for i in range(n_nodes)], node_cpu_cap=[1e4] * n_nodes,
              node_mem_cap=[1e9] * n_nodes, pod_services=pods.tolist(),
              pod_nodes=nodes.tolist(), pod_cpu=[10.0] * pods.size, pod_mem=[1.0] * pods.size)
    j = (jstate.ClusterState.build(**kw), jstate.CommGraph.from_relation(rel, names=names))
    t = (tstate.ClusterState.build(**kw, device="cpu"),
         tstate.CommGraph.from_relation(rel, names=names, device="cpu"))
    return j, t


@pytest.mark.parametrize("case", [("mubench", 0, 8), ("mubench", 2, 50), ("powerlaw", 0, 8),
                                  ("powerlaw", 1, 33), ("dense", 0, 8), ("tied", 3, 8),
                                  ("tied", 4, 64)])
def test_bundle_equals_jax(case, monkeypatch):
    """The port's bundle on the JAX package's snapshot: edge rows exact
    (ties included), floats within rel 1e-6. Row blocks of 64 services make
    the tied instances merge candidates across blocks."""
    scenario, seed, k = case
    if scenario == "tied":
        (js, jg), (ts, tg) = _tied_state(300, 12, seed)
        monkeypatch.setattr(tmetrics, "ROW_BLOCK", 64)
    else:
        jb, tb = j_make(scenario, seed), t_make(scenario, seed, device="cpu")
        js, jg, ts, tg = jb.monitor(), jb.comm_graph(), tb.monitor(), tb.comm_graph()
    a = np.asarray(jmetrics.communication_cost_attribution(js, jg, top_k=k))
    b = tmetrics.communication_cost_attribution(ts, tg, top_k=k).numpy()
    kk = max(1, min(k, tg.num_services ** 2))
    assert a.shape == b.shape
    assert np.array_equal(a[2:2 + 5 * kk], b[2:2 + 5 * kk])
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    costs = b[2:2 + 5 * kk].reshape(kk, 5)[:, 4]
    if scenario == "tied":
        assert len(set(costs[costs > 0].tolist())) < np.count_nonzero(costs), "no ties met"


def test_round_end_dense_form_with_attribution():
    """With ``top_k`` > 0 the round end's cost is the dense form, equal to
    ``communication_cost`` bit for bit, and its bundle is
    ``communication_cost_attribution``'s."""
    from kubernetes_rescheduling_tpu_torch.bench import round_end

    tb = t_make("powerlaw", 0, device="cpu")
    st, g = tb.monitor(), tb.comm_graph()
    flat = round_end.round_end_metrics(st, g, top_k=8, edges=tmetrics.comm_edge_list(g))
    assert float(flat[0]) == float(tmetrics.communication_cost(st, g))
    assert torch.equal(flat[round_end.METRIC_HEAD:],
                       tmetrics.communication_cost_attribution(st, g, top_k=8))
    assert round_end.round_end_metrics(st, g, edges=tmetrics.comm_edge_list(g)).numel() == 2


def test_deployment_cost_and_objective_summary_equal_jax():
    for scenario in ("mubench", "powerlaw"):
        jb, tb = j_make(scenario, 1), t_make(scenario, 1, device="cpu")
        js, jg, ts, tg = jb.monitor(), jb.comm_graph(), tb.monitor(), tb.comm_graph()
        assert float(tmetrics.communication_cost_deployment(ts, tg)) == \
            float(jmetrics.communication_cost_deployment(js, jg))
        j, t = jmetrics.objective_summary(js, jg), tmetrics.objective_summary(ts, tg)
        assert set(j) == set(t)
        for k in j:
            assert float(t[k]) == pytest.approx(float(j[k]), rel=1e-6), k


@pytest.mark.parametrize("scenario", ["mubench", "powerlaw"])
@pytest.mark.parametrize("algorithm", ["communication", "spread"])
def test_logger_gate_records_equal_jax(scenario, algorithm):
    """With a logger attached the JAX loop turns cost attribution on
    (``obs.attribution`` and a listener) and records it every round; the
    port's loop does the same: the records are equal, attribution
    included, round for round."""
    jb, tb = j_make(scenario, 0), t_make(scenario, 0, device="cpu")
    jb.inject_imbalance(jb.node_names[0])
    tb.inject_imbalance(tb.node_names[0])
    kw = dict(algorithm=algorithm, max_rounds=5, sleep_after_action_s=0.0)
    jr = j_run(jb, JConfig(**kw), logger=JLogger(name="j"))
    tr = t_run(tb, TConfig(**kw), device="cpu", logger=TLogger(name="t"))
    assert len(tr.rounds) == len(jr.rounds) == 5
    keys = ("round", "moved", "most_hazard", "service", "target", "services_moved",
            "applied_moves", "communication_cost", "attribution")
    for j, t in zip(jr.rounds, tr.rounds):
        assert j.attribution is not None
        assert {k: getattr(t, k) for k in keys} == {k: getattr(j, k) for k in keys}
        assert json.dumps(t.as_dict()["attribution"], sort_keys=True) == \
            json.dumps(j.as_dict()["attribution"], sort_keys=True)


@pytest.mark.parametrize("scenario", ["mubench", "powerlaw"])
def test_ops_plane_gate_records_equal_jax(scenario, tmp_path):
    """The same gate with an ops plane attached and no logger."""
    jb, tb = j_make(scenario, 0), t_make(scenario, 0, device="cpu")
    jb.inject_imbalance(jb.node_names[0])
    tb.inject_imbalance(tb.node_names[0])
    kw = dict(algorithm="communication", max_rounds=3, sleep_after_action_s=0.0)
    jplane = jserver.OpsPlane.from_config(JObs(), registry=jregistry.MetricsRegistry(),
                                          bundle_dir=str(tmp_path / "j"))
    tplane = tserver.OpsPlane.from_config(TConfig(), registry=tregistry.MetricsRegistry(),
                                          bundle_dir=str(tmp_path / "t"))
    jr = j_run(jb, JConfig(**kw), ops=jplane)
    tr = t_run(tb, TConfig(**kw), device="cpu", ops=tplane)
    for j, t in zip(jr.rounds, tr.rounds):
        assert t.attribution == j.attribution and t.attribution is not None
        assert t.explanations == j.explanations
    assert tplane.health.rounds == jplane.health.rounds == 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timeline_equals_jax_bit_for_bit(seed):
    """The port's timeline computes each move's deltas over the adjacency
    row's peers only; on multi-replica services, non-integer weights and
    random moves (unknown names and pod-level rounds included) its blocks
    equal the JAX package's timeline's, bit for bit."""
    rng = np.random.default_rng(seed)
    n_s, n_n = 60, 9
    names = [f"s{i}" for i in range(n_s)]
    rel = {names[i]: [names[j] for j in rng.choice(n_s, size=4, replace=False) if j != i]
           for i in range(n_s)}
    weights = rng.uniform(0.1, 3.0, size=(n_s, n_s)).astype(np.float32)
    pods = np.repeat(np.arange(n_s), rng.integers(1, 4, size=n_s))
    nodes = rng.integers(0, n_n, size=pods.size)
    kw = dict(node_names=[f"n{i}" for i in range(n_n)], node_cpu_cap=[1e4] * n_n,
              node_mem_cap=[1e9] * n_n, pod_services=pods.tolist(), pod_nodes=nodes.tolist(),
              pod_cpu=[10.0] * pods.size, pod_mem=[1.0] * pods.size)
    jg = jstate.CommGraph.from_relation(rel, names=names)
    tg = tstate.CommGraph.from_relation(rel, names=names, device="cpu")
    import dataclasses

    jg = dataclasses.replace(jg, adj=np.asarray(jg.adj) * weights)
    tg = dataclasses.replace(tg, adj=tg.adj * torch.from_numpy(weights))
    jt, tt = jattr.PlacementTimeline(), tattr.PlacementTimeline()
    jt.bind(jstate.ClusterState.build(**kw), jg)
    tt.bind(tstate.ClusterState.build(**kw, device="cpu"), tg)
    for rnd in range(1, 8):
        moves = [(names[int(rng.integers(n_s))], f"n{int(rng.integers(n_n))}")
                 for _ in range(int(rng.integers(1, 6)))]
        if rnd == 3:
            moves.append(("ghost", "n0"))
        pod_level = rnd == 5
        jb = jt.observe_round(rnd, moves, pod_level=pod_level)
        tb = tt.observe_round(rnd, moves, pod_level=pod_level)
        assert json.dumps(tb, sort_keys=True) == json.dumps(jb, sort_keys=True)
    assert tt.residency == jt.residency
