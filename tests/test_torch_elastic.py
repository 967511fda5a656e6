"""The elastic plane (``elastic/``, the simulator's mutators and churn in the
control loop) against the JAX package's, after tests/test_elastic.py:92-702
and :802-881 (without the fleet, watchdog, attribution and harness cases,
which wait for their ROADMAP items).

- Buckets quantize and promote as the JAX package's; ``device_view`` strips
  names only.
- Mask twins: a bucket-padded problem decides, explains, costs and solves
  (dense and sparse) exactly as the unpadded one.
- Every profile's event stream equals the JAX package's, dict for dict, from
  the same seed, and the simulators' snapshots stay equal under it.
- Churned runs equal the JAX package's, records and churn blocks included;
  remask debt survives a skipped round; a resume fast-forwards the churn
  stream; a checkpoint with pending churn written by either package resumes
  in the other; and a churned run keys a new capture only on a promotion.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch
from test_torch_controller import DECISIONS, jax_greedy_gumbel
from test_torch_global_solver import jax_plan
from test_torch_sim_device import strip

from kubernetes_rescheduling_tpu.backends import sim as jsim
from kubernetes_rescheduling_tpu.bench.controller import run_controller as j_run
from kubernetes_rescheduling_tpu.bench.harness import make_backend as j_make
from kubernetes_rescheduling_tpu.bench.loadgen import service_rate_series as j_rates
from kubernetes_rescheduling_tpu.config import ELASTIC_PROFILES as J_ELASTIC_PROFILES
from kubernetes_rescheduling_tpu.config import ElasticConfig
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.core import workmodel as jwm
from kubernetes_rescheduling_tpu.elastic import ChurnEngine as JEngine
from kubernetes_rescheduling_tpu.elastic import ShapeBuckets as JBuckets
from kubernetes_rescheduling_tpu.elastic import bucket_capacity as j_cap
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu.utils.retry import RetryPolicy as JRetry
from kubernetes_rescheduling_tpu_torch import cli as t_cli
from kubernetes_rescheduling_tpu_torch import convert
from kubernetes_rescheduling_tpu_torch.backends import sim as tsim
from kubernetes_rescheduling_tpu_torch.backends.sim import LoadModel, SimBackend
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend as t_make
from kubernetes_rescheduling_tpu_torch.config import ELASTIC_PROFILES
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.core import workmodel as twm
from kubernetes_rescheduling_tpu_torch.core.sparsegraph import from_comm_graph
from kubernetes_rescheduling_tpu_torch.elastic import (
    ChurnEngine,
    ShapeBuckets,
    bucket_capacity,
    device_graph,
    device_view,
)
from kubernetes_rescheduling_tpu_torch.elastic.rates import service_rate_series
from kubernetes_rescheduling_tpu_torch.objectives import metrics as tmetrics
from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS, POLICY_NAMES
from kubernetes_rescheduling_tpu_torch.solver import compiled
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs
from kubernetes_rescheduling_tpu_torch.solver import sparse_solver as tss
from kubernetes_rescheduling_tpu_torch.solver.round_loop import decide, decide_explain
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry
from kubernetes_rescheduling_tpu_torch.utils.retry import RetryPolicy as TRetry


# ---------------------------------------------------------------- buckets


def test_bucket_capacity_and_promotion_match_jax():
    for n, floor in ((0, 8), (1, 8), (8, 8), (9, 8), (1000, 8), (10_000, 8), (3, 4)):
        assert bucket_capacity(n, floor=floor) == j_cap(n, floor=floor)
    assert bucket_capacity(10_000) == 16_384
    with pytest.raises(ValueError):
        bucket_capacity(-1)
    fits = [dict(services=20, nodes=3, pods=21), dict(services=25, nodes=5, pods=30),
            dict(services=40, nodes=3, pods=40), dict(services=5, nodes=1, pods=5),
            dict(services=40, nodes=9, pods=200)]
    t, j = ShapeBuckets(floor=8), JBuckets(floor=8)
    for live in fits:
        assert t.fit(**live) == j.fit(**live)
        assert t.as_dict() == j.as_dict() and t.history == j.history
    assert t.promotions == 2 and (t.services, t.nodes, t.pods) == (64, 16, 256)


def test_device_view_strips_names_only():
    backend = t_make("mubench", 0, device="cpu")
    state, graph = backend.monitor(), backend.comm_graph()
    view, gview = device_view(state), device_graph(graph)
    assert view.node_names == () and view.pod_names == () and view.pod_node is state.pod_node
    assert gview.names == () and gview.adj is graph.adj
    assert device_view(view) is view and device_graph(gview) is gview


# ------------------------------------------------------------- mask twins


def twin_problem(seed=2):
    """The same live cluster at exact and at bucket-padded shapes (nodes
    3 → 8, pods 21 → 64, services 20 → 32)."""
    exact = t_make("mubench", seed, device="cpu")
    padded = t_make("mubench", seed, device="cpu")
    padded.set_capacities(node=8, pod=64, service=32)
    for b in (exact, padded):
        b.inject_imbalance(b.node_names[0])
    return exact.monitor(), exact.comm_graph(), padded.monitor(), padded.comm_graph()


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_mask_twin_greedy_decide(policy):
    """Padded and masked decides as unpadded, in all five policies (the
    random policy's row padded with noise the masked nodes never use)."""
    st, gr, pst, pgr = twin_problem()
    g = torch.tensor(np.asarray(jax.random.gumbel(jax.random.PRNGKey(7), (8,))))
    a = decide(st, gr, POLICY_IDS[policy], 30.0, g[:3])
    b = decide(pst, pgr, POLICY_IDS[policy], 30.0, g)
    for x, y in zip(a[:1] + a[2:], b[:1] + b[2:]):
        assert int(x) == int(y)
    assert torch.equal(a[1], b[1][:3]) and not b[1][3:].any()


def test_mask_twin_explain_bundle_and_objectives():
    st, gr, pst, pgr = twin_problem()
    *a, bundle_a = decide_explain(st, gr, POLICY_IDS["communication"], 30.0, top_k=3)
    *b, bundle_b = decide_explain(pst, pgr, POLICY_IDS["communication"], 30.0, top_k=3)
    assert [int(x) for x in a[:1] + a[2:]] == [int(x) for x in b[:1] + b[2:]]
    assert torch.equal(bundle_a, bundle_b)
    assert float(tmetrics.communication_cost(st, gr)) == float(
        tmetrics.communication_cost(pst, pgr))
    assert float(tmetrics.load_std(st)) == float(tmetrics.load_std(pst))
    assert float(tmetrics.capacity_violation(st)) == float(tmetrics.capacity_violation(pst))
    assert float(tmetrics.communication_cost_edges(st, gr.num_services,
                                                   tmetrics.comm_edge_list(gr))) == float(
        tmetrics.communication_cost_edges(pst, pgr.num_services,
                                          tmetrics.comm_edge_list(pgr)))


def test_mask_twin_global_solves():
    """A noise-free dense and sparse solve of the padded problem moves the
    live pods exactly as the unpadded one (the padded slots stay put)."""
    st, gr, pst, pgr = twin_problem()
    cfg = tgs.GlobalSolverConfig(sweeps=4, noise_temp=0.0)
    p, q = st.num_pods, int(pst.pod_valid.sum())
    assert p == q
    a, _ = tgs.global_assign(st, gr, torch.Generator().manual_seed(0), cfg)
    b, _ = tgs.global_assign(pst, pgr, torch.Generator().manual_seed(0), cfg)
    assert torch.equal(a.pod_node, b.pod_node[:p])
    assert torch.equal(b.pod_node[p:], pst.pod_node[p:])
    sa, _ = tss.global_assign_sparse(st, from_comm_graph(gr), torch.Generator().manual_seed(0),
                                     cfg)
    sb, _ = tss.global_assign_sparse(pst, from_comm_graph(pgr),
                                     torch.Generator().manual_seed(0), cfg)
    assert torch.equal(sa.pod_node, sb.pod_node[:p])


# --------------------------------------------------------- profiles


@pytest.mark.parametrize("scenario", ["mubench", "dense"])
@pytest.mark.parametrize("profile", ELASTIC_PROFILES)
def test_profile_streams_and_snapshots_match_jax(profile, scenario):
    """From the same seed, every profile's events equal the JAX package's
    dict for dict, and after every round both simulators serve the same
    snapshot, graph and event log."""
    jb, tb = j_make(scenario, 1), t_make(scenario, 1, device="cpu")
    je, te = JEngine(profile, seed=3, registry=JRegistry()), ChurnEngine(
        profile, seed=3, registry=TRegistry())
    je.bind(jb, 20)
    te.bind(tb, 20)
    for rnd in range(1, 21):
        assert te.step(rnd) == je.step(rnd), rnd
        assert (te.graph_changed, te.promoted) == (je.graph_changed, je.promoted)
        ts, js = tb.monitor(), jb.monitor()
        for k in convert.STATE_ARRAYS:
            np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)),
                                          err_msg=f"{k} round {rnd}")
        assert ts.pod_names == js.pod_names and ts.node_names == js.node_names
        assert te.round_info([]) == je.round_info([])
    np.testing.assert_array_equal(tb.comm_graph().adj.numpy(), np.asarray(jb.comm_graph().adj))
    assert tb.comm_graph().names == jb.comm_graph().names
    assert tb.events == jb.events and tb.clock_s == jb.clock_s
    assert te.events_log == je.events_log


def tiny_pair(seed=0, **kw):
    """A 3-service chain on 2 nodes in both packages."""
    out = []
    for wm, sim, extra in ((jwm, jsim, {}), (twm, tsim, {"device": "cpu"})):
        w = wm.Workmodel(services=(wm.ServiceSpec(name="a", callees=("b",)),
                                   wm.ServiceSpec(name="b", callees=("c",)),
                                   wm.ServiceSpec(name="c")))
        out.append(sim.SimBackend(workmodel=w, node_names=["n0", "n1"], seed=seed,
                                  load=sim.LoadModel(entry_service="a"), **extra, **kw))
    return out


def test_sim_mutators_match_jax():
    """tests/test_elastic.py:303-343 on both simulators: teardown compacts
    the indices and the graph, scaling and deploys track replicas, a drain
    re-places its pods and an add revives or grows — the same snapshots."""
    jb, tb = tiny_pair()
    for b, wm in ((jb, jwm), (tb, twm)):
        b.teardown_service("b")
        with pytest.raises(ValueError):
            b.teardown_service("b")
        b.scale_replicas("a", 3)
        b.scale_replicas("a", 1)
        b.deploy_service(wm.ServiceSpec(name="d", callees=("a",), replicas=2))
        with pytest.raises(ValueError):
            b.deploy_service(wm.ServiceSpec(name="d"))
        b.add_node("n2")
        b.drain_node("n0")
        b.scale_replicas("d", 4)
        b.add_node("n0")
    assert tb.live_counts() == jb.live_counts() == {"services": 3, "nodes": 3, "pods": 6}
    assert tb.alive_node_names() == jb.alive_node_names() == ["n0", "n1", "n2"]
    ts, js = tb.monitor(), jb.monitor()
    for k in convert.STATE_ARRAYS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)))
    assert ts.pod_names == js.pod_names
    g = tb.comm_graph()
    assert g.names == ("a", "c", "d") and g.adj[2, 0] > 0
    assert tb.events == jb.events


def test_rate_profile_matches_jax():
    wm_t, wm_j = twm.mubench_workmodel_c(), jwm.mubench_workmodel_c()
    for kw in (dict(amplitude=2.0, steps=8, phase_jitter=0.0), dict(seed=4),
               dict(entry_rps=10.0, fanout_frac=0.5, seed=1)):
        t, j = service_rate_series(wm_t, **kw), j_rates(wm_j, **kw)
        for r, h in ((1, 30), (7, 30), (4, 10)):
            assert t.factors(r, h) == j.factors(r, h)
            assert t.at(r, h) == j.at(r, h)
            assert t.per_replica(r, h, {"s0": 4}) == j.per_replica(r, h, {"s0": 4})
    rp = service_rate_series(wm_t, amplitude=2.0, steps=8, phase_jitter=0.0)
    factors = [rp.factors(r, 30)["s0"] for r in range(1, 31)]
    assert max(factors) > 1.8 and min(factors) < 0.6


def test_promotion_counts_and_clears_solver_caches():
    backend = tiny_pair()[1]
    backend._solver_caches = {"solve_adj": {"graph": object()}}
    reg = TRegistry()
    eng = ChurnEngine("deploy-waves", seed=0, bucket_floor=4, registry=reg)
    eng.bind(backend, 30)
    assert backend.service_capacity == 4
    promoted = []
    for rnd in range(1, 8):
        eng.step(rnd)
        if eng.promoted:
            promoted.append(rnd)
    assert promoted and eng.buckets.promotions == len(promoted)
    assert backend._solver_caches == {}
    assert backend.service_capacity >= eng.buckets.services
    assert reg.value("bucket_promotions_total") == eng.buckets.promotions
    assert reg.value("bucket_capacity", axis="services") == eng.buckets.services
    assert reg.value("churn_events_total", kind="service_deploy") >= 2


def test_engine_requires_elastic_mutators():
    class NotASim:
        pass

    with pytest.raises(TypeError, match="elastic mutators"):
        ChurnEngine("steady", registry=TRegistry()).bind(NotASim(), 10)


def test_churn_wave_advances_clock_once():
    backend = t_make("mubench", 1, device="cpu")
    eng = ChurnEngine("diurnal-autoscale", seed=3, registry=TRegistry())
    eng.bind(backend, 10)
    before = backend.clock_s
    assert len(eng.step(2)) > 1
    assert backend.clock_s - before == pytest.approx(backend.reconcile_delay_s)


# ------------------------------------------------- churn in the loop


def churn_plans(backend, seed: int):
    """Dense global plans from the JAX key stream at the backend's CURRENT
    (bucket-padded) shapes."""
    def plans(rnd: int):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
        return jax_plan(key, jgs.GlobalSolverConfig(sweeps=9), backend.comm_graph().num_services,
                        backend.node_capacity, inline=False)
    return plans


@pytest.mark.parametrize("algorithm", ["communication", "global"])
@pytest.mark.parametrize("profile", ELASTIC_PROFILES)
def test_churned_run_matches_jax(profile, algorithm):
    """The same churned run in both packages: decisions, costs, churn and
    reconcile blocks (churn re-anchors the ledger, never drift) and the
    simulator's log."""
    seed, rounds = 1, 8 if algorithm == "communication" else 4
    jb, tb = j_make("mubench", seed), t_make("mubench", seed, device="cpu")
    for b in (jb, tb):
        b.inject_imbalance(b.node_names[0])
    kw = dict(algorithm=algorithm, max_rounds=rounds, sleep_after_action_s=0.0, seed=seed)
    j = j_run(jb, JConfig(elastic=ElasticConfig(profile=profile, seed=7), **kw),
              registry=JRegistry())
    seam = ({"gumbel_rows": jax_greedy_gumbel(seed, 3)} if algorithm == "communication"
            else {"solver_plans": churn_plans(tb, seed)})
    t = t_run(tb, TConfig(elastic=profile, elastic_seed=7, **kw), device="cpu",
              registry=TRegistry(), **seam)
    assert len(t.rounds) == len(j.rounds) == rounds
    for a, b in zip(t.rounds, j.rounds):
        for k in DECISIONS + ("churn", "reconcile", "degraded"):
            assert getattr(a, k) == getattr(b, k), (a.round, k)
        assert a.communication_cost == b.communication_cost
        assert a.load_std == pytest.approx(b.load_std, rel=1e-6)
    assert tb.events == jb.events
    assert all(r.churn is not None for r in t.rounds)


class FlakyMonitor:
    def __init__(self, inner, fail_calls):
        self.inner, self.calls, self.fail_calls = inner, 0, set(fail_calls)

    def monitor(self):
        self.calls += 1
        if self.calls in self.fail_calls:
            raise ConnectionError("flaky monitor")
        return self.inner.monitor()

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_remask_debt_survives_a_skipped_round():
    """A churned round whose re-mask monitor fails is a counted skip; the
    next executed round still re-masks before deciding and carries the
    skipped round's events — as in the JAX package."""
    runs = {}
    for pkg, make, run, cfg, retry, extra in (
        ("jax", j_make, j_run, lambda **k: JConfig(elastic=ElasticConfig(
            profile="deploy-waves", seed=5), **k), JRetry, {"registry": JRegistry()}),
        ("torch", lambda s: t_make("mubench", s, device="cpu"), t_run,
         lambda **k: TConfig(elastic="deploy-waves", elastic_seed=5, **k), TRetry,
         {"registry": TRegistry(), "device": "cpu",
          "gumbel_rows": jax_greedy_gumbel(6, 3)}),
    ):
        inner = make("mubench", 6) if pkg == "jax" else make(6)
        inner.inject_imbalance(inner.node_names[0])
        runs[pkg] = run(FlakyMonitor(inner, {2}), cfg(
            algorithm="communication", max_rounds=4, sleep_after_action_s=0.0, seed=6,
            retry=retry(max_attempts=1, base_delay_s=0.0)), **extra)
    t = runs["torch"]
    assert t.skipped_rounds == 1 and len(t.rounds) == 3
    first = t.rounds[0]
    assert first.churn["live_services"] > 20
    assert any(e["round"] == 1 for e in first.churn["events"])
    for a, b in zip(t.rounds, runs["jax"].rounds):
        for k in DECISIONS + ("churn", "reconcile"):
            assert getattr(a, k) == getattr(b, k), (a.round, k)


def test_resume_fast_forwards_the_churn_stream(tmp_path):
    def build():
        b = t_make("mubench", 4, device="cpu")
        b.inject_imbalance(b.node_names[0])
        return b

    cfg = TConfig(algorithm="communication", max_rounds=6, sleep_after_action_s=0.0, seed=4,
                  elastic="deploy-waves", elastic_seed=5)
    full_backend = build()
    full = t_run(full_backend, cfg, device="cpu", registry=TRegistry(),
                 checkpoint_dir=str(tmp_path / "full"))

    class Boom(Exception):
        pass

    def crash_at_3(rec, _state):
        if rec.round == 3:
            raise Boom()

    with pytest.raises(Boom):
        t_run(build(), cfg, device="cpu", registry=TRegistry(),
              checkpoint_dir=str(tmp_path / "crash"), on_round=crash_at_3)
    resumed_backend = build()
    resumed = t_run(resumed_backend, cfg, device="cpu", registry=TRegistry(),
                    checkpoint_dir=str(tmp_path / "crash"))
    assert resumed.resumed_from_round == 3
    assert [strip(r) for r in resumed.rounds] == [strip(r) for r in full.rounds[2:]]
    assert resumed_backend.live_counts() == full_backend.live_counts()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_with_pending_churn_resumes_across_packages(writer, tmp_path):
    """A run whose breaker skips churned rounds checkpoints pending churn
    events (``pending_churn`` and the ledger's ``pending_events``); the
    other package resumes from it and continues as the writer would."""
    seed, d = 6, str(tmp_path / "ckpt")

    def backends():
        jb, tb = j_make("mubench", seed), t_make("mubench", seed, device="cpu")
        for b in (jb, tb):
            b.inject_imbalance(b.node_names[0])
        return jb, tb

    def cfgs(rounds):
        kw = dict(algorithm="communication", max_rounds=rounds, sleep_after_action_s=0.0,
                  seed=seed, max_consecutive_failures=1, breaker_cooldown_rounds=2)
        return (JConfig(elastic=ElasticConfig(profile="deploy-waves", seed=5),
                        retry=JRetry(max_attempts=1, base_delay_s=0.0), **kw),
                TConfig(elastic="deploy-waves", elastic_seed=5,
                        retry=TRetry(max_attempts=1, base_delay_s=0.0), **kw))

    # the writer runs 2 rounds and goes dark at round 2's monitor: round 2
    # executes degraded, and the checkpoint carries undiffed churn
    jb, tb = backends()
    jcfg, tcfg = cfgs(2)
    if writer == "jax":
        j_run(FlakyMonitor(jb, {3}), jcfg, registry=JRegistry(), checkpoint_dir=d)
    else:
        t_run(FlakyMonitor(tb, {3}), tcfg, device="cpu", registry=TRegistry(),
              checkpoint_dir=d, gumbel_rows=jax_greedy_gumbel(seed, 3))
    meta = json.loads(open(f"{d}/round_000002.json").read())
    assert "pending_events" in meta["extra"]["reconcile"]
    jb, tb = backends()
    jcfg, tcfg = cfgs(5)
    # each package resumes a copy of the same checkpoint directory
    shutil.copytree(d, d + "_j")
    shutil.copytree(d, d + "_t")
    j = j_run(jb, jcfg, registry=JRegistry(), checkpoint_dir=d + "_j")
    t = t_run(tb, tcfg, device="cpu", registry=TRegistry(), checkpoint_dir=d + "_t",
              gumbel_rows=jax_greedy_gumbel(seed, 3))
    assert t.resumed_from_round == j.resumed_from_round == 3
    assert len(t.rounds) == len(j.rounds) == 3
    for a, b in zip(t.rounds, j.rounds):
        for k in DECISIONS + ("churn", "reconcile"):
            assert getattr(a, k) == getattr(b, k), (a.round, k)
    assert tb.live_counts() == jb.live_counts()


def test_solve_keys_change_only_on_a_promotion(monkeypatch):
    """A churned dense global run whose deploy waves change the graph every
    few rounds and outgrow the service bucket once: the solve's capture key
    changes only at the promotion (the adjacency is written into one buffer
    a bucket shape), so on the card ``cuda_graph_captures_total
    {fn="global_assign"} == 1 + bucket_promotions_total``."""
    keys = []
    real = compiled.GraphCache.run

    def record(self, fn, key, inputs, make_body, operands=()):
        keys.append(compiled.GraphCache._full_key(fn, key, inputs, operands))
        return real(self, fn, key, inputs, make_body, operands)

    monkeypatch.setattr(compiled.GraphCache, "run", record)
    # 5 services in the bucket of 8: the first wave (+2) fits, the second
    # (round 6, +2) promotes it, the third (round 11) swaps a wave in place
    names = "abcde"
    wm = twm.Workmodel(services=tuple(
        twm.ServiceSpec(name=n, callees=(names[i + 1],) if i + 1 < 5 else ())
        for i, n in enumerate(names)))
    backend = SimBackend(workmodel=wm, node_names=["n0", "n1", "n2"], seed=0,
                         load=LoadModel(entry_service="a"), device="cpu")
    reg = TRegistry()
    res = t_run(backend, TConfig(algorithm="global", max_rounds=12, sleep_after_action_s=0.0,
                                 seed=2, elastic="deploy-waves", elastic_seed=1,
                                 global_solver_iters=2),
                device="cpu", registry=reg)
    graph_rounds = [r.round for r in res.rounds
                    if any(e["kind"] in ("service_deploy", "service_teardown")
                           for e in r.churn["events"])]
    assert len(res.rounds) == 12 and len(keys) == 12 and graph_rounds == [1, 6, 11]
    # a promotion before the first solve folds into its capture
    promotions = res.rounds[-1].churn["promotions"] - res.rounds[0].churn["promotions"]
    assert promotions == 1 == reg.value("bucket_promotions_total")
    changed = [b for a, b in zip(keys, keys[1:]) if a != b]
    assert len(set(keys)) == 1 + promotions and len(changed) == promotions
    assert keys.index(changed[0]) == 5     # round 6's solve, at the promotion


def test_elastic_config_validation_and_cli(capsys):
    assert set(ELASTIC_PROFILES) == set(J_ELASTIC_PROFILES)
    with pytest.raises(ValueError, match="churn profile"):
        TConfig(elastic="tsunami").validate()
    with pytest.raises(ValueError, match="bucket_floor"):
        TConfig(bucket_floor=0).validate()
    assert t_cli.main(["reschedule", "--scenario", "mubench", "--rounds", "3", "--imbalance",
                       "--churn-profile", "steady", "--churn-seed", "2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert len(out["rounds"]) + out["skipped_rounds"] == 3
    assert out["rounds"][0]["churn"] is not None
    with pytest.raises(SystemExit, match="churn profile"):
        t_cli.main(["reschedule", "--churn-profile", "tsunami", "--device", "cpu"])
