"""Shadow mode against the JAX package on the CPU: the replay backend, the
shadow plane's counterfactual twin, the loop in shadow mode, the report, the
watchdog rule and the CLI — every case of tests/test_shadow.py past its
corpus section, plus tests/test_serving.py's
``test_alibaba_fixture_served_parity``.

Bars:

- the replay backend's snapshots, recommendations and counters equal the
  JAX backend's exactly;
- greedy shadow runs (CAR, kubescheduling): records and shadow blocks equal
  exactly (costs are integer pair counts), load spreads within rel 1e-6 (f32
  standard deviations reduced in another order, the bar of
  tests/test_torch_controller.py);
- global shadow runs fed the JAX key stream (``solver_plans``) at
  ``balance_weight=0``: the same bars. At 0.5 the port's eager solve may
  break a tie differently from the JAX jit (ROADMAP Queue 3), so there the
  JAX acceptance test's own invariants hold in both packages: every round
  scored, win rate 1.0, every ``cost_delta`` > 0, the twin's attribution
  consistent with its cost;
- the plane driven directly with the same moves: the twin, the owned set and
  the scores equal the JAX plane's dict for dict.
"""

import json
import random
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_controller import DECISIONS
from test_torch_global_solver import jax_plan

from kubernetes_rescheduling_tpu import traces as jtr
from kubernetes_rescheduling_tpu.backends.base import MoveRequest as JMove
from kubernetes_rescheduling_tpu.backends.replay import ReplayBackend as JReplay
from kubernetes_rescheduling_tpu.bench import shadow as jshadow
from kubernetes_rescheduling_tpu.bench.controller import run_controller as j_run
from kubernetes_rescheduling_tpu.bench.round_end import RoundCloser as JCloser
from kubernetes_rescheduling_tpu.cli import main as j_cli
from kubernetes_rescheduling_tpu.config import ChaosConfig as JChaos
from kubernetes_rescheduling_tpu.config import ElasticConfig as JElastic
from kubernetes_rescheduling_tpu.config import FleetConfig as JFleet
from kubernetes_rescheduling_tpu.config import ReconcileConfig as JReconcile
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.config import ServingConfig as JServingConfig
from kubernetes_rescheduling_tpu.config import ShadowConfig as JShadow
from kubernetes_rescheduling_tpu.serving import ServingEngine as JEngine
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu.telemetry import watchdog as jwatchdog
from kubernetes_rescheduling_tpu_torch import cli as t_cli
from kubernetes_rescheduling_tpu_torch import traces as ttr
from kubernetes_rescheduling_tpu_torch.backends.base import MoveRequest as TMove
from kubernetes_rescheduling_tpu_torch.backends.replay import ReplayBackend as TReplay
from kubernetes_rescheduling_tpu_torch.bench import shadow as tshadow
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.round_end import RoundCloser as TCloser
from kubernetes_rescheduling_tpu_torch.config import FleetConfig as TFleet
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.config import ServingConfig as TServingConfig
from kubernetes_rescheduling_tpu_torch.config import ShadowConfig as TShadow
from kubernetes_rescheduling_tpu_torch.serving import ServingEngine as TEngine
from kubernetes_rescheduling_tpu_torch.serving import place_batch as t_place_batch
from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS
from kubernetes_rescheduling_tpu_torch.solver import compiled
from kubernetes_rescheduling_tpu_torch.solver.global_solver import GlobalSolverConfig
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry
from kubernetes_rescheduling_tpu_torch.telemetry import watchdog as twatchdog
from kubernetes_rescheduling_tpu_torch.telemetry.attribution import attribution_consistent
from kubernetes_rescheduling_tpu_torch.telemetry.report import report_shadow
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger

FIXTURES = Path(__file__).parent / "fixtures" / "shadow"
LOAD_STD_REL = 1e-6


def metric(reg, name, **labels):
    for rec in reg.snapshot():
        if rec["metric"] == name and (rec.get("labels") or {}) == labels:
            return rec.get("value")
    return None


def alibaba(pkg):
    return pkg.load_alibaba_csv(FIXTURES / "alibaba_machines.csv",
                                FIXTURES / "alibaba_containers.csv")


def j_cfg(algorithm="global", rounds=4, balance_weight=None, **kw):
    bw = (0.5 if algorithm == "global" else 0.0) if balance_weight is None else balance_weight
    return JConfig(algorithm=algorithm, max_rounds=rounds, sleep_after_action_s=0.0,
                   balance_weight=bw, shadow=JShadow(enabled=True), backend="replay", **kw)


def t_cfg(algorithm="global", rounds=4, balance_weight=None, **kw):
    bw = (0.5 if algorithm == "global" else 0.0) if balance_weight is None else balance_weight
    return TConfig(algorithm=algorithm, max_rounds=rounds, sleep_after_action_s=0.0,
                   balance_weight=bw, shadow=TShadow(enabled=True), backend="replay", **kw)


def jax_global_plans(trace, seed=0, sweeps=9):
    """Each global round's per-sweep plans from the JAX loop's key stream
    (``fold_in(PRNGKey(seed), round)``) at the trace's shapes."""
    S, N = len(trace.service_names), len(trace.node_names)
    cfg = jgs.GlobalSolverConfig(sweeps=sweeps)
    return lambda rnd: jax_plan(jax.random.fold_in(jax.random.PRNGKey(seed), rnd), cfg, S, N,
                                inline=False)


def assert_shadow_block_equal(t, j):
    assert (t is None) == (j is None)
    if t is None:
        return
    assert set(t) == set(j)
    for k in t:
        if k.startswith("load_std"):
            assert t[k] == pytest.approx(j[k], rel=LOAD_STD_REL), k
        elif k == "edges_delta":
            # ties in delta order by set iteration in both packages
            key = lambda e: (e["src_service"], e["dst_service"])  # noqa: E731
            assert sorted(t[k], key=key) == sorted(j[k], key=key)
        elif k != "attribution":
            assert t[k] == j[k], k


def assert_same_shadow_records(t_res, j_res):
    assert len(t_res.rounds) == len(j_res.rounds)
    for t, j in zip(t_res.rounds, j_res.rounds):
        for k in DECISIONS + ("reconcile",):
            assert getattr(t, k) == getattr(j, k), (t.round, k)
        assert t.communication_cost == j.communication_cost, t.round
        assert t.load_std == pytest.approx(j.load_std, rel=LOAD_STD_REL), t.round
        assert_shadow_block_equal(t.shadow, j.shadow)


def shadow_pair(trace_of, algorithm, rounds, *, balance_weight=None, seed=0, logger=False,
                sink=None):
    jreg, treg = JRegistry(), TRegistry()
    jb, tb = JReplay(trace_of(jtr), registry=jreg), TReplay(trace_of(ttr), registry=treg,
                                                           device="cpu")
    kw = dict(balance_weight=balance_weight, seed=seed)
    seam = ({"solver_plans": jax_global_plans(tb.trace, seed)} if algorithm == "global"
            else {})
    j = j_run(jb, j_cfg(algorithm, rounds, **kw), key=jax.random.PRNGKey(seed), registry=jreg,
              logger=StructuredLogger(name="j-shadow") if logger else None)
    t = t_run(tb, t_cfg(algorithm, rounds, **kw), device="cpu", registry=treg,
              logger=StructuredLogger(name="t-shadow") if logger else None,
              on_round=sink, **seam)
    return jb, tb, j, t, jreg, treg


# ---------------- replay backend ----------------


def test_replay_backend_serves_windows_and_never_mutates():
    jreg, treg = JRegistry(), TRegistry()
    jt, tt = alibaba(jtr), alibaba(ttr)
    jb, tb = JReplay(jt, registry=jreg), TReplay(tt, registry=treg, device="cpu")
    served = []
    for b, Move in ((jb, JMove), (tb, TMove)):
        s0, s1 = b.monitor(), b.monitor()
        assert b.window == 1
        assert b.apply_move(Move(service="app_a", target_node="m_3")) == "m_3"  # advisory echo
        assert b.recommendations[-1]["service"] == "app_a"
        s2 = b.monitor()
        tail = [b.monitor() for _ in range(10)][-1]
        assert b.exhausted and b.window == len(b.trace.windows()) - 1
        assert s0.num_pods == s1.num_pods == s2.num_pods  # static shapes
        served.append([s0, s1, s2, tail])
    assert tb.recommendations == jb.recommendations
    assert tb.clock_s == jb.clock_s
    for t_state, j_state in zip(served[1], served[0]):
        np.testing.assert_array_equal(t_state.pod_node.numpy(), np.asarray(j_state.pod_node))
        np.testing.assert_array_equal(t_state.pod_cpu.numpy(), np.asarray(j_state.pod_cpu))
        assert t_state.pod_names == tuple(j_state.pod_names)
    # no mutation path: the pristine next window, bit-identical to a fresh replay's
    fresh = TReplay(tt, device="cpu")
    fresh.monitor(), fresh.monitor()
    np.testing.assert_array_equal(fresh.monitor().pod_node.numpy(), served[1][2].pod_node.numpy())
    np.testing.assert_array_equal(
        served[1][3].pod_node.numpy(),
        ttr.window_state(tt, len(tt.windows()) - 1, device="cpu").pod_node.numpy())
    for name in ("shadow_recommendations_total",):
        assert metric(treg, name) == metric(jreg, name) == 1
    # one graph object, whatever the window
    assert tb.comm_graph() is tb.comm_graph()


def test_replay_counts_phantom_node_refs_once_at_load():
    jreg, treg = JRegistry(), TRegistry()
    jb = JReplay(jtr.load_trace_jsonl(FIXTURES / "corrupt_trace.jsonl"), registry=jreg)
    tb = TReplay(ttr.load_trace_jsonl(FIXTURES / "corrupt_trace.jsonl"), registry=treg,
                 device="cpu")
    for _ in range(4):
        jb.monitor(), tb.monitor()
    got = metric(treg, "trace_rows_quarantined_total", reason="unknown_node_ref")
    assert got == metric(jreg, "trace_rows_quarantined_total", reason="unknown_node_ref") == 1


# ---------------- the loop in shadow mode ----------------


def test_shadow_end_to_end_acceptance(tmp_path):
    """The JAX acceptance path at its own configuration (global, balance
    weight 0.5, a logger): recommendations with zero mutations, finite and
    sum-consistent scores, the rendered table, one round-end read a round and
    one solve capture key for the whole replay — in the port, with the JAX
    run holding the same invariants on the same trace."""
    keys = []
    real = compiled.GraphCache.run

    def record(self, fn, key, inputs, make_body, operands=()):
        keys.append(compiled.GraphCache._full_key(fn, key, inputs, operands))
        return real(self, fn, key, inputs, make_body, operands)

    rounds_path = tmp_path / "rounds.jsonl"

    def sink(rec, state):
        with rounds_path.open("a") as f:
            f.write(json.dumps(rec.as_dict(), default=float) + "\n")

    mp = pytest.MonkeyPatch()
    mp.setattr(compiled.GraphCache, "run", record)
    try:
        jb, tb, j, t, jreg, treg = shadow_pair(alibaba, "global", 4, logger=True, sink=sink)
    finally:
        mp.undo()
    for res, b, reg in ((t, tb, treg), (j, jb, jreg)):
        assert len(res.rounds) == 4
        assert b.recommendations and all(r["target"] is not None for r in b.recommendations)
        assert len(b.recommendations) == sum(len(r.applied_moves) for r in res.rounds)
        for r in res.rounds:
            blk = r.shadow
            for key in ("cost_actual", "cost_shadow", "cost_delta", "load_std_actual",
                        "load_std_shadow", "win_rate"):
                assert np.isfinite(blk[key]), (key, blk[key])
            assert blk["win_rate"] == blk["wins"] / blk["scored"]
            assert blk["edges_delta"]
            assert blk["cost_delta"] > 0
        assert res.rounds[-1].shadow["win_rate"] == 1.0
        # the trace's own churn is baseline, never drift
        assert not any(rec["metric"] == "reconcile_divergences_total"
                       for rec in reg.snapshot())
        assert metric(reg, "device_transfers_total", site="round_end") == 4
    for r in t.rounds:
        assert attribution_consistent(r.shadow["attribution"],
                                      communication_cost=r.shadow["cost_shadow"])
    # one capture key for the global solve over the whole replay
    assert len({k for k in keys if k[0] == "global_assign"}) == 1
    assert metric(treg, "shadow_rounds_total", outcome="win") == 4
    assert metric(treg, "shadow_win_rate") == 1.0
    table = report_shadow([str(rounds_path)])
    assert "win_rate" in table and "WIN" in table and "scored 4 rounds" in table
    assert "edges where we win" in table


@pytest.mark.parametrize("source", ["alibaba", "borg", "mini"])
def test_global_shadow_matches_jax_at_balance_weight_zero(source):
    """A global shadow replay fed the JAX key stream decides and scores as
    the JAX replay, record for record."""
    trace_of = {
        "alibaba": alibaba,
        "borg": lambda p: p.load_borg_csv(FIXTURES / "borg_machine_events.csv",
                                          FIXTURES / "borg_task_usage.csv"),
        "mini": lambda p: p.load_trace_jsonl(FIXTURES / "mini.trace.jsonl"),
    }[source]
    jb, tb, j, t, jreg, treg = shadow_pair(trace_of, "global", 4, balance_weight=0.0)
    assert_same_shadow_records(t, j)
    assert tb.recommendations == jb.recommendations
    assert all(r.shadow is not None for r in t.rounds)


def test_shadow_recommendations_are_deterministic():
    """Two seeded replays recommend bit-identically, and (at balance weight
    0, fed the JAX key stream) identically to the JAX replay."""

    def run(plans):
        backend = TReplay(alibaba(ttr), device="cpu")
        t_run(backend, t_cfg(rounds=2, seed=7), device="cpu", registry=TRegistry(),
              solver_plans=plans)
        return backend.recommendations

    assert run(None) == run(None)
    jb = JReplay(alibaba(jtr))
    j_run(jb, j_cfg(rounds=2, balance_weight=0.0, seed=7), key=jax.random.PRNGKey(7),
          registry=JRegistry())
    tb = TReplay(alibaba(ttr), device="cpu")
    t_run(tb, t_cfg(rounds=2, balance_weight=0.0, seed=7), device="cpu", registry=TRegistry(),
          solver_plans=jax_global_plans(tb.trace, 7))
    assert tb.recommendations == jb.recommendations


@pytest.mark.parametrize("algorithm", ["communication", "kubescheduling"])
def test_shadow_greedy_round_marks_intents_advisory(algorithm):
    """Greedy shadow rounds: the ledger adopts the recorded placement at the
    first diff — the trace's own churn never reads as lost moves or drift
    even though CAR pins with nodeName — and every round is scored, equal
    to the JAX run."""
    jb, tb, j, t, jreg, treg = shadow_pair(alibaba, algorithm, 3)
    assert len(t.rounds) == 3
    assert_same_shadow_records(t, j)
    assert tb.recommendations == jb.recommendations
    for reg in (jreg, treg):
        assert not any(rec["metric"] == "reconcile_divergences_total"
                       for rec in reg.snapshot())
    assert all(r.shadow is not None for r in t.rounds)


def test_shadow_long_soak_holds_invariants():
    """A longer replay over a wider synthetic native trace, past its clamped
    tail: every score finite, one round-end read a round, one solve capture
    key — and at balance weight 0 every record equal to the JAX replay's."""
    recs = [{"kind": "node", "t": 0.0, "node": f"n{n}", "cpu_cap_m": 16000.0,
             "mem_cap_b": 1.6e10, "alive": True} for n in range(6)]
    for wi in range(24):
        for si in range(8):
            for k in range(3):
                recs.append({"kind": "pod", "t": float(wi * 60), "pod": f"s{si}-{k}",
                             "service": f"s{si}",
                             "node": f"n{(si * 2 + k + wi * (si % 3)) % 6}",
                             "cpu_m": 200.0 + 30.0 * si + 10.0 * k, "mem_b": 2e8})

    def trace_of(pkg):
        return pkg.corpus.ClusterTrace(records=[dict(r) for r in recs], source="soak")

    keys = []
    real = compiled.GraphCache.run

    def record(self, fn, key, inputs, make_body, operands=()):
        keys.append(compiled.GraphCache._full_key(fn, key, inputs, operands))
        return real(self, fn, key, inputs, make_body, operands)

    mp = pytest.MonkeyPatch()
    mp.setattr(compiled.GraphCache, "run", record)
    try:
        jb, tb, j, t, jreg, treg = shadow_pair(trace_of, "global", 30, balance_weight=0.0,
                                               seed=1)
    finally:
        mp.undo()
    assert len(t.rounds) == 30 and tb.exhausted
    assert all(np.isfinite(r.shadow["cost_shadow"]) for r in t.rounds if r.shadow)
    assert metric(treg, "device_transfers_total", site="round_end") == 30
    assert len({k for k in keys if k[0] == "global_assign"}) == 1
    assert_same_shadow_records(t, j)


# ---------------- the plane itself ----------------


class Rec:
    """The record fields the plane reads and writes."""

    def __init__(self, applied_moves=(), cost=1.0):
        self.applied_moves = applied_moves
        self.communication_cost = cost
        self.load_std = 0.0
        self.attribution = None
        self.shadow = None
        self.phase_s = {}


def host(state):
    return {k: np.asarray(getattr(state, k)) for k in
            ("pod_valid", "pod_node", "pod_service", "node_valid")}


def test_twin_tracks_observed_for_untouched_pods():
    """The counterfactual diverges by OUR moves alone: the recorded scheduler
    reshuffling pods we never re-homed lands in the twin too; only pods a
    recommendation touched keep our node, and a recommended node that DIES
    releases them to the recorded re-placement."""
    out = {}
    for name, pkg, shadow, Closer, Registry, kw in (
            ("jax", jtr, jshadow, JCloser, JRegistry, {}),
            ("torch", ttr, tshadow, TCloser, TRegistry, {"device": "cpu"})):
        t = pkg.load_trace_jsonl(FIXTURES / "mini.trace.jsonl")
        g = t.comm_graph(**kw)
        s0, s1 = pkg.window_state(t, 0, **kw), pkg.window_state(t, 1, **kw)
        reg = Registry()
        plane = shadow.ShadowPlane(TShadow(enabled=True), registry=reg)
        plane.bind(s0, g, host(s0))
        rec = Rec((("sa", "n3"),))
        closer = Closer(reg)
        plane.observe_round(1, rec, s1, g, closer, arrays=host(s1), fresh=True, top_k=0)
        obs1 = plane._observed(s1, host(s1))
        for pod, node in plane.twin.items():
            assert node == ("n3" if pod.startswith("sa-") else obs1[pod])
        twin1 = dict(plane.twin)
        closer.flush()
        assert np.isfinite(rec.shadow["cost_shadow"])
        valid = np.array([True, True, False, True])  # n3 dies
        dead = s1.replace(node_valid=torch.as_tensor(valid) if name == "torch" else valid)
        rec2 = Rec()
        closer2 = Closer(reg)
        plane.observe_round(2, rec2, dead, g, closer2, arrays=host(dead), fresh=True, top_k=0)
        obs_dead = plane._observed(dead, host(dead))
        for pod in plane.twin:
            if pod.startswith("sa-"):
                assert plane.twin[pod] == obs_dead[pod]  # released to the recorded node
                assert pod not in plane._owned
        closer2.flush()
        out[name] = (twin1, dict(plane.twin), rec.shadow, rec2.shadow)
    assert out["torch"][:2] == out["jax"][:2]
    for a, b in zip(out["torch"][2:], out["jax"][2:]):
        assert_shadow_block_equal(a, b)


def test_twin_rehome_index_matches_jax_twin():
    """The port re-homes through a service → pods index built once a round;
    over every alibaba window with seeded recommendations (a degraded round
    among them) its twin, owned set and scores equal the JAX plane's, whose
    re-homing scans the pod table once a recommendation."""
    rng = random.Random(5)
    jt, tt = alibaba(jtr), alibaba(ttr)
    nodes, services = list(tt.node_names), list(tt.service_names)
    moves = [tuple((rng.choice(services), rng.choice(nodes)) for _ in range(rng.randint(0, 4)))
             for _ in range(len(tt.windows()))]
    planes = {}
    for name, trace, pkg, shadow, Closer, Registry, kw in (
            ("jax", jt, jtr, jshadow, JCloser, JRegistry, {}),
            ("torch", tt, ttr, tshadow, TCloser, TRegistry, {"device": "cpu"})):
        g = trace.comm_graph(**kw)
        reg = Registry()
        plane = shadow.ShadowPlane(TShadow(enabled=True, win_margin=0.1), registry=reg)
        s = pkg.window_state(trace, 0, **kw)
        plane.bind(s, g, host(s))
        steps = []
        for w, mv in enumerate(moves):
            s = pkg.window_state(trace, w, **kw)
            rec = Rec(mv, cost=50.0 + w)
            closer = Closer(reg)
            plane.observe_round(w + 1, rec, s, g, closer, arrays=host(s), fresh=w != 2,
                                top_k=0)
            closer.flush()
            steps.append((dict(plane.twin), set(plane._owned), rec.shadow))
        planes[name] = (steps, plane.wins, plane.scored)
    (t_steps, t_wins, t_scored), (j_steps, j_wins, j_scored) = planes["torch"], planes["jax"]
    assert (t_wins, t_scored) == (j_wins, j_scored)
    for (tt_, to, tb), (jt_, jo, jb) in zip(t_steps, j_steps):
        assert tt_ == jt_ and to == jo
        assert_shadow_block_equal(tb, jb)


def test_pod_free_windows_are_not_scored():
    """A machine-events-only window (both placements cost 0 by vacuity) must
    not count a free shadow win."""
    recs = [
        {"kind": "node", "t": 0.0, "node": "n1", "cpu_cap_m": 8000.0, "mem_cap_b": 8e9},
        {"kind": "pod", "t": 0.0, "pod": "s0-0", "service": "s0", "node": "n1",
         "cpu_m": 200.0, "mem_b": 1e8},
        # the second window is machine events only: no pods restated
        {"kind": "node", "t": 60.0, "node": "n1", "alive": True},
    ]
    for pkg, shadow, Closer, Registry, kw in (
            (jtr, jshadow, JCloser, JRegistry, {}),
            (ttr, tshadow, TCloser, TRegistry, {"device": "cpu"})):
        t = pkg.corpus.ClusterTrace(records=[dict(r) for r in recs], source="gappy")
        g = t.comm_graph(**kw)
        s0, s1 = pkg.window_state(t, 0, **kw), pkg.window_state(t, 1, **kw)
        reg = Registry()
        plane = shadow.ShadowPlane(TShadow(enabled=True), registry=reg)
        plane.bind(s0, g, None)
        rec = Rec(cost=0.0)
        closer = Closer(reg)
        plane.observe_round(1, rec, s1, g, closer, arrays=None, fresh=True, top_k=0)
        closer.flush()
        assert rec.shadow is None and plane.scored == 0  # unscored: no vacuous win
        assert metric(reg, "shadow_rounds_total", outcome="win") is None


# ---------------- configuration, watchdog, report, CLI ----------------


REFUSALS = [
    ("fleet", dict(fleet=JFleet(tenants=2)), dict(fleet=TFleet(tenants=2))),
    ("chaos", dict(chaos=JChaos(profile="soak")), dict(chaos="soak")),
    ("churn|RECORDED", dict(elastic=JElastic(profile="steady")), dict(elastic="steady")),
    ("placement_unit", dict(placement_unit="pod"), dict(placement_unit="pod")),
    ("admission", dict(reconcile=JReconcile(admission=False)),
     dict(reconcile_admission=False)),
    ("scan_block", dict(), dict(scan_block=4, algorithm="communication")),
]


@pytest.mark.parametrize("match,jkw,tkw", REFUSALS, ids=[r[0].split("|")[0] for r in REFUSALS])
def test_shadow_config_validation(match, jkw, tkw):
    """What the JAX package refuses of shadow mode the port refuses, for its
    reason."""
    if match == "scan_block":
        jkw = dict(controller=__import__(
            "kubernetes_rescheduling_tpu.config", fromlist=["ControllerConfig"]
        ).ControllerConfig(scan_block=4), algorithm="communication")
    with pytest.raises(ValueError, match=match):
        j_cfg(**jkw).validate()
    with pytest.raises(ValueError, match=match):
        t_cfg(**tkw).validate()


def test_shadow_win_margin_and_slo_validation():
    for Shadow in (JShadow, TShadow):
        with pytest.raises(ValueError, match="win_margin"):
            Shadow(win_margin=1.5).validate()
        Shadow(win_margin=0.0).validate()
    with pytest.raises(ValueError, match="slo_shadow_min_win_rate"):
        TConfig(slo_shadow_min_win_rate=1.5).validate()
    assert TConfig().slo_shadow_min_win_rate == JConfig().obs.slo_shadow_min_win_rate
    assert (TShadow().enabled, TShadow().win_margin) == (JShadow().enabled,
                                                         JShadow().win_margin)


def test_watchdog_shadow_rule():
    """The ``shadow_win_rate`` rule judges the latest scored round's running
    win rate after ``min_samples`` scored rounds, and clears on recovery —
    the same verdicts in both packages, fed by a record's ``shadow`` field
    (``RoundRecord.shadow``)."""
    from kubernetes_rescheduling_tpu_torch.bench.controller import RoundRecord

    verdicts = {}
    for name, wd_mod, Registry in (("jax", jwatchdog, JRegistry),
                                   ("torch", twatchdog, TRegistry)):
        wd = wd_mod.Watchdog(wd_mod.SLORules(shadow_min_win_rate=0.5, min_samples=2),
                             registry=Registry())
        seen = []
        for i, blk in enumerate(({"scored": 1, "win_rate": 0.0, "cost_delta": -1.0},
                                 {"scored": 2, "win_rate": 0.0, "cost_delta": -1.0},
                                 {"scored": 3, "win_rate": 1.0, "cost_delta": 2.0})):
            rec = RoundRecord(round=i + 1, moved=False, most_hazard=None, service=None,
                              target=None, communication_cost=1.0, load_std=0.0, shadow=blk)
            raised = wd.observe_round(rec)
            seen.append((sorted(v["rule"] for v in raised), sorted(wd.active)))
        verdicts[name] = seen
    assert verdicts["torch"] == verdicts["jax"]
    rule = twatchdog.RULE_SHADOW
    assert rule not in verdicts["torch"][0][0]
    assert rule in verdicts["torch"][1][0]
    assert rule not in verdicts["torch"][2][1]  # recovered
    assert "shadow" in RoundRecord(round=1, moved=False, most_hazard=None, service=None,
                                   target=None, communication_cost=0.0,
                                   load_std=0.0).as_dict()


def test_ops_plane_reads_the_shadow_slo():
    from kubernetes_rescheduling_tpu_torch.telemetry.server import OpsPlane

    plane = OpsPlane.from_config(TConfig(slo_shadow_min_win_rate=0.75), registry=TRegistry(),
                                 bundle_dir=None)
    assert plane.watchdog.rules.shadow_min_win_rate == 0.75


def test_report_shadow_renders_bundles_and_empty_files(tmp_path):
    blocks = [{"round": 1, "recommended": 2, "cost_actual": 10.0, "cost_shadow": 8.0,
               "cost_delta": 2.0, "win": True, "wins": 1, "scored": 1, "win_rate": 1.0,
               "edges_delta": [{"src_service": "a", "dst_service": "b", "delta": 2.0}]},
              {"round": 2, "recommended": 0, "cost_actual": 10.0, "cost_shadow": 11.0,
               "cost_delta": -1.0, "win": False, "wins": 1, "scored": 2, "win_rate": 0.5}]
    bundle = tmp_path / "bundle.json"
    bundle.write_text(json.dumps({"kind": "flight_recorder_bundle", "rounds": [
        {"record": {"shadow": b}} for b in blocks]}))
    plain = tmp_path / "rounds.jsonl"
    plain.write_text("".join(json.dumps({"round": 1}) + "\n" for _ in range(2)))
    from kubernetes_rescheduling_tpu.telemetry.report import report_shadow as j_report

    paths = [str(bundle), str(plain), str(tmp_path / "missing.jsonl")]
    assert report_shadow(paths) == j_report(paths)
    out = report_shadow(paths)
    assert "loss" in out and "a~b +2" in out and "no shadow records" in out
    assert "not a file" in out


@pytest.mark.parametrize("trace,algorithm", [
    ("alibaba", "communication"),
    ("mini.trace.jsonl", "communication"),
    ("borg", "kubescheduling"),
])
def test_cli_reschedule_shadow_matches_jax(tmp_path, capsys, trace, algorithm):
    """``reschedule --shadow`` on both packages' commands: the same rounds,
    recommendations and summary block (greedy rounds: no key stream to
    feed)."""
    path = FIXTURES / trace
    if trace == "borg":
        path = tmp_path / "borg"
        path.mkdir()
        for f in ("borg_machine_events.csv", "borg_task_usage.csv"):
            (path / f.removeprefix("borg_")).write_text((FIXTURES / f).read_text())
    elif trace == "alibaba":
        path = FIXTURES
    argv = ["reschedule", "--shadow", str(path), "--algorithm", algorithm, "--rounds", "3"]
    assert j_cli(argv) == 0
    j = json.loads(capsys.readouterr().out)
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    t = json.loads(capsys.readouterr().out)
    assert t["shadow"] == j["shadow"]
    assert t["shadow"]["scored_rounds"] == 3 and t["shadow"]["trace"] == str(path)
    for tr, jr in zip(t["rounds"], j["rounds"]):
        for k in DECISIONS:
            assert tr[k] == jr[k], k
        assert_shadow_block_equal(tr["shadow"], jr["shadow"])


@pytest.mark.parametrize("argv,match", [
    (["--fleet", "2"], "--shadow is incompatible with --fleet"),
    (["--backend", "k8s"], "--shadow is incompatible with --backend k8s"),
    (["--churn-profile", "steady"], "--shadow is incompatible with --churn-profile"),
    (["--chaos-profile", "soak"], "--shadow is incompatible with --chaos-profile"),
    (["--imbalance"], "--shadow is incompatible with --imbalance"),
    (["--placement-unit", "pod"], "--shadow is incompatible with --placement-unit pod"),
    (["--no-admission"], "--shadow is incompatible with --no-admission"),
    (["--serve", "0", "--place"], "--place is incompatible with --shadow"),
], ids=["fleet", "k8s", "churn", "chaos", "imbalance", "pod", "no-admission", "place"])
def test_cli_shadow_clean_exits(argv, match):
    """The JAX command's clean exits, before any trace parsing."""
    base = ["reschedule", "--shadow", str(FIXTURES / "missing")]
    for main in (j_cli, t_cli.main):
        with pytest.raises(SystemExit, match=match):
            main(base + argv)


def test_alibaba_fixture_served_parity():
    """Serve admitted snapshots from the Alibaba fixture: every served
    decision equals the batch decide kernel on the same admitted state, and
    the JAX engine's."""
    jreg = JRegistry()
    jengine = JEngine(JReplay(alibaba(jtr)), config=JServingConfig(max_batch=4), registry=jreg)
    tengine = TEngine(TReplay(alibaba(ttr), device="cpu"), config=TServingConfig(max_batch=4),
                      registry=TRegistry(), device="cpu")
    services = list(tengine.graph.names)[:4]
    with jengine:
        j_results = [jengine.place(s) for s in services]
    with tengine:
        t_results = [tengine.place(s) for s in services]
    svcs = torch.as_tensor([tengine._svc_index[s] for s in services])
    _, targets, _ = t_place_batch(tengine.state, tengine.graph, POLICY_IDS[tengine.policy],
                                  30.0, svcs, None)
    for r, tgt, jr in zip(t_results, targets.tolist(), j_results):
        assert r.node_index == int(tgt)
        assert r.outcome in ("placed", "no_candidate")
        assert (r.node_index, r.node, r.outcome) == (jr.node_index, jr.node, jr.outcome)


def test_pod_round_moves_one_replica_at_a_time_without_a_wave():
    """A backend without ``apply_pod_moves`` gets the pod round's moves one
    retried ``apply_move`` each, with the same records as the wave."""
    from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend

    class NoWave:
        def __init__(self, inner):
            self.inner = inner
            self.calls = 0

        def apply_move(self, move):
            assert move.pod is not None
            self.calls += 1
            return self.inner.apply_pod_moves([move]).get(move.pod)

        def __getattr__(self, name):
            if name == "apply_pod_moves":
                raise AttributeError(name)
            return getattr(self.inner, name)

    cfg = TConfig(algorithm="global", placement_unit="pod", max_rounds=2,
                  sleep_after_action_s=0.0, seed=2)
    a = t_run(make_backend("mubench", 2, device="cpu"), cfg, device="cpu", registry=TRegistry())
    wrapped = NoWave(make_backend("mubench", 2, device="cpu"))
    b = t_run(wrapped, cfg, device="cpu", registry=TRegistry())
    assert wrapped.calls == sum(len(r.applied_moves) for r in b.rounds) > 0
    for ra, rb in zip(a.rounds, b.rounds):
        for k in DECISIONS:
            assert getattr(ra, k) == getattr(rb, k), k
        assert ra.communication_cost == rb.communication_cost


def test_solver_config_of_the_shadow_run_is_the_default():
    """The acceptance run solves with the default solver config (9 sweeps),
    the shapes its launch counts on the card assume."""
    assert t_cfg().global_solver_iters == GlobalSolverConfig().sweeps == 9
