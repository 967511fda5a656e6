"""The scanned schedule (``bench/scan.py`` and ``_scanned_loop``) against the
JAX package's and against the port's sequential loop, after
tests/test_scan.py:284-530 (without the chaos-drain soak, which waits for
``backends/chaos.py``, ROADMAP Queue 1 item 4, and without the fleet).

- ``scan_rounds``: the same state, graph, edge list and noise (the JAX key
  stream's rows) give the JAX bundle — decision rows, hazard masks,
  explain bundles and tripwire bits exactly, the cost exactly (integer
  pair counts), the load std within rel 1e-6 (an f32 std whose reductions
  may run in another order).
- The scanned loop: records equal to the sequential loop's apart from
  timing fields, and decisions, costs, explanations and the simulator's
  event log equal to the JAX scanned loop's, for the four scan policies on
  ``mubench`` and ``powerlaw`` piled on one node; every drain reason
  counted as the JAX package counts it; one ``round_end`` transfer a block;
  one capture key a configuration.
- A scan body reads nothing back to the host (the capture harness of
  tests/test_torch_compiled.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_compiled import guarded_bodies  # noqa: F401 (fixture)
from test_torch_controller import DECISIONS, jax_greedy_gumbel
from test_torch_sim_device import sim_pair, strip, to_jax_state

from kubernetes_rescheduling_tpu.bench import scan as jscan
from kubernetes_rescheduling_tpu.bench.controller import run_controller as j_run
from kubernetes_rescheduling_tpu.bench.harness import make_backend as j_make
from kubernetes_rescheduling_tpu.config import SCAN_POLICIES as J_SCAN_POLICIES
from kubernetes_rescheduling_tpu.config import ControllerConfig, ElasticConfig
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.objectives import metrics as jmetrics
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu.telemetry import tripwire as jtw
from kubernetes_rescheduling_tpu.utils.logging import StructuredLogger as JLogger
from kubernetes_rescheduling_tpu_torch import cli as t_cli
from kubernetes_rescheduling_tpu_torch.backends import sim_device as tsd
from kubernetes_rescheduling_tpu_torch.bench import scan as tscan
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend as t_make
from kubernetes_rescheduling_tpu_torch.config import SCAN_POLICIES
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.objectives import metrics as tmetrics
from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS
from kubernetes_rescheduling_tpu_torch.solver import compiled
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry
from kubernetes_rescheduling_tpu_torch.telemetry import tripwire as ttw
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger as TLogger


def jax_rows(key, start: int, rounds: int, n: int) -> torch.Tensor:
    """The noise rows the JAX scan draws in-trace: round r's key is
    ``split(fold_in(key, r))[1]``."""
    return torch.stack([
        torch.tensor(np.asarray(jax.random.gumbel(
            jax.random.split(jax.random.fold_in(key, start + r))[1], (n,))))
        for r in range(rounds)])


@pytest.mark.parametrize("tripwire", [False, True])
@pytest.mark.parametrize("explain_k", [0, 3])
@pytest.mark.parametrize("policy", SCAN_POLICIES)
def test_scan_rounds_bundle_matches_jax(policy, explain_k, tripwire):
    """One block from the same state in both packages: the bundles agree
    (decisions, hazards, explain bundles and tripwire bits exactly, the cost
    exactly, the load std within rel 1e-6). The hazard-streak wire trips
    inside the block, so later rounds are latched identity rounds on both
    sides."""
    rounds, start, key = 5, 3, jax.random.PRNGKey(5)
    jb, tb = sim_pair(18, seed=2)
    t_state, t_graph = tsd.twin_of(tb)
    j_state, j_graph = to_jax_state(t_state), jb.comm_graph()
    n = t_state.num_nodes
    cfg = (0.0, 0.0, 3.0)
    j_flat = np.asarray(jscan.scan_rounds(
        j_state, j_graph, j_graph, jnp.asarray(POLICY_IDS[policy]), jnp.asarray(30.0), key,
        jnp.asarray(start, jnp.int32), jmetrics.comm_edge_list(j_graph),
        jnp.asarray(cfg, jnp.float32) if tripwire else None,
        rounds=rounds, pinned=True, explain_k=explain_k, attr_k=0, tripwire=tripwire))
    t_flat = tscan.scan_rounds(
        t_state, t_graph, t_graph, POLICY_IDS[policy], 30.0,
        jax_rows(key, start, rounds, n) if policy == "random" else None,
        tmetrics.comm_edge_list(t_graph), torch.tensor(cfg) if tripwire else None,
        rounds=rounds, pinned=True, explain_k=explain_k, tripwire=tripwire).numpy()
    assert t_flat.shape == j_flat.shape
    if tripwire:
        t_flat, t_trip = ttw.split_tripwire(t_flat, rounds=rounds)
        j_flat, j_trip = jtw.split_tripwire(j_flat, rounds=rounds)
        np.testing.assert_array_equal(t_trip.bits, j_trip.bits)
        assert (t_trip.trip_round, t_trip.trip_mask) == (j_trip.trip_round, j_trip.trip_mask)
    t_views = tscan.decode_block(t_flat, rounds=rounds, num_nodes=n, explain_k=explain_k)
    j_views = jscan.decode_block(j_flat, rounds=rounds, num_nodes=n, explain_k=explain_k)
    for a, b in zip(t_views, j_views):
        assert (a.most, a.victim, a.service, a.target, a.landed) == (
            b.most, b.victim, b.service, b.target, b.landed)
        np.testing.assert_array_equal(a.hazard, b.hazard)
        assert a.cost == b.cost and a.load_std == pytest.approx(b.load_std, rel=1e-6)
        if explain_k:
            np.testing.assert_array_equal(a.explain, b.explain)
    assert sum(v.moved for v in t_views) >= 1


def test_scan_body_reads_nothing_back(guarded_bodies):  # noqa: F811
    """Every host read raises while a block's body runs: the random policy
    (noise rows as an input), explanations and the tripwire included."""
    backend = sim_pair(18, seed=1)[1]
    t_run(backend, TConfig(algorithm="random", max_rounds=6, sleep_after_action_s=0.0,
                           scan_block=3, tripwire_cost_frac=0.5), device="cpu",
          registry=TRegistry(), logger=TLogger())
    assert guarded_bodies == ["scan_rounds", "scan_rounds"]


def scan_pair(backends, policy: str, rounds: int, block: int, seed: int = 0,
              logger: bool = True):
    """The port's sequential and scanned runs and the JAX scanned run of the
    same simulator (``backends()`` builds (jax, port, port) copies)."""
    jb, tb_seq, tb_scan = backends()
    n = len(tb_seq.node_names)
    kw = dict(algorithm=policy, max_rounds=rounds, sleep_after_action_s=0.0, seed=seed)
    out = {}
    for name, tb, block_k in (("seq", tb_seq, 0), ("scan", tb_scan, block)):
        log = TLogger() if logger else None
        reg = TRegistry()
        res = t_run(tb, TConfig(scan_block=block_k, **kw), device="cpu", registry=reg,
                    logger=log, gumbel_rows=jax_greedy_gumbel(seed, n))
        out[name] = (res, log, reg, tb)
    j_log = JLogger() if logger else None
    j_res = j_run(jb, JConfig(controller=ControllerConfig(scan_block=block), **kw),
                  registry=JRegistry(), logger=j_log)
    out["jax"] = (j_res, j_log, None, jb)
    return out


def events(log):
    return [{k: v for k, v in r.items() if k not in ("ts", "decision_latency_s")}
            for r in log.records if r["event"] in ("decision", "round")]


def piled(scenario: str, seed: int = 0):
    def build():
        out = []
        for make, kw in ((j_make, {}), (t_make, {"device": "cpu"}), (t_make, {"device": "cpu"})):
            b = make(scenario, seed, **kw)
            b.inject_imbalance(b.node_names[0])
            out.append(b)
        return out
    return build


@pytest.mark.parametrize("scenario,rounds,block", [("mubench", 6, 3), ("powerlaw", 4, 2)])
@pytest.mark.parametrize("policy", SCAN_POLICIES)
def test_scanned_matches_sequential_and_jax(policy, scenario, rounds, block):
    runs = scan_pair(piled(scenario), policy, rounds, block)
    (seq, seq_log, _, tb_seq), (sc, sc_log, reg, tb_sc) = runs["seq"], runs["scan"]
    j, j_log, _, jb = runs["jax"]
    assert len(sc.rounds) == len(seq.rounds) == len(j.rounds) == rounds
    for a, b in zip(seq.rounds, sc.rounds):
        assert strip(a) == strip(b)
    assert events(seq_log) == events(sc_log)
    for a, b in zip(sc.rounds, j.rounds):
        for k in DECISIONS:
            assert getattr(a, k) == getattr(b, k), (a.round, k)
        assert a.communication_cost == b.communication_cost
        assert a.load_std == pytest.approx(b.load_std, rel=1e-6)
        assert a.explanations == b.explanations and a.explanations
    assert tb_sc.events == tb_seq.events == jb.events
    assert reg.value("scan_blocks_total") == rounds // block
    assert reg.value("device_transfers_total", site="round_end") == rounds // block
    assert reg.value("device_transfers_total", site="fence") == 0
    # one admitted monitor a block, plus the startup probe
    assert reg.value("device_transfers_total", site="admission") == rounds // block + 1
    assert sc.moves >= 1


def test_scanned_explain_clamp_on_tiny_cluster():
    """A cluster with fewer nodes than ``explain_top_k``: the bundle and its
    decode both clamp to the node count."""
    def build():
        out = []
        for b in sim_pair(2, seed=0) + [sim_pair(2, seed=0)[1]]:
            out.append(b)
        return out

    runs = scan_pair(build, "communication", 4, 2)
    for a, b in zip(runs["seq"][0].rounds, runs["scan"][0].rounds):
        assert strip(a) == strip(b)
    for a, b in zip(runs["scan"][0].rounds, runs["jax"][0].rounds):
        assert a.explanations == b.explanations


def test_scanned_bare_loop_edge_metrics():
    """No logger: no explanations, the edge-list cost in both schedules, one
    transfer a block."""
    def build():
        return sim_pair(21, seed=0) + [sim_pair(21, seed=0)[1]]

    runs = scan_pair(build, "communication", 4, 2, logger=False)
    for a, b in zip(runs["seq"][0].rounds, runs["scan"][0].rounds):
        assert strip(a) == strip(b)
        assert not b.explanations and np.isfinite(b.communication_cost)
    assert runs["scan"][2].value("device_transfers_total", site="round_end") == 2


class Wrapped:
    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)


def drain_run(reason: str, tmp_path, rounds: int = 4, block: int = 2):
    """A scanned port run that drains under ``reason``, and its JAX twin
    where the JAX package can express the same run."""
    jb, tb = sim_pair(20, seed=0)
    kw = dict(algorithm="communication", max_rounds=rounds, sleep_after_action_s=0.0, seed=0)
    t_kw, j_kw, t_run_kw, j_run_kw = {}, {}, {}, {}
    if reason == "checkpoint":
        t_run_kw["checkpoint_dir"] = str(tmp_path / "t")
        j_run_kw["checkpoint_dir"] = str(tmp_path / "j")
    elif reason == "churn":
        t_kw.update(elastic="steady", elastic_seed=0)
        j_kw["elastic"] = ElasticConfig(profile="steady", seed=0)
    elif reason == "on-round":
        t_run_kw["on_round"] = j_run_kw["on_round"] = lambda rec, st: None
    elif reason == "streaming-graph":
        t_run_kw["graph"] = tb.comm_graph
        j_run_kw["graph"] = jb.comm_graph
    elif reason == "backend":
        tb.load.noise_frac = jb.load.noise_frac = 0.0
        tb, jb = Wrapped(tb), None
    treg = TRegistry()
    t = t_run(tb, TConfig(scan_block=block, **kw, **t_kw), device="cpu", registry=treg,
              **t_run_kw)
    j = jreg = None
    if jb is not None:
        jreg = JRegistry()
        j = j_run(jb, JConfig(controller=ControllerConfig(scan_block=block), **kw, **j_kw),
                  registry=jreg, **j_run_kw)
    return t, treg, j, jreg


@pytest.mark.parametrize("reason", ["checkpoint", "churn", "on-round", "streaming-graph",
                                    "backend"])
def test_drain_reasons_are_counted(reason, tmp_path):
    """A run the scan cannot honor drains every round under its reason, as
    the JAX package counts it, and completes exactly."""
    t, treg, j, jreg = drain_run(reason, tmp_path)
    assert len(t.rounds) + t.skipped_rounds == 4
    assert treg.value("scan_drains_total", reason=reason) == 4
    assert treg.value("scan_blocks_total") == 0
    if j is not None:
        fam = jreg.counter("scan_drains_total", labelnames=("reason",))
        assert fam.labels(reason=reason).value == 4
        for a, b in zip(t.rounds, j.rounds):
            for k in DECISIONS:
                assert getattr(a, k) == getattr(b, k), (a.round, k)


def test_breaker_drains_and_skips_are_counted():
    """Snapshots the admission guard rejects (every pod's reading poisoned)
    charge the boundary; the open breaker turns rounds into counted skips,
    the half-open probe rounds drain under ``breaker``, and every round is
    accounted for."""
    from kubernetes_rescheduling_tpu_torch.utils.retry import RetryPolicy

    backend = sim_pair(20, seed=0)[1]
    real = backend.monitor
    calls = {"n": 0}

    def poisoned():
        calls["n"] += 1
        snap = real()
        if calls["n"] in (2, 3):
            return snap.replace(pod_cpu=torch.full_like(snap.pod_cpu, float("nan")))
        return snap

    backend.monitor = poisoned
    reg = TRegistry()
    res = t_run(backend, TConfig(algorithm="communication", max_rounds=8,
                                 sleep_after_action_s=0.0, scan_block=2,
                                 max_consecutive_failures=1, breaker_cooldown_rounds=1,
                                 retry=RetryPolicy(max_attempts=1)),
                device="cpu", registry=reg)
    assert len(res.rounds) + res.skipped_rounds == 8
    assert res.skipped_rounds >= 1
    assert reg.value("scan_drains_total", reason="breaker") >= 1
    assert reg.value("scan_blocks_total") >= 1
    assert any(r.degraded for r in res.rounds)


def test_capture_keys_one_per_configuration(monkeypatch):
    """The keys a run hands the capture cache: one per configuration, the
    same for every block of a run; K, explanations, the tripwire and the
    policy each key their own."""
    keys = []
    real = compiled.GraphCache.run

    def record(self, fn, key, inputs, make_body, operands=()):
        keys.append(compiled.GraphCache._full_key(fn, key, inputs, operands))
        return real(self, fn, key, inputs, make_body, operands)

    monkeypatch.setattr(compiled.GraphCache, "run", record)

    def run(**kw):
        n0 = len(keys)
        cfg = dict(algorithm="communication", max_rounds=6, sleep_after_action_s=0.0,
                   scan_block=3)
        cfg.update(kw)
        logger = TLogger() if cfg.pop("explain_on", False) else None
        t_run(sim_pair(18, seed=0)[1], TConfig(**cfg), device="cpu", registry=TRegistry(),
              logger=logger)
        return keys[n0:]

    base = run()
    assert len(base) == 2 and len(set(base)) == 1
    others = [run(scan_block=2), run(scan_tripwires=False), run(algorithm="spread"),
              run(explain_on=True)]
    assert all(len(set(k)) == 1 for k in others)
    # graphs differ between runs (each run's backend), so compare the
    # static part of the key
    statics = {k[0][1] for k in [base] + others}
    assert len(statics) == 5


def test_divergent_landing_finishes_degraded():
    """A backend that lands a move elsewhere than the twin predicted: the
    round finishes degraded with a counted ``unknown_landing``, a fresh
    monitor realigns the controller, and the rest of the run goes on."""
    backend = sim_pair(18, seed=0)[1]
    real = backend.apply_move
    calls = {"n": 0}

    def swerve(move):
        calls["n"] += 1
        if calls["n"] == 2:
            move = type(move)(service=move.service, target_node=backend.node_names[-1],
                              hazard_nodes=move.hazard_nodes, mechanism=move.mechanism)
        return real(move)

    backend.apply_move = swerve
    reg = TRegistry()
    res = t_run(backend, TConfig(algorithm="communication", max_rounds=6,
                                 sleep_after_action_s=0.0, scan_block=3),
                device="cpu", registry=reg)
    assert len(res.rounds) == 6
    assert [r.round for r in res.rounds if r.degraded] == [2]
    assert res.rounds[1].target == backend.node_names[-1]
    assert reg.value("reconcile_divergences_total", kind="unknown_landing") == 1


def test_scan_config_validation():
    assert TConfig(algorithm="communication", scan_block=8).validate().scan_block == 8
    assert set(SCAN_POLICIES) == set(J_SCAN_POLICIES)
    for bad, match in (
        (dict(scan_block=-1), ">= 0"),
        (dict(scan_block=4, pipeline=True), "mutually exclusive"),
        (dict(scan_block=4, algorithm="kubescheduling"), "pinning greedy"),
        (dict(scan_block=4, algorithm="global"), "pinning greedy"),
        (dict(scan_block=4, moves_per_round=2), "moves_per_round=1"),
    ):
        with pytest.raises(ValueError, match=match):
            TConfig(**bad).validate()
    with pytest.raises(ValueError):
        ControllerConfig(scan_block=4, pipeline=True).validate()


def test_cli_scan_smoke(capsys):
    assert t_cli.main(["reschedule", "--scan-block", "2", "--rounds", "2", "--scenario",
                       "mubench", "--imbalance", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert len(out["rounds"]) == 2 and out["moves"] == 2
    with pytest.raises(SystemExit, match="pinning greedy"):
        t_cli.main(["reschedule", "--scan-block", "2", "--algorithm", "global",
                    "--device", "cpu"])
