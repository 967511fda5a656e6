"""The port's experiment matrix (``bench/harness.py``'s ``run_experiment``,
``bench/sinks.py``, ``bench/plots.py``, the ``bench`` command) against the
JAX package's, on the CPU.

- The matrix on µBench (1 repeat of 3 rounds, all six algorithms) in both
  packages, the port fed jax's key stream through ``run_experiment``'s
  ``seams``: the load phases' five draws a chunk, the ``random`` policy's
  noise rows and the global rounds' sweep plans. Before and after costs
  and load spreads are exact, as are every round's decisions, moves,
  restarts and request counts; latencies within ``LATENCY_REL``
  (tests/test_torch_loadgen.py's, for its reason). The CSVs are equal but
  for their timestamps; ``run.json``, ``summary.json``, ``phase1.json``
  and the session files have the JAX keys.
- The harness cases of tests/test_bench.py and the matrix cases of
  tests/test_plots_and_parity.py run on the port: the JAX test's own
  function re-bound to the port's names (``test_torch_slo.on_port``), the
  run on the CPU; the cases that import the JAX package inside their body
  (the kill-and-resume, the per-round estimator) are rewritten here on the
  port's names. Plots run where matplotlib imports.
"""

import csv
import functools
import json

import jax
import numpy as np
import pytest
import test_bench as jbench
import test_plots_and_parity as jplots
import torch
from test_torch_controller import _global_plans, jax_greedy_gumbel
from test_torch_loadgen import LATENCY_REL, jax_draws
from test_torch_slo import on_port, run_case

from kubernetes_rescheduling_tpu.bench import harness as jh
from kubernetes_rescheduling_tpu_torch import cli as t_cli
from kubernetes_rescheduling_tpu_torch import config as tconfig
from kubernetes_rescheduling_tpu_torch.backends.sim import SimBackend as TSim
from kubernetes_rescheduling_tpu_torch.bench import harness as th
from kubernetes_rescheduling_tpu_torch.bench import loadgen as tl
from kubernetes_rescheduling_tpu_torch.bench import plots as tplots
from kubernetes_rescheduling_tpu_torch.bench import sinks as tsinks
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.core.workmodel import mubench_workmodel_c
from kubernetes_rescheduling_tpu_torch.objectives import communication_cost

ALGOS = ("spread", "binpack", "random", "kubescheduling", "communication", "global")
DECISIONS = ("round", "moved", "most_hazard", "service", "target", "services_moved",
             "applied_moves", "degraded", "breaker_state", "boundary_failures",
             "objective_before", "objective_after", "communication_cost")


def cpu_cli(argv):
    """The port's CLI on the CPU (``--device cpu`` after a run command)."""
    argv = list(argv)
    if argv and argv[0] in ("bench", "reschedule", "solve", "trace"):
        argv += ["--device", "cpu"]
    return t_cli.main(argv)


def jax_seams(cfg):
    """``run_experiment``'s seams that feed a cell the JAX harness's key
    stream: ``split(PRNGKey(seed), 4)`` into the phase keys, ``fold_in``
    by segment and chunk, the loop's ``fold_in(PRNGKey(seed), round)``."""
    chunk = cfg.load.chunk

    def seams(algo, run_i, seed):
        backend = th.make_backend(cfg.scenario, seed, device="cpu")
        S = len(backend.workmodel.names)
        E = len(tl.build_call_plan(backend.workmodel.directed_relation(),
                                   backend.workmodel.names, cfg.load.entry_service).src)
        _, k_before, k_during, k_after = jax.random.split(jax.random.PRNGKey(seed), 4)
        out = {
            "draws_before": jax_draws(k_before, chunk, S, E),
            "draws_after": jax_draws(k_after, chunk, S, E),
            "draws_during": lambda seg: jax_draws(jax.random.fold_in(k_during, seg), chunk,
                                                  S, E),
            "gumbel_rows": jax_greedy_gumbel(seed, len(backend.node_names)),
        }
        if algo == "global":
            out["solver_plans"] = _global_plans(backend, seed, 9, cfg.solver_backend)[0]
        return out
    return seams


@pytest.fixture(scope="module")
def matrices(tmp_path_factory):
    """The µBench matrix in both packages (1 repeat, 3 rounds, six
    algorithms), the port on jax's key stream."""
    root = tmp_path_factory.mktemp("matrix")
    kw = dict(algorithms=ALGOS, repeats=1, rounds=3, scenario="mubench", seed=2,
              session_name="m")
    j = jh.run_experiment(jh.ExperimentConfig(out_dir=str(root / "jax"), **kw))
    tcfg = th.ExperimentConfig(out_dir=str(root / "port"), **kw)
    t = th.run_experiment(tcfg, device="cpu", seams=jax_seams(tcfg))
    return j, t, root / "jax" / "session_m", root / "port" / "session_m"


def close_load(t: dict, j: dict, what: str) -> None:
    assert set(t) == set(j), what
    for k in j:
        if k.startswith("latency_") or k == "duration_s":
            assert t[k] == pytest.approx(j[k], rel=LATENCY_REL), (what, k)
        else:
            assert t[k] == j[k], (what, k)


@pytest.mark.parametrize("algo", ALGOS)
def test_matrix_cell_equals_jax(matrices, algo):
    j, t, jdir, tdir = matrices
    jr = next(r for r in j["runs"] if r["algorithm"] == algo)
    tr = next(r for r in t["runs"] if r["algorithm"] == algo)
    assert set(tr) == set(jr)
    for phase in ("before", "after"):
        assert tr[phase]["communication_cost"] == jr[phase]["communication_cost"], phase
        assert tr[phase]["load_std"] == pytest.approx(jr[phase]["load_std"], rel=1e-6), phase
        assert tr[phase]["response_time_ms"] == pytest.approx(
            jr[phase]["response_time_ms"], rel=LATENCY_REL), phase
    for phase in ("before", "during", "after"):
        close_load(tr["load"][phase], jr["load"][phase], f"{algo} {phase}")
    for k in ("moves", "restart_source", "seed", "run", "skipped_rounds", "degraded_rounds",
              "boundary_failures", "breaker_transitions", "resumed_from_round",
              "sim_clock_s"):
        assert tr[k] == jr[k], k
    assert set(tr["decision_latency"]) == set(jr["decision_latency"])
    # every round's record: the decisions exactly, the load spread to rel 1e-6
    rows = [[json.loads(x) for x in (d / algo / "run_1" / "rounds.jsonl").read_text()
             .splitlines()] for d in (tdir, jdir)]
    assert len(rows[0]) == len(rows[1]) == 3
    for tt, jj in zip(*rows):
        for k in DECISIONS:
            assert tt[k] == jj[k], (algo, tt["round"], k)
        assert tt["load_std"] == pytest.approx(jj["load_std"], rel=1e-6)
    # the reference's CSVs: equal but for the timestamps
    for name in ("node_std.csv", "communication_cost.csv"):
        a, b = ([r for r in csv.reader((d / algo / "run_1" / name).open())] for d in (tdir, jdir))
        assert a[0] == b[0] and len(a) == len(b), name
        for x, y in zip(a[1:], b[1:]):
            assert float(x[1]) == pytest.approx(float(y[1]), rel=1e-6), name
    p1 = [json.loads((d / algo / "run_1" / "phase1.json").read_text()) for d in (tdir, jdir)]
    assert set(p1[0]) == set(p1[1]) and p1[0]["edge_counts"] == p1[1]["edge_counts"]


def test_matrix_summary_and_session_equal_jax(matrices):
    j, t, jdir, tdir = matrices
    assert set(t) == set(j) == {"config", "runs", "aggregate"}
    assert set(t["config"]) == set(j["config"])
    assert set(t["config"]["load"]) == set(j["config"]["load"])
    assert set(t["aggregate"]) == set(j["aggregate"])
    for algo, agg in j["aggregate"].items():
        assert set(t["aggregate"][algo]) == set(agg)
        for k in ("communication_cost", "restarts"):
            assert t["aggregate"][algo][k] == agg[k], (algo, k)
        assert t["aggregate"][algo]["load_std"] == pytest.approx(agg["load_std"], rel=1e-6)
        assert t["aggregate"][algo]["error_rate_during"] == agg["error_rate_during"]
    for name in ("summary.json", "config.json", "manifest.json", "perf_ledger.jsonl"):
        assert (tdir / name).is_file() and (jdir / name).is_file(), name
    for algo in ALGOS:
        got = sorted(p.name for p in (tdir / algo / "run_1").iterdir())
        assert got == sorted(p.name for p in (jdir / algo / "run_1").iterdir()), algo
    # one ledger entry a cell, keyed apart from the JAX package's by device
    entries = [json.loads(x) for x in (tdir / "perf_ledger.jsonl").read_text().splitlines()]
    j_entries = [json.loads(x) for x in (jdir / "perf_ledger.jsonl").read_text().splitlines()]
    assert [e["scenario"] for e in entries] == [e["scenario"] for e in j_entries]
    assert [e["seq"] for e in entries] == list(range(len(ALGOS)))
    assert {e["device_kind"] for e in entries} == {"cpu"}
    assert all(set(e) == set(je) for e, je in zip(entries, j_entries))


def test_matrix_resume_reloads_every_cell(matrices):
    """A finished named session re-run: every cell reloads from its
    run.json, the summary equal."""
    _, t, _, tdir = matrices
    cfg = th.ExperimentConfig(algorithms=ALGOS, repeats=1, rounds=3, scenario="mubench", seed=2,
                              session_name="m", out_dir=str(tdir.parent))
    again = th.run_experiment(cfg, device="cpu")
    assert json.loads(json.dumps(again, default=float)) == json.loads(
        json.dumps(t, default=float))
    assert (tdir / "manifest.resume.json").is_file()
    with pytest.raises(ValueError, match="different config"):
        th.run_experiment(th.ExperimentConfig(algorithms=ALGOS, repeats=1, rounds=4,
                                              scenario="mubench", seed=2, session_name="m",
                                              out_dir=str(tdir.parent)), device="cpu")


# ---------------- tests/test_bench.py's harness cases on the port ----------------


PORT_NAMES = {
    "ExperimentConfig": th.ExperimentConfig,
    "run_experiment": functools.partial(th.run_experiment, device="cpu"),
    "make_backend": lambda scenario, seed=0, **kw: th.make_backend(scenario, seed,
                                                                   device="cpu", **kw),
    "LoadGenConfig": tl.LoadGenConfig,
    "CsvSink": tsinks.CsvSink,
    "JsonlSink": tsinks.JsonlSink,
    "cli_main": cpu_cli,
    "RescheduleConfig": tconfig.RescheduleConfig,
    "SimBackend": lambda **kw: TSim(device="cpu", **kw),
    "run_controller": functools.partial(t_run, device="cpu"),
    "mubench_workmodel_c": mubench_workmodel_c,
    "communication_cost": communication_cost,
}
BENCH_CASES = ("test_harness_matrix", "test_harness_reports_request_stats", "test_sinks",
               "test_cli_bench", "test_harness_observe_weights", "test_config_from_toml")


@pytest.mark.parametrize("case", BENCH_CASES)
def test_bench_case_on_port(case, tmp_path, capsys):
    run_case(on_port(jbench, PORT_NAMES), case, {"tmp_path": tmp_path, "capsys": capsys})


def test_harness_kill_and_resume(tmp_path, monkeypatch):
    """tests/test_bench.py's case on the port: crash the matrix in the
    second cell, re-run the same session — the finished cell reloads, the
    crashed one resumes from its latest checkpoint, and the final
    placements equal the uninterrupted run's."""
    base = dict(algorithms=("spread", "communication"), repeats=1, rounds=4,
                scenario="mubench", seed=11,
                load=tl.LoadGenConfig(requests_per_phase=256, chunk=256))
    clean = th.run_experiment(th.ExperimentConfig(out_dir=str(tmp_path / "clean"), **base),
                              device="cpu")
    calls = {"n": 0}
    real_apply = TSim.apply_move

    def crashing_apply(self, move):
        calls["n"] += 1
        if calls["n"] == 7:  # past cell 1 (<= 4 moves) and into cell 2
            raise RuntimeError("simulated crash")
        return real_apply(self, move)

    monkeypatch.setattr(TSim, "apply_move", crashing_apply)
    cfg = th.ExperimentConfig(out_dir=str(tmp_path / "resumable"), session_name="killtest",
                              **base)
    with pytest.raises(RuntimeError, match="simulated crash"):
        th.run_experiment(cfg, device="cpu")
    monkeypatch.setattr(TSim, "apply_move", real_apply)
    resumed = th.run_experiment(cfg, device="cpu")
    assert len(resumed["runs"]) == 2
    assert any(r["resumed_from_round"] > 1 for r in resumed["runs"])
    logs = (tmp_path / "resumable" / "session_killtest" / "communication" / "run_1"
            / "log.jsonl").read_text()
    events = [json.loads(x)["event"] for x in logs.splitlines()]
    assert "resume" in events and "round" in events
    for got, exp in zip(resumed["runs"], clean["runs"]):
        assert got["algorithm"] == exp["algorithm"]
        assert got["after"]["communication_cost"] == exp["after"]["communication_cost"]
        assert got["after"]["load_std"] == exp["after"]["load_std"]
        if got["resumed_from_round"] == 0:
            assert got["moves"] == exp["moves"]


def test_observe_weights_streams_per_round(monkeypatch, tmp_path):
    """tests/test_bench.py's case on the port: the decision graph is
    re-estimated every round from the accumulated traffic."""
    calls = {"n": 0}
    real = tl.LoadGenerator.observed_graph

    def counting(self, counts, sent, base, **kw):
        calls["n"] += 1
        return real(self, counts, sent, base, **kw)

    monkeypatch.setattr(tl.LoadGenerator, "observed_graph", counting)
    summary = th.run_experiment(th.ExperimentConfig(
        algorithms=("global",), repeats=1, rounds=3, scenario="mubench",
        out_dir=str(tmp_path), observe_weights=True, seed=5), device="cpu")
    assert len(summary["runs"]) == 1
    assert calls["n"] >= 3


def test_experiment_config_rejects_invalid_combo_early():
    """tests/test_bench.py's case: invalid combinations fail at
    construction. Restarts and tp above 1 run across devices, which the
    port refuses naming ROADMAP Queue 1 item 5 (the JAX package accepts
    them)."""
    th.ExperimentConfig(solver_backend="sparse")
    for kw in (dict(solver_restarts=4, solver_tp=2), dict(solver_restarts=4),
               dict(solver_tp=2)):
        with pytest.raises(ValueError, match="Queue 1 item 5"):
            th.ExperimentConfig(solver_backend="sparse", **kw)
    with pytest.raises(ValueError, match="placement_unit"):
        th.ExperimentConfig(placement_unit="bogus")
    with pytest.raises(ValueError, match="churn_profile requires the sim backend"):
        th.ExperimentConfig(churn_profile="steady", backend="k8s")
    with pytest.raises(ValueError, match="observe_weights"):
        th.ExperimentConfig(churn_profile="steady", observe_weights=True)
    with pytest.raises(ValueError, match="placement_unit='pod' requires the sim backend"):
        th.ExperimentConfig(placement_unit="pod", backend="k8s", algorithms=("global",))
    with pytest.raises(ValueError, match="baseline"):
        th.ExperimentConfig(perf_baseline="mean")


def test_cell_config_carries_every_plane():
    """The r2 loop's config gets every field the JAX harness gives its
    ``RescheduleConfig``: chaos and churn seeded by run, the forecast, the
    schedules (the scan only for the algorithms it expresses) and the
    reconcile block flat."""
    cfg = th.ExperimentConfig(chaos_profile="soak", chaos_seed=3, churn_profile="steady",
                              churn_seed=5, scan_block=4, max_consecutive_failures=2,
                              reconcile=tconfig.ReconcileConfig(enabled=False,
                                                                repair_budget_per_round=0),
                              forecast=tconfig.ForecastConfig(min_history=6))
    greedy = th._cell_config(cfg, "communication", 2, 2002)
    glob = th._cell_config(cfg, "global", 2, 2002)
    assert (greedy.chaos, greedy.chaos_seed, greedy.elastic, greedy.elastic_seed) == (
        "soak", 5, "steady", 7)
    assert greedy.scan_block == 4 and glob.scan_block == 0
    assert greedy.reconcile_enabled is False and greedy.repair_budget_per_round == 0
    assert greedy.max_consecutive_failures == 2 and greedy.forecast.min_history == 6
    assert greedy.sleep_after_action_s == cfg.pacing_s and greedy.seed == 2002
    assert glob.balance_weight == 0.5


def test_mubench_reference_placements_equal_jax():
    """The three reference placements; the global one fed jax's plans."""
    from test_torch_global_solver import jax_plan

    from kubernetes_rescheduling_tpu.solver import global_solver as jgs

    j = jh.mubench_reference_placements()
    plan = jax_plan(jax.random.PRNGKey(0), jgs.GlobalSolverConfig(sweeps=9), 20, 3,
                    inline=False)
    t = th.mubench_reference_placements("cpu", plan=plan)
    for k in ("pileup", "global", "random"):
        assert np.array_equal(t[k].pod_node.numpy(), np.asarray(j[k].pod_node)), k
        assert np.allclose(t[k].node_cpu_pct().numpy(), np.asarray(j[k].node_cpu_pct()),
                           rtol=1e-6), k


def test_make_experiment_backend_k8s_takes_injected_clients():
    """``backend="k8s"`` builds the live adapter on the workmodel, the
    client objects passed through (the JAX tests inject fakes)."""
    from kubernetes_rescheduling_tpu_torch.backends.k8s import K8sBackend

    sentinel = object()
    cfg = th.ExperimentConfig(backend="k8s", namespace="ns1")
    b = th.make_experiment_backend(cfg, 1, device="cpu", core_api=sentinel, apps_api=sentinel,
                                   custom_api=sentinel)
    assert isinstance(b, K8sBackend) and b.namespace == "ns1"
    assert b.workmodel.names == mubench_workmodel_c().names
    sim = th.make_experiment_backend(th.ExperimentConfig(), 1, device="cpu")
    assert isinstance(sim, TSim)


def test_run_experiment_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py's experiment_large runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.run_experiment(th.ExperimentConfig(out_dir=str(tmp_path), repeats=1, rounds=1))
    assert not list(tmp_path.iterdir())


def test_sinks_write_the_reference_schemas(tmp_path):
    s = tsinks.node_std_sink(tmp_path)
    c = tsinks.communication_cost_sink(tmp_path)
    s.append(1.25)
    c.append(3.0)
    assert list(csv.reader((tmp_path / "node_std.csv").open()))[0] == ["timestamp", "cpu_std"]
    rows = list(csv.reader((tmp_path / "communication_cost.csv").open()))
    assert rows[0] == ["timestamp", "cost"] and rows[1][1] == "3.0"


# ---------------- tests/test_plots_and_parity.py on the port ----------------


@pytest.fixture(scope="module")
def matrix_summary(tmp_path_factory):
    """tests/test_plots_and_parity.py's matrix on the port (five greedy
    policies, 3 repeats of 10 rounds, seed 11)."""
    return th.run_experiment(th.ExperimentConfig(
        algorithms=("spread", "binpack", "random", "kubescheduling", "communication"),
        repeats=3, rounds=10, scenario="mubench", seed=11,
        out_dir=str(tmp_path_factory.mktemp("plots"))), device="cpu")


PLOT_CASES = ("test_plot_summary_writes_charts", "test_car_wins_comm_cost_and_response_time",
              "test_rescheduling_improves_over_before")


@pytest.mark.parametrize("case", PLOT_CASES)
def test_plots_and_parity_case_on_port(case, matrix_summary, tmp_path):
    if "plot" in case:
        pytest.importorskip("matplotlib")
    run_case(on_port(jplots, {"plot_summary": tplots.plot_summary}), case,
             {"matrix_summary": matrix_summary, "tmp_path": tmp_path})


def test_merge_summaries_labels_config_variants(matrix_summary, tmp_path):
    """tests/test_plots_and_parity.py's case on the port's plots."""
    capped = {"runs": [{**r, "seed": r["seed"] + 1000} for r in matrix_summary["runs"]
                       if r["algorithm"] == "communication"]}
    merged = tplots.merge_summaries(matrix_summary, [("k=2", capped)])
    assert "communication k=2" in {r["algorithm"] for r in merged["runs"]}
    assert "aggregate" not in merged
    pytest.importorskip("matplotlib")
    written = tplots.plot_summary(merged, tmp_path / "merged")
    assert any(p.name == "disruption.png" for p in written)
    assert all(p.is_file() for p in written)


def test_plot_frontier_scale_and_gap_charts(tmp_path):
    pytest.importorskip("matplotlib")
    rows = [{"config": "cap2", "restarts": 10, "communication_cost": 9.0,
             "error_rate_during": 0.1, "response_time_ms": 80.0},
            {"config": "mc0.5", "restarts": 4, "communication_cost": 11.0,
             "error_rate_during": 0.02, "response_time_ms": 90.0}]
    assert tplots.plot_disruption_frontier(rows, tmp_path).is_file()
    points = [{"scale": "large", "services": 10_000, "solver": "dense", "ms": 48.0},
              {"scale": "sparse50k", "services": 50_000, "solver": "sparse", "ms": 129.0},
              {"scale": "sparse50k", "services": 50_000, "solver": "dense", "ms": None}]
    assert tplots.plot_scale_curve(points, tmp_path).is_file()
    gap = [{"instance": "40x5", "configs": {"a": 3.0, "b": -1.0}},
           {"instance": "80x8", "configs": {"a": 6.5, "b": 2.0}}]
    assert tplots.plot_optimality_gap(gap, tmp_path).is_file()


# ---------------- tests/test_backends.py's test_harness_k8s_* on both packages ----------------


def _k8s_fakes(kind: str):
    """The JAX tests' fake clusters: ``imbalanced`` (worker1 hot), ``crashy``
    (a container crash on every Deployment delete) or ``plain``."""
    from test_backends import FakeCluster

    from kubernetes_rescheduling_tpu.core.workmodel import mubench_workmodel_c as j_wm

    class Imbalanced(FakeCluster):
        def list_cluster_custom_object(self, group, version, plural):
            usage = {"master": "1000m", "worker1": "4000m", "worker2": "1000m"}
            return {"items": [{"metadata": {"name": n},
                               "usage": {"cpu": usage[n], "memory": "4Gi"}}
                              for n in self.nodes]}

    class Crashy(Imbalanced):
        def __init__(self, wm):
            super().__init__(wm)
            self.pods["crashy-pod"] = {"deployment": "untracked", "node": "worker2",
                                       "restarts": 0}

        def delete_namespaced_deployment(self, name, namespace, body=None):
            super().delete_namespaced_deployment(name, namespace, body=body)
            self.pods["crashy-pod"]["restarts"] += 1

    cls = {"imbalanced": Imbalanced, "crashy": Crashy, "plain": FakeCluster}[kind]
    return cls(j_wm()), cls(j_wm())


@pytest.mark.parametrize("kind,rounds,imbalance,seed", [
    ("imbalanced", 2, False, 2),   # test_harness_k8s_mode_runs_matrix
    ("crashy", 2, False, 2),       # test_harness_k8s_measures_crash_restart_delta
    ("plain", 1, True, 3),         # test_harness_k8s_inject_imbalance
])
def test_harness_k8s_cases_equal_jax(kind, rounds, imbalance, seed, tmp_path):
    """tests/test_backends.py's three ``test_harness_k8s_*`` cases: ``bench
    --backend k8s`` drives the live-cluster adapter over the JAX tests'
    fakes. Their assertions hold on the port, and the two packages' runs
    move, restart and crash alike."""
    jf, tf = _k8s_fakes(kind)
    kw = dict(algorithms=("communication",), repeats=1, rounds=rounds, backend="k8s",
              inject_imbalance=imbalance, seed=seed)
    apis = dict(sleeper=lambda s: None)
    j = jh.run_experiment(jh.ExperimentConfig(
        out_dir=str(tmp_path / "jax"), load=jh.LoadGenConfig(requests_per_phase=256, chunk=256),
        **kw), core_api=jf, apps_api=jf, custom_api=jf, **apis)["runs"][0]
    t = th.run_experiment(th.ExperimentConfig(
        out_dir=str(tmp_path / "port"), load=tl.LoadGenConfig(requests_per_phase=256, chunk=256),
        **kw), device="cpu", core_api=tf, apps_api=tf, custom_api=tf, **apis)["runs"][0]
    if kind == "plain":
        assert t["before"]["load_std"] > 0 and t["load"]["before"]["sent"] > 0
    else:
        assert t["moves"] >= 1
        assert t["restart_source"] == "derived_from_moves"
        assert t["load"]["during"]["restarts"] >= t["moves"]
        assert t["sim_clock_s"] is None and t["load"]["after"]["sent"] > 0
        assert t["load"]["during"]["container_crashes"] == (tf.deleted_gen if kind == "crashy"
                                                            else 0)
    for k in ("moves", "restart_source", "sim_clock_s"):
        assert t[k] == j[k], k
    for k in ("restarts", "container_crashes", "sent"):
        assert t["load"]["during"][k] == j["load"]["during"][k], k
    assert t["before"]["communication_cost"] == j["before"]["communication_cost"]
    assert t["after"]["communication_cost"] == j["after"]["communication_cost"]
    assert t["before"]["load_std"] == pytest.approx(j["before"]["load_std"], rel=1e-6)
    assert tf.deleted_gen == jf.deleted_gen
