"""The pipelined schedule (``_pipelined_loop``) against the port's sequential
loop and the JAX package's pipelined loop, after tests/test_pipeline.py.

The pipelined loop issues the sequential backend call order, so its
records equal the sequential loop's apart from timing fields — greedy,
dense and sparse global and pod rounds, with and without churn (churned
rounds drain to the sequential path) — and decisions, costs and the
simulator's event log equal the JAX pipelined loop's. The JAX package's
buffer-donation cases (tests/test_pipeline.py:147, :281-398) map to the
capture cache: a pipelined global run keys one capture per solve shape.
"""

import json
import threading

import pytest
from test_torch_controller import DECISIONS, _global_plans, jax_greedy_gumbel
from test_torch_sim_device import sim_pair, strip

from kubernetes_rescheduling_tpu.bench.controller import run_controller as j_run
from kubernetes_rescheduling_tpu.bench.harness import make_backend as j_make
from kubernetes_rescheduling_tpu.config import ControllerConfig
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu_torch import cli as t_cli
from kubernetes_rescheduling_tpu_torch.bench.controller import _WALL_MS_BUCKETS
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend as t_make
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.solver import compiled
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger as TLogger
from kubernetes_rescheduling_tpu_torch.utils.retry import RetryPolicy

ROUNDS = {"communication": 6, "global": 3, "sparse": 3, "pod": 3}


def kw_of(kind: str) -> dict:
    return {"communication": {}, "global": {},
            "sparse": {"solver_backend": "sparse"},
            "pod": {"placement_unit": "pod"}}[kind]


def scenario_of(kind: str) -> str:
    # powerlaw has 8 sparse blocks; the pod round runs on its own graph
    return {"communication": "mubench", "global": "mubench", "sparse": "powerlaw",
            "pod": "mubench"}[kind]


def seam(kind: str, backend, seed: int) -> dict:
    if kind == "communication":
        return {"gumbel_rows": jax_greedy_gumbel(seed, len(backend.node_names))}
    if kind == "global":
        return {"solver_plans": _global_plans(backend, seed, 9, "dense")[0]}
    if kind == "sparse":
        return {"solver_plans": _global_plans(backend, seed, 9, "sparse")[0]}
    return {}


def t_pair_run(kind: str, pipeline: bool, churn: str = "none", seed: int = 1, logger=True,
               backend=None, **cfg):
    b = backend
    if b is None:
        b = t_make(scenario_of(kind), seed, device="cpu")
        b.inject_imbalance(b.node_names[0])
    log = TLogger() if logger else None
    reg = TRegistry()
    algo = "communication" if kind == "communication" else "global"
    res = t_run(b, TConfig(algorithm=algo, max_rounds=ROUNDS[kind], sleep_after_action_s=0.0,
                           seed=seed, pipeline=pipeline, elastic=churn, elastic_seed=0,
                           **kw_of(kind), **cfg),
                device="cpu", registry=reg, logger=log,
                **(seam(kind, b, seed) if churn == "none" else {}))
    return res, log, reg, b


def events(log):
    return [{k: v for k, v in r.items() if k not in ("ts", "decision_latency_s")}
            for r in log.records if r["event"] in ("decision", "round")]


@pytest.mark.parametrize("churn", ["none", "diurnal-autoscale"])
@pytest.mark.parametrize("kind", ["communication", "global", "sparse", "pod"])
def test_pipelined_matches_sequential(kind, churn):
    """The same records (timing fields aside), events and simulator log, on
    every round kind, static and churned (churned rounds drain)."""
    seq, seq_log, seq_reg, sb = t_pair_run(kind, False, churn)
    pl, pl_log, pl_reg, pb = t_pair_run(kind, True, churn)
    assert len(seq.rounds) == len(pl.rounds) == ROUNDS[kind]
    for a, b in zip(seq.rounds, pl.rounds):
        assert strip(a) == strip(b)
    assert events(seq_log) == events(pl_log)
    assert sb.events == pb.events
    piped = [r for r in pl.rounds if r.pipeline is not None]
    assert len(piped) == (ROUNDS[kind] if churn == "none" else 0)
    # one round_end transfer per executed round in both schedules
    for reg in (seq_reg, pl_reg):
        assert reg.value("device_transfers_total", site="round_end") == ROUNDS[kind]


@pytest.mark.parametrize("kind", ["communication", "global"])
def test_pipelined_matches_jax_pipelined(kind):
    seed = 1
    res, _, _, tb = t_pair_run(kind, True, seed=seed, logger=False)
    jb = j_make(scenario_of(kind), seed)
    jb.inject_imbalance(jb.node_names[0])
    algo = "communication" if kind == "communication" else "global"
    j = j_run(jb, JConfig(algorithm=algo, max_rounds=ROUNDS[kind], sleep_after_action_s=0.0,
                          seed=seed, controller=ControllerConfig(pipeline=True)),
              registry=JRegistry())
    for a, b in zip(res.rounds, j.rounds):
        for k in DECISIONS:
            assert getattr(a, k) == getattr(b, k), (a.round, k)
        assert a.communication_cost == b.communication_cost
        assert a.load_std == pytest.approx(b.load_std, rel=1e-6)
        assert (a.pipeline is None) == (b.pipeline is None)
    assert tb.events == jb.events


@pytest.mark.parametrize("algorithm", ["communication", "proactive"])
def test_pipelined_on_round_clock_matches_jax(algorithm):
    """A pipelined greedy round runs its pre-fence hook between the first
    decide and its fence, so the previous round closes (``on_round``
    included) before this round's move: the simulator's clock at each
    ``on_round`` reads 18 / 36 / 54 / 72 s (15 s pacing, 3 s reconcile), as
    in the JAX pipelined loop and the port's sequential loop."""
    clocks = {}
    for name, make, run, cfg in (
        ("jax", j_make, j_run, JConfig(algorithm=algorithm, max_rounds=4,
                                       sleep_after_action_s=15.0,
                                       controller=ControllerConfig(pipeline=True))),
        ("pipelined", t_make, t_run, TConfig(algorithm=algorithm, max_rounds=4,
                                             sleep_after_action_s=15.0, pipeline=True)),
        ("sequential", t_make, t_run, TConfig(algorithm=algorithm, max_rounds=4,
                                              sleep_after_action_s=15.0)),
    ):
        b = make("mubench", 3) if name == "jax" else make("mubench", 3, device="cpu")
        b.inject_imbalance(b.node_names[0])
        seen = clocks[name] = []
        run(b, cfg, on_round=lambda rec, st, b=b, seen=seen: seen.append(b.clock_s),
            **({} if name == "jax" else {"device": "cpu"}))
    assert clocks["pipelined"] == clocks["jax"] == clocks["sequential"] == [18.0, 36.0,
                                                                             54.0, 72.0]


class Flaky:
    """A backend failing the listed monitor and apply calls (1-based, per
    call kind) — the same faults in the same call order for both schedules."""

    def __init__(self, inner, fail_monitor=(), fail_apply=()):
        self.inner = inner
        self.calls = {"monitor": 0, "apply_move": 0}
        self.fail = {"monitor": set(fail_monitor), "apply_move": set(fail_apply)}
        self.threads = set()

    def monitor(self):
        self.calls["monitor"] += 1
        self.threads.add(threading.current_thread().name)
        if self.calls["monitor"] in self.fail["monitor"]:
            raise ConnectionError("injected: monitor down")
        return self.inner.monitor()

    def apply_move(self, move):
        self.calls["apply_move"] += 1
        if self.calls["apply_move"] in self.fail["apply_move"]:
            raise ConnectionError("injected: apply down")
        return self.inner.apply_move(move)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_breaker_drains_the_pipeline_with_no_round_lost():
    """Faults open the breaker mid-run: the pipelined loop drains into the
    sequential path, counts every skip (``max_rounds == records +
    skipped``) and stays equal to the sequential run — records, skips and
    breaker transitions."""
    runs = []
    for pipeline in (False, True):
        b = Flaky(sim_pair(11, seed=0)[1], fail_monitor=range(4, 9), fail_apply=range(3, 7))
        reg = TRegistry()
        res = t_run(b, TConfig(algorithm="communication", max_rounds=14,
                               sleep_after_action_s=0.0, pipeline=pipeline,
                               max_consecutive_failures=2, retry=RetryPolicy(max_attempts=1)),
                    device="cpu", registry=reg)
        runs.append((res, reg, b))
    (seq, _, _), (pl, reg, b) = runs
    assert len(pl.rounds) + pl.skipped_rounds == 14
    assert pl.skipped_rounds == seq.skipped_rounds > 0
    assert pl.breaker_transitions == seq.breaker_transitions
    assert "open" in {t["to"] for t in pl.breaker_transitions}
    for a, c in zip(seq.rounds, pl.rounds):
        assert strip(a) == strip(c)
    assert any(r.pipeline is None for r in pl.rounds)   # drained rounds
    assert any(r.pipeline is not None for r in pl.rounds)
    # the post-move monitors of pipelined rounds ran off the main thread
    assert any(name.startswith("krt-boundary") for name in b.threads)


@pytest.mark.parametrize("pipeline", [False, True])
def test_degraded_round_reuses_the_cached_metrics(pipeline):
    """A failed post-move monitor: the round closes degraded on the carried
    snapshot's values (the previous round's), with its one transfer."""
    b = Flaky(sim_pair(14, seed=0)[1], fail_monitor=(3,))   # round 2's post-move
    reg = TRegistry()
    res = t_run(b, TConfig(algorithm="communication", max_rounds=4, sleep_after_action_s=0.0,
                           pipeline=pipeline, retry=RetryPolicy(max_attempts=1)),
                device="cpu", registry=reg, logger=TLogger())
    assert len(res.rounds) == 4
    degraded = [r for r in res.rounds if r.degraded]
    assert [r.round for r in degraded] == [2]
    assert degraded[0].communication_cost == res.rounds[0].communication_cost
    assert degraded[0].load_std == res.rounds[0].load_std
    assert reg.value("device_transfers_total", site="round_end") == 4


def test_pipeline_gauges_and_wall_histogram():
    res, _, reg, _ = t_pair_run("communication", True, logger=False)
    piped = [r for r in res.rounds if r.pipeline is not None]
    assert len(piped) == len(res.rounds)
    for r in piped:
        assert r.pipeline["depth"] == 2 and 0.0 <= r.pipeline["overlap_ratio"] <= 1.0
        assert r.wall_s > 0 and r.pipeline["background_s"] > 0
    assert reg.value("pipeline_depth") == 2
    assert reg.value("pipeline_overlap_ratio") == piped[-1].pipeline["overlap_ratio"]
    hist = reg.histogram("wall_round_ms", labelnames=("mode",),
                         buckets=_WALL_MS_BUCKETS).labels(mode="pipelined")
    assert hist.count == len(piped)
    seq, _, seq_reg, _ = t_pair_run("communication", False, logger=False)
    assert all(r.pipeline is None for r in seq.rounds)
    assert seq_reg.histogram("wall_round_ms", labelnames=("mode",),
                             buckets=_WALL_MS_BUCKETS).labels(mode="sequential").count == 6
    assert "pipeline_depth" not in seq_reg._metrics


def test_pipelined_global_keys_one_capture_per_shape(monkeypatch):
    """Every round of a pipelined global run hands the capture cache the
    same key (the counterpart of the JAX package's donated solve: one
    compiled program, replayed)."""
    keys = []
    real = compiled.GraphCache.run

    def record(self, fn, key, inputs, make_body, operands=()):
        keys.append((fn, compiled.GraphCache._full_key(fn, key, inputs, operands)))
        return real(self, fn, key, inputs, make_body, operands)

    monkeypatch.setattr(compiled.GraphCache, "run", record)
    res, _, _, _ = t_pair_run("global", True, logger=False)
    assert len(keys) == len(res.rounds) == 3
    assert len(set(keys)) == 1 and keys[0][0] == "global_assign"


def test_pipeline_config_validation():
    assert TConfig(pipeline=True).validate().pipeline_depth == 2
    for depth in (1, 3):
        with pytest.raises(ValueError, match="depth must be 2"):
            TConfig(pipeline=True, pipeline_depth=depth).validate()
        with pytest.raises(ValueError):
            ControllerConfig(depth=depth).validate()


def test_cli_pipeline_smoke(capsys):
    assert t_cli.main(["reschedule", "--pipeline", "--rounds", "2", "--scenario", "mubench",
                       "--imbalance", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert len(out["rounds"]) == 2
    assert all(r["pipeline"]["depth"] == 2 for r in out["rounds"])
    with pytest.raises(SystemExit, match="depth must be 2"):
        t_cli.main(["reschedule", "--pipeline", "--pipeline-depth", "3", "--device", "cpu"])


def test_watchdog_pipeline_overlap_rule():
    """tests/test_pipeline.py:435 on the port's watchdog: sequential rounds
    never feed the rule, a collapsed rolling mean enters it once, a healthy
    window recovers it."""
    from types import SimpleNamespace

    from kubernetes_rescheduling_tpu_torch.telemetry.watchdog import (
        RULE_PIPELINE,
        SLORules,
        Watchdog,
    )

    reg = TRegistry()
    wd = Watchdog(SLORules(window=4, min_samples=3, pipeline_min_overlap=0.5), registry=reg)

    def rec(ratio):
        return SimpleNamespace(decision_latency_s=0.001, communication_cost=1.0,
                               pipeline={"overlap_ratio": ratio} if ratio is not None else None)

    for _ in range(5):
        wd.observe_round(rec(None))
    assert RULE_PIPELINE not in wd.active
    for _ in range(3):
        wd.observe_round(rec(0.9))
    assert RULE_PIPELINE not in wd.active
    for _ in range(4):
        wd.observe_round(rec(0.0))
    assert RULE_PIPELINE in wd.active
    assert reg.value("slo_violations_total", rule=RULE_PIPELINE) == 1
    for _ in range(4):
        wd.observe_round(rec(0.95))
    assert RULE_PIPELINE not in wd.active


def test_pipelined_loop_feeds_the_ops_plane(tmp_path):
    """A pipelined run with the ops plane: every round observed once (the
    /healthz round count, the flight recorder's ring with a digest each),
    each record carrying its pipeline block, and the records equal to the
    sequential run with the same plane."""
    from kubernetes_rescheduling_tpu_torch.telemetry.server import OpsPlane

    def run(pipeline):
        backend = sim_pair(5, seed=0)[1]
        plane = OpsPlane.from_config(TConfig(), registry=TRegistry(),
                                     bundle_dir=str(tmp_path / str(pipeline)))
        res = t_run(backend, TConfig(algorithm="communication", max_rounds=6,
                                     sleep_after_action_s=0.0, pipeline=pipeline),
                    device="cpu", registry=TRegistry(), ops=plane)
        return res, plane

    seq, seq_plane = run(False)
    pip, pip_plane = run(True)
    assert [strip(r) for r in pip.rounds] == [strip(r) for r in seq.rounds]
    assert pip_plane.health.rounds == seq_plane.health.rounds == 6
    ring = pip_plane.recorder.rounds
    assert [e["round"] for e in ring] == list(range(1, 7)) and all(e["digest"] for e in ring)
    assert [e["digest"] for e in ring] == [e["digest"] for e in seq_plane.recorder.rounds]
    assert all(e["record"]["pipeline"] for e in ring)
