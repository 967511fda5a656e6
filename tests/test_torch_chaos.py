"""The chaos backend (``backends/chaos.py``), the simulator's fault mutators
and the chaos soak cell in the port, against the JAX package's.

- Each case of tests/test_resilience.py's ``TestChaosBackend`` is written
  once over a package namespace and run on both packages: the case's own
  assertions hold in each, and what it observes — fault counts, poisoned
  readings, landings, the registry's ``chaos_faults_total`` — is equal.
- The fault stream call by call: for every named profile the same seeded
  sequence of monitors, moves, pod waves and clock advances over the same
  simulator gives the same outcome on every call (exception kind, ``None``,
  landing, the snapshot's arrays bit for bit) and the same fault counts.
- The mutators (tests/test_backends.py:76-101): ``kill_node``,
  ``revive_node``, ``cpu_spike`` (in the snapshots and the simulated
  scheduler's sums) and ``churn`` leave the simulator in the JAX
  simulator's state, snapshot and event log.
- ``config.chaos`` wraps the loop's backend, and ``run_chaos_soak``'s
  report equals the JAX one on the same seeds.

Bars: everything compared is exactly equal — the wrapper draws from
``random.Random`` streams seeded alike, and the snapshots' arrays are the
simulators' f32 values, poisoned by the same draws.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from test_torch_controller import assert_same_records

from kubernetes_rescheduling_tpu.backends import chaos as jchaos
from kubernetes_rescheduling_tpu.backends.base import MoveRequest as JMove
from kubernetes_rescheduling_tpu.backends.sim import SimBackend as JSim
from kubernetes_rescheduling_tpu.bench.controller import run_controller as j_run
from kubernetes_rescheduling_tpu.bench.harness import make_backend as j_make
from kubernetes_rescheduling_tpu.bench.harness import run_chaos_soak as j_soak
from kubernetes_rescheduling_tpu.config import ChaosConfig
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.core import workmodel as jwm
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu.utils.retry import RetryPolicy as JRetry
from kubernetes_rescheduling_tpu_torch import backends as tbackends
from kubernetes_rescheduling_tpu_torch import cli as t_cli
from kubernetes_rescheduling_tpu_torch.backends import chaos as tchaos
from kubernetes_rescheduling_tpu_torch.backends.base import MoveRequest as TMove
from kubernetes_rescheduling_tpu_torch.backends.sim import SimBackend as TSim
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend as t_make
from kubernetes_rescheduling_tpu_torch.bench.harness import run_chaos_soak as t_soak
from kubernetes_rescheduling_tpu_torch.config import CHAOS_PROFILES
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.core import workmodel as twm
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry
from kubernetes_rescheduling_tpu_torch.telemetry import OpsPlane as TOpsPlane
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger as TLogger
from kubernetes_rescheduling_tpu_torch.utils.retry import RetryPolicy as TRetry


def _t_fault_family(reg) -> dict:
    m = reg._metrics.get("chaos_faults_total")
    return {} if m is None else {k[0]: c.value for k, c in m._children.items()}


def _j_fault_family(reg) -> dict:
    return {r["labels"]["kind"]: r["value"] for r in reg.snapshot()
            if r["metric"] == "chaos_faults_total"}


JAX = SimpleNamespace(
    chaos=jchaos, Move=JMove, Registry=JRegistry, faults=_j_fault_family,
    make=lambda scenario, seed: j_make(scenario, seed),
    Sim=JSim, workmodel=jwm.mubench_workmodel_c, dev={},
)
TORCH = SimpleNamespace(
    chaos=tchaos, Move=TMove, Registry=TRegistry, faults=_t_fault_family,
    make=lambda scenario, seed: t_make(scenario, seed, device="cpu"),
    Sim=TSim, workmodel=twm.mubench_workmodel_c, dev={"device": "cpu"},
)


def arr(x) -> np.ndarray:
    return np.array(x)


def _sim(P):
    """tests/test_resilience.py:230: µBench piled on worker1."""
    b = P.make("mubench", 1)
    b.inject_imbalance("worker1")
    return b


def view(state) -> dict:
    """A snapshot's arrays, floats as raw f32 bytes (NaN-safe, bit exact)."""
    if state is None:
        return None
    return {"pod_node": arr(state.pod_node).astype(np.int64).tolist(),
            "pod_valid": arr(state.pod_valid).tolist(),
            "node_valid": arr(state.node_valid).tolist(),
            "pod_cpu": arr(state.pod_cpu).astype(np.float32).tobytes(),
            "pod_mem": arr(state.pod_mem).astype(np.float32).tobytes(),
            "node_cpu_cap": arr(state.node_cpu_cap).astype(np.float32).tobytes()}


# ---------------- TestChaosBackend, on both packages ----------------


def cb_profiles_validate(P, reg):
    for name, prof in P.chaos.PROFILES.items():
        assert prof.validate().name == name
    for bad in (dict(monitor_error_rate=1.5), dict(monitor_corrupt_rate=-0.1),
                dict(corrupt_max_pods=0)):
        with pytest.raises(ValueError):
            P.chaos.ChaosProfile(**bad).validate()
    with pytest.raises(ValueError, match="unknown chaos profile"):
        P.chaos.with_chaos(_sim(P), "no-such-profile")
    assert P.chaos.PROFILES["soak"].monitor_corrupt_rate > 0
    assert P.chaos.PROFILES["soak"].external_drift_rate > 0
    assert P.chaos.PROFILES["reconcile"].move_lost_rate > 0
    return {name: dataclasses.asdict(p) for name, p in P.chaos.PROFILES.items()}


def cb_none_profile_is_passthrough(P, reg):
    b = _sim(P)
    assert P.chaos.with_chaos(b, "none") is b
    assert P.chaos.with_chaos(b, P.chaos.ChaosProfile()) is b  # injects nothing
    assert isinstance(P.chaos.with_chaos(b, "soak", registry=reg), P.chaos.ChaosBackend)


def cb_seeded_fault_stream_is_deterministic(P, reg):
    def run(seed):
        chaos = P.chaos.ChaosBackend(_sim(P), P.chaos.PROFILES["soak"], seed=seed,
                                     registry=reg)
        for _ in range(40):
            try:
                chaos.monitor()
            except P.chaos.ChaosError:
                pass
        return dict(chaos.fault_counts)

    a, b, c = run(3), run(3), run(4)
    assert a == b and a != c
    return {"3": a, "4": c}


def cb_injected_registry_receives_fault_counters(P, reg):
    chaos = P.chaos.ChaosBackend(_sim(P), P.chaos.ChaosProfile(monitor_error_rate=1.0), seed=0,
                                 registry=reg)
    with pytest.raises(P.chaos.ChaosError):
        chaos.monitor()
    assert P.faults(reg) == {"monitor_error": 1}


def cb_fault_counts_match_registry(P, reg):
    chaos = P.chaos.ChaosBackend(_sim(P), P.chaos.PROFILES["soak"], seed=0, registry=reg)
    for _ in range(30):
        try:
            chaos.monitor()
        except P.chaos.ChaosError:
            pass
    assert chaos.fault_counts
    assert P.faults(reg) == chaos.fault_counts
    return dict(chaos.fault_counts)


def cb_monitor_corrupt_poisons_readings_not_shapes(P, reg):
    prof = P.chaos.ChaosProfile(monitor_corrupt_rate=1.0, corrupt_max_pods=3)
    chaos = P.chaos.ChaosBackend(_sim(P), prof, seed=0, registry=reg)
    clean = chaos.inner.monitor()
    state = chaos.monitor()
    valid = arr(state.pod_valid)
    bad = np.zeros_like(valid)
    for field, cap_field in (("pod_cpu", "node_cpu_cap"), ("pod_mem", "node_mem_cap")):
        a = arr(getattr(state, field))
        cap = float(np.max(arr(getattr(state, cap_field))))
        bad |= valid & (~np.isfinite(a) | (a < 0.0) | (a > cap))
        assert a.shape == arr(getattr(clean, field)).shape
    assert 1 <= int(bad.sum()) <= 3
    assert chaos.fault_counts["monitor_corrupt"] == 1
    # the clean snapshot the wrapper poisoned a copy of is unchanged
    assert np.isfinite(arr(clean.pod_cpu)).all()
    return view(state)


def cb_pod_move_wave_gets_landing_faults(P, reg):
    backend = _sim(P)
    chaos = P.chaos.ChaosBackend(backend, P.chaos.PROFILES["reconcile"], seed=5, registry=reg)
    state = backend.monitor()
    valid = np.flatnonzero(arr(state.pod_valid))
    svcs = arr(state.pod_service)
    graph = backend.comm_graph()
    moves = [P.Move(service=graph.names[int(svcs[i])], pod=state.pod_names[int(i)],
                    target_node="worker2") for i in valid[:6]]
    waves = []
    for _ in range(12):
        waves.append(chaos.apply_pod_moves(moves))
        if chaos.fault_counts.get("move_lost", 0) and chaos.fault_counts.get(
                "move_wrong_node", 0):
            break
    assert chaos.fault_counts.get("move_lost", 0) >= 1
    assert chaos.fault_counts.get("move_wrong_node", 0) >= 1
    assert isinstance(waves[-1], dict)
    assert P.faults(reg) == chaos.fault_counts
    return {"waves": waves, "pod_node": arr(backend.monitor().pod_node).tolist()}


def cb_external_drift_moves_a_pod(P, reg):
    sim = _sim(P)
    chaos = P.chaos.ChaosBackend(sim, P.chaos.ChaosProfile(external_drift_rate=1.0), seed=0,
                                 registry=reg)
    before = sim.monitor()
    after = chaos.monitor()
    moved = (arr(before.pod_node) != arr(after.pod_node)) & arr(after.pod_valid)
    assert int(moved.sum()) == 1
    assert chaos.fault_counts["external_drift"] == 1
    return view(after)


def cb_move_lost_acknowledges_without_moving(P, reg):
    sim = _sim(P)
    chaos = P.chaos.ChaosBackend(sim, P.chaos.ChaosProfile(move_lost_rate=1.0), seed=0,
                                 registry=reg)
    before = sim.monitor()
    assert chaos.apply_move(P.Move(service="s0", target_node="worker2")) == "worker2"
    assert np.array_equal(arr(before.pod_node), arr(sim.monitor().pod_node))
    assert chaos.fault_counts["move_lost"] == 1


def cb_reconcile_profile_fault_counts_match_registry(P, reg):
    chaos = P.chaos.ChaosBackend(_sim(P), P.chaos.PROFILES["reconcile"], seed=0, registry=reg)
    for _ in range(30):
        chaos.monitor()
        chaos.apply_move(P.Move(service="s0", target_node="worker2"))
    for kind in ("monitor_corrupt", "external_drift", "move_lost"):
        assert chaos.fault_counts.get(kind, 0) >= 1, kind
    assert P.faults(reg) == chaos.fault_counts
    return dict(chaos.fault_counts)


def cb_aux_stream_leaves_legacy_fault_sequence_unchanged(P, reg):
    legacy = dataclasses.replace(P.chaos.PROFILES["soak"], monitor_corrupt_rate=0.0,
                                 external_drift_rate=0.0, move_lost_rate=0.0)

    def run(prof):
        chaos = P.chaos.ChaosBackend(_sim(P), prof, seed=5, registry=reg)
        for _ in range(40):
            try:
                chaos.monitor()
            except P.chaos.ChaosError:
                pass
            try:
                chaos.apply_move(P.Move(service="s0", target_node="worker2"))
            except (P.chaos.ChaosError, TimeoutError):
                pass
        return chaos.fault_counts

    with_new, without = run(P.chaos.PROFILES["soak"]), run(legacy)
    new_kinds = {"monitor_corrupt", "external_drift", "move_lost"}
    for kind in (set(with_new) | set(without)) - new_kinds:
        assert with_new.get(kind, 0) == without.get(kind, 0), kind
    return {"with": dict(with_new), "without": dict(without)}


def cb_stale_snapshot_is_previous_state(P, reg):
    chaos = P.chaos.ChaosBackend(_sim(P), P.chaos.ChaosProfile(monitor_stale_rate=1.0), seed=0,
                                 registry=reg)
    first = chaos.monitor()
    assert first is not None
    chaos.inner.kill_node("worker1")
    assert chaos.monitor() is first
    assert chaos.fault_counts["monitor_stale"] == 1


def cb_partial_snapshot_drops_pods_not_shapes(P, reg):
    prof = P.chaos.ChaosProfile(monitor_partial_rate=1.0, partial_drop_frac=0.3)
    chaos = P.chaos.ChaosBackend(_sim(P), prof, seed=0, registry=reg)
    full = chaos.inner.monitor()
    part = chaos.monitor()
    assert tuple(part.pod_valid.shape) == tuple(full.pod_valid.shape)
    n_full = int(arr(full.pod_valid).sum())
    assert int(arr(part.pod_valid).sum()) == n_full - int(n_full * 0.3)
    # the partial snapshot is not cached as the last good one
    assert chaos._last_state is None
    return view(part)


def cb_wrong_node_move_lands_elsewhere(P, reg):
    chaos = P.chaos.ChaosBackend(_sim(P), P.chaos.ChaosProfile(move_wrong_node_rate=1.0),
                                 seed=0, registry=reg)
    landed = chaos.apply_move(P.Move(service="s0", target_node="worker2"))
    assert landed is not None and landed != "worker2"
    assert chaos.fault_counts["move_wrong_node"] == 1
    return landed


def cb_move_timeout_consumes_inner_clock(P, reg):
    sim = _sim(P)
    chaos = P.chaos.ChaosBackend(sim, P.chaos.ChaosProfile(move_timeout_rate=1.0,
                                                           move_timeout_s=30.0),
                                 seed=0, registry=reg)
    with pytest.raises(TimeoutError):
        chaos.apply_move(P.Move(service="s0", target_node="worker2"))
    assert sim.clock_s == 30.0


def cb_node_flap_kills_and_revives(P, reg):
    sim = _sim(P)
    chaos = P.chaos.ChaosBackend(sim, P.chaos.ChaosProfile(node_flap_period=3,
                                                           node_flap_down_calls=2),
                                 seed=0, registry=reg)
    saw_dead = False
    for _ in range(10):
        if not bool(arr(chaos.monitor().node_valid).all()):
            saw_dead = True
    assert saw_dead
    assert chaos.fault_counts["node_kill"] >= 1 and chaos.fault_counts["node_revive"] >= 1
    assert chaos.fault_counts["node_kill"] - chaos.fault_counts["node_revive"] in (0, 1)
    return {"counts": dict(chaos.fault_counts), "events": sim.events}


CASES = [f for name, f in sorted(globals().items()) if name.startswith("cb_") and callable(f)]


@pytest.mark.parametrize("case", CASES, ids=[f.__name__[3:] for f in CASES])
def test_chaos_backend_case_matches_jax(case):
    """The case's assertions hold in both packages, and what it observes,
    the registry's fault family included, is equal."""
    seen = []
    for P in (JAX, TORCH):
        reg = P.Registry()
        seen.append((case(P, reg), P.faults(reg)))
    assert seen[1] == seen[0]


# ---------------- the fault stream, call by call ----------------


def _drive(P, profile: str, seed: int, calls: int = 36) -> list:
    """A fixed call sequence through the wrapper: monitor, a Deployment
    move, a two-pod wave and a clock advance each step; one entry per call
    with its outcome and the fault counts after it."""
    sim = _sim(P)
    chaos = P.chaos.ChaosBackend(sim, P.chaos.PROFILES[profile], seed=seed, registry=P.Registry())
    out = []
    for step in range(calls):
        try:
            got = ("state", view(chaos.monitor()))
        except Exception as e:  # noqa: BLE001 (the outcome is what is compared)
            got = ("raise", type(e).__name__)
        out.append(("monitor", got, dict(chaos.fault_counts)))
        svc = f"s{step % 20}"
        target = ("worker1", "worker2", "worker3")[step % 3]
        try:
            got = ("landed", chaos.apply_move(P.Move(service=svc, target_node=target)))
        except Exception as e:  # noqa: BLE001
            got = ("raise", type(e).__name__)
        out.append(("apply_move", got, dict(chaos.fault_counts)))
        pods = [p[2] for p in sim._pods[step % 5::7][:2]]
        wave = [P.Move(service="s0", pod=p, target_node=target) for p in pods]
        out.append(("apply_pod_moves", chaos.apply_pod_moves(wave), dict(chaos.fault_counts)))
        chaos.advance(1.0)
    out.append(("clock", sim.clock_s, sim.events))
    return out


@pytest.mark.parametrize("profile", [p for p in CHAOS_PROFILES if p != "none"])
def test_fault_stream_matches_jax_call_by_call(profile):
    """Every named profile, over the same simulator and seed: the same
    fault on every call, the same snapshots bit for bit, the same clock and
    event log at the end."""
    j, t = _drive(JAX, profile, seed=7), _drive(TORCH, profile, seed=7)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        assert a == b, a[0]


def test_profile_names_match_the_chaos_module():
    """``config.CHAOS_PROFILES`` (kept beside ``ELASTIC_PROFILES``) holds the
    names of ``backends.chaos.PROFILES``, which equal the JAX package's."""
    assert CHAOS_PROFILES == tuple(tchaos.PROFILES)
    assert set(tchaos.PROFILES) == set(jchaos.PROFILES)
    assert tbackends.CHAOS_PROFILES is tchaos.PROFILES
    assert tbackends.with_chaos is tchaos.with_chaos
    with pytest.raises(ValueError, match="unknown chaos profile 'tsunami'"):
        TConfig(chaos="tsunami").validate()
    for name in CHAOS_PROFILES:
        TConfig(chaos=name).validate()


# ---------------- the simulator's fault mutators ----------------


def _mutator_sim(P, **kw):
    """tests/test_backends.py:22."""
    return P.Sim(workmodel=P.workmodel(), node_names=["worker1", "worker2", "worker3"],
                 **kw, **P.dev)


def mut_node_kill_and_reschedule(P):
    sim = _mutator_sim(P)
    sim.inject_imbalance("worker1")
    sim.kill_node("worker1")
    state = sim.monitor()
    nodes = arr(state.pod_node)[arr(state.pod_valid)]
    assert (nodes == -1).all()
    assert float(state.node_cpu_cap[0]) == 0.0
    assert sim.schedule_pending() == 20
    state = sim.monitor()
    assert set(arr(state.pod_node)[arr(state.pod_valid)].tolist()) <= {1, 2}
    sim.revive_node("worker1")
    return view(sim.monitor()), sim.events


def mut_cpu_spike_detected(P):
    sim = _mutator_sim(P, node_cpu_cap_m=100_000.0)
    base = sim.monitor()
    sim.cpu_spike("s0", 50.0)
    spiked = sim.monitor()
    s0 = next(i for i in range(base.num_pods)
              if bool(base.pod_valid[i]) and int(base.pod_service[i]) == 0)
    assert float(spiked.pod_cpu[s0]) > float(base.pod_cpu[s0]) * 10
    return view(spiked)


def mut_cpu_spike_steers_the_scheduler(P):
    """A spiked service's pods weigh ``factor`` times in the simulated
    scheduler's allocation sums (an ``affinityOnly`` move and a scale-up
    land where the JAX simulator lands them), and a teardown drops the
    service's spike."""
    sim = _mutator_sim(P, seed=3)
    sim.cpu_spike("s3", 40.0)
    sim.cpu_spike("s7", 0.25)
    landed = [sim.apply_move(P.Move(service=f"s{i}", target_node="worker1",
                                    mechanism="affinityOnly")) for i in range(6)]
    sim.scale_replicas("s5", 4)
    sim.teardown_service("s3")
    assert "s3" not in sim._cpu_spike
    sim.scale_replicas("s9", 3)
    return landed, view(sim.monitor()), sim.events


def mut_churn_deterministic(P):
    a, b = _mutator_sim(P, seed=5), _mutator_sim(P, seed=5)
    a.kill_node("worker3")
    b.kill_node("worker3")
    a.churn(10)
    b.churn(10)
    assert np.array_equal(arr(a.monitor().pod_node), arr(b.monitor().pod_node))
    assert not (arr(a.monitor().pod_node) == 2).any()  # only alive nodes
    return view(a.monitor()), a.events


def mut_drain_is_kill_then_schedule(P):
    sim = _mutator_sim(P, seed=2)
    sim.drain_node("worker2")
    sim.add_node("worker2")  # a drained slot of this name revives
    sim.add_node("worker4")
    return view(sim.monitor()), [e["event"] for e in sim.events]


MUTATORS = [f for name, f in sorted(globals().items()) if name.startswith("mut_")]


@pytest.mark.parametrize("case", MUTATORS, ids=[f.__name__[4:] for f in MUTATORS])
def test_sim_mutator_matches_jax(case):
    """tests/test_backends.py:73-101 on both simulators: the case holds in
    each, and the snapshots and event logs are equal."""
    assert case(TORCH) == case(JAX)


# ---------------- config.chaos and the soak cell ----------------


def test_controller_config_chaos_wraps_backend():
    """tests/test_resilience.py:657: ``config.chaos`` wraps the loop's
    backend; the loop completes under injected faults, the run's registry
    counts them, and the records equal the JAX loop's."""
    kw = dict(algorithm="communication", max_rounds=10, sleep_after_action_s=0.0, seed=1,
              max_consecutive_failures=3)
    treg, jreg = TRegistry(), JRegistry()
    t = t_run(_sim(TORCH), TConfig(**kw, chaos="flaky-monitor", chaos_seed=1,
                                   retry=TRetry(max_attempts=2, base_delay_s=0.0)),
              device="cpu", registry=treg)
    j = j_run(_sim(JAX), JConfig(**kw, chaos=ChaosConfig(profile="flaky-monitor", seed=1),
                                 retry=JRetry(max_attempts=2, base_delay_s=0.0)),
              key=jax.random.PRNGKey(1), registry=jreg)
    assert len(t.rounds) + t.skipped_rounds == 10
    assert _t_fault_family(treg)
    assert _t_fault_family(treg) == _j_fault_family(jreg)
    assert_same_records(t, j)


def test_chaos_soak_acceptance(tmp_path):
    """tests/test_resilience.py:698 on the port: 35 rounds under the seeded
    ``soak`` profile never raise, the breaker opens and closes, every round
    is accounted, the fault counts equal the registry's, the skip counts
    agree between the result, the registry and the event log — and the
    report equals the JAX package's on the same seeds. An ops plane
    attached to the same soak changes none of it, counts every executed
    and skipped round, and dumps a bundle at each breaker opening."""
    kw = dict(profile="soak", rounds=35, seed=1, chaos_seed=0, max_consecutive_failures=3,
              breaker_cooldown_rounds=2, failure_budget_per_round=2)
    reg, logger = TRegistry(), TLogger(name="soak")
    report = t_soak(retry=TRetry(max_attempts=1), logger=logger, registry=reg, device="cpu",
                    **kw)
    assert report["rounds"] == 35
    assert report["records"] + report["skipped_rounds"] == 35
    assert report["skipped_rounds"] >= 1
    assert report["breaker_opens"] >= 1 and report["breaker_closes"] >= 1
    assert report["faults_injected"] > 0
    assert _t_fault_family(reg) == report["fault_counts"]
    assert reg.value("rounds_skipped_total", algorithm="communication") == \
        report["skipped_rounds"]
    events = [r["event"] for r in logger.records]
    assert events.count("round_skipped") == report["skipped_rounds"]
    assert events.count("round") == report["records"]
    assert "breaker" in events
    assert report == j_soak(retry=JRetry(max_attempts=1), registry=JRegistry(), **kw)
    reg2 = TRegistry()
    plane = TOpsPlane.from_config(TConfig(), registry=reg2, bundle_dir=str(tmp_path))
    assert t_soak(retry=TRetry(max_attempts=1), registry=reg2, ops=plane, device="cpu",
                  **kw) == report
    assert plane.health.rounds == report["records"]
    assert plane.health.skipped_rounds == report["skipped_rounds"]
    opens = [p for p in plane.recorder.dumps if "breaker_open" in p.name]
    assert len(opens) == report["breaker_opens"]


def test_cli_reschedule_chaos(capsys):
    """``reschedule --chaos-profile/--chaos-seed``: every round accounted
    and the breaker transitions reported."""
    assert t_cli.main(["reschedule", "--imbalance", "--rounds", "12", "--chaos-profile", "soak",
                       "--chaos-seed", "0", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert len(out["rounds"]) + out["skipped_rounds"] == 12
    assert out["boundary_failures"] > 0
    with pytest.raises(SystemExit, match="unknown chaos profile"):
        t_cli.main(["reschedule", "--chaos-profile", "tsunami", "--device", "cpu"])


def test_chaos_snapshot_stays_on_the_backend_device():
    """A poisoned snapshot is a new state on the inner backend's device:
    the partial and corrupt faults build new tensors and never write into
    the snapshot they copied."""
    sim = _sim(TORCH)
    prof = tchaos.ChaosProfile(monitor_partial_rate=1.0, monitor_corrupt_rate=1.0)
    chaos = tchaos.ChaosBackend(sim, prof, seed=1, registry=TRegistry())
    clean = sim.monitor()
    before = {k: getattr(clean, k).clone() for k in ("pod_valid", "pod_cpu", "pod_mem")}
    real_monitor = sim.monitor
    sim.monitor = lambda: clean
    try:
        state = chaos.monitor()
    finally:
        sim.monitor = real_monitor
    for k, v in before.items():
        assert torch.equal(getattr(clean, k), v), k
        assert getattr(state, k).device == v.device
    assert int(state.pod_valid.sum()) < int(clean.pod_valid.sum())


def test_on_device_names_the_current_card(monkeypatch):
    """``ClusterState.to`` / ``CommGraph.to`` return the object itself when
    its tensors already sit on the device asked for, ``"cuda"`` naming the
    current card. Before, a snapshot on ``cuda:0`` was copied into a new
    object under ``"cuda"``, so on the card the intent ledger never knew a
    re-served (``monitor_stale``) snapshot and diffed it again — the
    chaos run on the card left the CPU's fault stream at round 13."""
    from kubernetes_rescheduling_tpu_torch.core.state import on_device

    cpu, card0, card1 = torch.device("cpu"), torch.device("cuda", 0), torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert on_device(cpu, "cpu") and on_device(cpu, torch.device("cpu"))
    assert not on_device(cpu, "cuda") and not on_device(card0, "cpu")
    assert on_device(card0, "cuda") and on_device(card0, "cuda:0")
    assert not on_device(card1, "cuda") and not on_device(card1, "cuda:0")
    assert on_device(card1, "cuda:1")
    state = _sim(TORCH).monitor()
    assert state.to("cpu") is state and state.to(torch.device("cpu")) is state
