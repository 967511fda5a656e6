"""The in-block tripwires (``telemetry/tripwire.py``) against the JAX
package's, and in the port's scanned loop, after tests/test_tripwire.py's
cases (the ops plane's: the watchdog rule, /healthz and the flight
recorder at the bottom) without the fleet.

The rule kernel is held to the JAX one on seeded (cost, load, most-hazard)
sequences, bit for bit and carry for carry. In the loop: a trip-free block
gives the records of the sequential loop with the plane on and off; a cost
blowup, a hazard streak and a non-finite reading each trip at the round
the host-side simulation of the rules predicts (the same rounds the JAX
scanned loop logs), the replay commits the rounds before it, the trip
round drains under ``scan_drains_total{reason="tripwire"}``, and the whole
record stream still equals the sequential loop's.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_controller import jax_greedy_gumbel
from test_torch_sim_device import sim_pair, strip, to_jax_state

from kubernetes_rescheduling_tpu.bench.controller import run_controller as j_run
from kubernetes_rescheduling_tpu.config import ControllerConfig, ObsConfig
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu.telemetry import tripwire as jtw
from kubernetes_rescheduling_tpu.utils.logging import StructuredLogger as JLogger
from kubernetes_rescheduling_tpu_torch.backends import sim_device as tsd
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.round_end import METRIC_COST, round_end_metrics
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry
from kubernetes_rescheduling_tpu_torch.telemetry import tripwire as ttw
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger as TLogger


def _backend(n_nodes: int, seed: int = 0):
    return sim_pair(n_nodes, seed=seed, prefix="tw")[1]


def run(*, scan_block: int, n_nodes: int, rounds: int, algo: str = "communication",
        seed: int = 0, backend=None, registry=None, **cfg):
    log = TLogger()
    reg = registry if registry is not None else TRegistry()
    res = t_run(backend if backend is not None else _backend(n_nodes, seed), TConfig(
        algorithm=algo, max_rounds=rounds, sleep_after_action_s=0.0, seed=seed,
        scan_block=scan_block, **cfg), device="cpu", registry=reg, logger=log,
        gumbel_rows=jax_greedy_gumbel(seed, n_nodes))
    return res, log, reg


def events(log):
    return [{k: v for k, v in r.items() if k not in ("ts", "decision_latency_s")}
            for r in log.records if r["event"] in ("decision", "round")]


def drains(reg, reason: str) -> float:
    return reg.value("scan_drains_total", reason=reason)


# ---------------- the rule kernel against the JAX one ----------------


@pytest.mark.parametrize("cfg", [(0.1, 0.0, 2.0), (0.0, 1.5, 0.0), (0.05, 1.2, 3.0),
                                 (0.0, 0.0, 0.0)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tripwire_step_matches_jax(cfg, seed):
    """Seeded rounds of (cost, load std, most-hazard), a NaN now and then,
    through both kernels from the same baselines: the same bits and the same
    carry after every round (latch, trip round and mask, streak)."""
    t_state, _ = tsd.twin_of(_backend(24, seed))
    j_state = to_jax_state(t_state)
    rng = np.random.default_rng(seed)
    t_cfg, j_cfg = torch.tensor(cfg, dtype=torch.float32), jnp.asarray(cfg, jnp.float32)
    cost0, load0 = np.float32(rng.uniform(5, 15)), np.float32(rng.uniform(0.5, 2))
    t_carry, j_carry = ttw.tripwire_init(torch.tensor(cost0), torch.tensor(load0)), \
        jtw.tripwire_init(cost0, load0)
    for _ in range(12):
        cost = np.float32(cost0 * rng.uniform(0.8, 1.3))
        load = np.float32(load0 * rng.uniform(0.5, 2.0))
        if rng.random() < 0.08:
            cost = np.float32(np.nan)
        most = int(rng.choice([-1, 3, 3, 4]))
        t_carry, t_bits = ttw.tripwire_step(t_carry, t_state, torch.tensor(cost),
                                            torch.tensor(load), torch.tensor(most), t_cfg)
        j_carry, j_bits = jtw.tripwire_step(j_carry, j_state, jnp.asarray(cost),
                                            jnp.asarray(load), jnp.asarray(most), j_cfg)
        assert int(t_bits) == int(j_bits)
        for a, b in zip(t_carry, j_carry):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_tripwire_step_rule_semantics():
    """tests/test_tripwire.py:138: the cost and streak rules set their bits,
    the latch zeroes later bits and the recorded trip never moves; a NaN in
    a valid pod slot trips non_finite, one in a padded slot does not."""
    state, _ = tsd.twin_of(_backend(24))
    cfg = torch.tensor([0.1, 0.0, 2.0])
    carry = ttw.tripwire_init(torch.tensor(10.0), torch.tensor(1.0))
    carry, bits = ttw.tripwire_step(carry, state, torch.tensor(10.5), torch.tensor(1.0),
                                    torch.tensor(3), cfg)
    assert int(bits) == 0 and not bool(carry[0])
    carry, bits = ttw.tripwire_step(carry, state, torch.tensor(12.0), torch.tensor(1.0),
                                    torch.tensor(3), cfg)
    assert int(bits) == ttw.TRIP_COST_REGRESSION | ttw.TRIP_HAZARD_STREAK
    assert bool(carry[0]) and int(carry[1]) == 1 and int(carry[2]) == 10
    carry, bits = ttw.tripwire_step(carry, state, torch.tensor(99.0), torch.tensor(9.0),
                                    torch.tensor(3), cfg)
    assert int(bits) == 0 and int(carry[1]) == 1 and int(carry[2]) == 10
    assert ttw.rules_from_mask(int(carry[2])) == ("cost_regression", "hazard_streak")
    off = torch.zeros(3)
    cpu = state.pod_cpu.clone()
    cpu[0] = float("nan")
    _, bits = ttw.tripwire_step(ttw.tripwire_init(torch.tensor(1.0), torch.tensor(1.0)),
                                state.replace(pod_cpu=cpu), torch.tensor(1.0),
                                torch.tensor(1.0), torch.tensor(-1), off)
    assert int(bits) == ttw.TRIP_NON_FINITE
    padded = state.replace(pod_valid=torch.cat([state.pod_valid, torch.zeros(1, dtype=bool)]),
                           pod_cpu=torch.cat([state.pod_cpu, torch.tensor([float("nan")])]),
                           pod_mem=torch.cat([state.pod_mem, torch.zeros(1)]))
    _, bits = ttw.tripwire_step(ttw.tripwire_init(torch.tensor(1.0), torch.tensor(1.0)),
                                padded, torch.tensor(1.0), torch.tensor(1.0),
                                torch.tensor(-1), off)
    assert int(bits) == 0


def test_split_tripwire_roundtrip_and_guard():
    core = np.arange(7, dtype=np.float32)
    tail = np.asarray([0, 1, 0, 2.0, 8.0], np.float32)  # K=3 bits + (round, mask)
    for mod in (ttw, jtw):
        flat, report = mod.split_tripwire(np.concatenate([core, tail]), rounds=3)
        np.testing.assert_array_equal(flat, core)
        assert report.tripped and report.trip_round == 2
        assert report.rules == ("hazard_streak",)
        np.testing.assert_array_equal(report.bits, [0, 1, 0])
        with pytest.raises(ValueError):
            mod.split_tripwire(tail, rounds=3)
    assert ttw.TRIPWIRE_RULES == jtw.TRIPWIRE_RULES
    assert ttw.trip_config_array(TConfig(tripwire_cost_frac=0.2,
                                         tripwire_hazard_streak=3)).tolist() == pytest.approx(
        np.asarray(jtw.trip_config_array(ObsConfig(tripwire_cost_frac=0.2,
                                                   tripwire_hazard_streak=3))).tolist())


def test_tripwire_config_validation():
    cfg = TConfig(algorithm="communication", tripwire_cost_frac=0.2,
                  tripwire_hazard_streak=3).validate()
    assert cfg.scan_tripwires is True and cfg.scan_tripwires == ObsConfig().scan_tripwires
    for bad, rule in ((dict(tripwire_cost_frac=-0.1), "cost_regression"),
                      (dict(tripwire_load_factor=-1.0), "load_std_spike"),
                      (dict(tripwire_hazard_streak=-2), "hazard_streak")):
        with pytest.raises(ValueError, match=rule):
            TConfig(**bad).validate()
        with pytest.raises(ValueError):
            ObsConfig(**bad).validate()


# ---------------- in the scanned loop ----------------


def test_tripfree_block_identical_on_off_and_sequential():
    """The plane armed but silent: records and events equal to the
    sequential loop's and to the plane-off scanned run's, one round_end
    transfer a block, no tripwire counter touched."""
    rounds, block = 8, 3
    seq, seq_log, seq_reg = run(scan_block=0, n_nodes=24, rounds=rounds)
    on, on_log, on_reg = run(scan_block=block, n_nodes=24, rounds=rounds)
    off, off_log, off_reg = run(scan_block=block, n_nodes=24, rounds=rounds,
                                scan_tripwires=False)
    assert seq_reg.value("device_transfers_total", site="round_end") == rounds
    for reg in (on_reg, off_reg):
        # 2 blocks (one read each) + 2 drained tail rounds
        assert reg.value("device_transfers_total", site="round_end") == 4
        assert reg.value("scan_blocks_total") == 2
        assert drains(reg, "tail") == 2 and drains(reg, "tripwire") == 0
    for a, b, c in zip(seq.rounds, on.rounds, off.rounds):
        assert strip(a) == strip(b) == strip(c)
    assert events(seq_log) == events(on_log) == events(off_log)
    assert all(on_reg.value("scan_tripwires_total", rule=r) == 0 for r in ttw.TRIPWIRE_RULES)


def simulate_trips(costs, hazards, *, rounds, block, cost0, frac=0.0, streak_n=0):
    """tests/test_tripwire.py's host-side twin of the trip schedule: which
    blocks dispatch, where each trips, which rounds drain."""
    f32 = np.float32
    pos, trips, blocks = 0, [], 0
    while rounds - pos >= block:
        blocks += 1
        base = f32(cost0 if pos == 0 else costs[pos - 1])
        prev, streak, trip = None, 0, None
        for i in range(block):
            if frac > 0 and base > 0 and f32(costs[pos + i]) > f32(1.0 + f32(frac)) * base:
                trip = (i, ttw.TRIP_COST_REGRESSION)
            name = hazards[pos + i]
            if name is None:
                prev, streak = None, 0
            else:
                streak = streak + 1 if name == prev else 1
                prev = name
                if streak_n > 0 and streak >= streak_n and trip is None:
                    trip = (i, ttw.TRIP_HAZARD_STREAK)
            if trip is not None:
                break
        if trip is None:
            pos += block
        else:
            trips.append((pos + trip[0], trip[1]))
            pos += trip[0] + 1
    return trips, blocks, rounds - pos


def jax_trips(n_nodes, rounds, block, algo, **obs):
    """The JAX scanned loop's logged trips on the same simulator."""
    log = JLogger(name="tw")
    j_run(sim_pair(n_nodes, prefix="tw")[0], JConfig(
        algorithm=algo, max_rounds=rounds, sleep_after_action_s=0.0, seed=0,
        controller=ControllerConfig(scan_block=block), obs=ObsConfig(**obs)),
        registry=JRegistry(), logger=log)
    return [(r["round"], r["rules"]) for r in log.records if r["event"] == "scan_tripwire"]


def test_cost_blowup_trips_in_the_block():
    """The random policy inflates the cost; a 5% regression wire trips at
    the round the simulation predicts (the JAX scanned loop's rounds), the
    replay commits the rounds before it, the trip round drains, and the
    whole stream equals the sequential loop's."""
    rounds, block, frac = 12, 4, 0.05
    seq, seq_log, _ = run(scan_block=0, n_nodes=25, rounds=rounds, algo="random")
    state, graph = tsd.twin_of(_backend(25))
    cost0 = float(round_end_metrics(state, graph)[METRIC_COST])
    trips, blocks, tail = simulate_trips(
        [r.communication_cost for r in seq.rounds], [r.most_hazard for r in seq.rounds],
        rounds=rounds, block=block, cost0=cost0, frac=frac)
    assert trips, "the seed must produce a cost trip"
    sc, sc_log, reg = run(scan_block=block, n_nodes=25, rounds=rounds, algo="random",
                          tripwire_cost_frac=frac)
    assert len(sc.rounds) == rounds
    for a, b in zip(seq.rounds, sc.rounds):
        assert strip(a) == strip(b)
    assert events(seq_log) == events(sc_log)
    # one read a dispatch, one a drained round, nothing else
    assert reg.value("device_transfers_total", site="round_end") == blocks + len(trips) + tail
    assert reg.value("scan_tripwires_total", rule="cost_regression") == len(trips)
    assert drains(reg, "tripwire") == len(trips)
    logged = [(r["round"], r["rules"]) for r in sc_log.records if r["event"] == "scan_tripwire"]
    assert logged == [(rnd + 1, ["cost_regression"]) for rnd, _ in trips]
    assert logged == jax_trips(25, rounds, block, "random", tripwire_cost_frac=frac)


def test_hazard_streak_trips_in_the_block():
    rounds, block, streak_n = 10, 5, 2
    seq, _, _ = run(scan_block=0, n_nodes=26, rounds=rounds)
    trips, _, _ = simulate_trips(
        [r.communication_cost for r in seq.rounds], [r.most_hazard for r in seq.rounds],
        rounds=rounds, block=block, cost0=0.0, streak_n=streak_n)
    assert trips, "the seed must produce a hazard streak"
    sc, sc_log, reg = run(scan_block=block, n_nodes=26, rounds=rounds,
                          tripwire_hazard_streak=streak_n)
    assert len(sc.rounds) == rounds
    for a, b in zip(seq.rounds, sc.rounds):
        assert strip(a) == strip(b)
    assert reg.value("scan_tripwires_total", rule="hazard_streak") == len(trips)
    logged = [(r["round"], r["rules"]) for r in sc_log.records if r["event"] == "scan_tripwire"]
    assert logged == [(rnd + 1, ["hazard_streak"]) for rnd, _ in trips]
    assert logged == jax_trips(26, rounds, block, "communication",
                               tripwire_hazard_streak=streak_n)


def test_nonfinite_reading_trips_at_block_round_zero():
    """tests/test_tripwire.py:354 without the ops plane: a NaN in every
    monitor snapshot (admission off) trips each block at its first round;
    the replay commits nothing, each attempt drains one round, and the run
    still completes every round."""
    rounds, block = 4, 2
    backend = _backend(27)
    real = backend.monitor

    def poisoned():
        snap = real()
        cpu = snap.pod_cpu.clone()
        cpu[int(torch.nonzero(snap.pod_valid)[0])] = float("nan")
        return snap.replace(pod_cpu=cpu)

    backend.monitor = poisoned
    res, log, reg = run(scan_block=block, n_nodes=27, rounds=rounds, backend=backend,
                        reconcile_admission=False)
    trips_n = rounds - block + 1
    assert len(res.rounds) == rounds
    assert reg.value("scan_tripwires_total", rule="non_finite") == trips_n
    assert drains(reg, "tripwire") == trips_n and drains(reg, "tail") == rounds - trips_n
    logged = [r for r in log.records if r["event"] == "scan_tripwire"]
    assert len(logged) == trips_n
    assert all(e["block_round"] == 0 and e["rules"] == ["non_finite"]
               and e["mask"] == ttw.TRIP_NON_FINITE and e["round"] == e["block_start"]
               for e in logged)


# ---------------- the ops plane: rule, /healthz, bundles ----------------


def test_nonfinite_detection_latency_acceptance(tmp_path):
    """tests/test_tripwire.py:354 with the ops plane: every block trips at
    round 0 on a NaN reading; the /healthz scan stanza counts the blocks,
    trips and drains, the scan_tripwire rule holds /healthz at 503, and
    each trip dumps a bundle carrying the decoded trip."""
    from kubernetes_rescheduling_tpu_torch.telemetry.server import OpsPlane
    from kubernetes_rescheduling_tpu_torch.telemetry.watchdog import RULE_SCAN_TRIPWIRE

    rounds, block = 4, 2
    backend = _backend(27)
    real = backend.monitor

    def poisoned():
        snap = real()
        cpu = snap.pod_cpu.clone()
        cpu[int(torch.nonzero(snap.pod_valid)[0])] = float("nan")
        return snap.replace(pod_cpu=cpu)

    backend.monitor = poisoned
    reg = TRegistry()
    ops = OpsPlane.from_config(TConfig(flight_recorder_rounds=8), registry=reg,
                               bundle_dir=str(tmp_path))
    res = t_run(backend, TConfig(algorithm="communication", max_rounds=rounds,
                                 sleep_after_action_s=0.0, scan_block=block,
                                 reconcile_admission=False),
                device="cpu", registry=reg, logger=TLogger(), ops=ops)
    trips_n = rounds - block + 1
    assert len(res.rounds) == rounds
    payload, healthy = ops.health.snapshot()
    assert not healthy
    scan = payload["scan"]
    assert scan["blocks"] == trips_n and scan["tripped_blocks"] == trips_n
    assert scan["drains"] == {"tripwire": trips_n, "tail": rounds - trips_n}
    assert scan["last_trip"]["block_round"] == 0
    assert RULE_SCAN_TRIPWIRE in ops.watchdog.active
    assert payload["slo"]["healthy"] is False
    bundles = sorted(tmp_path.glob("flight_*_scan_tripwire.json"))
    assert len(bundles) == trips_n
    dumped = json.loads(bundles[0].read_text())
    assert dumped["trip"]["rules"] == ["non_finite"]
    assert dumped["trip"]["mask"] == ttw.TRIP_NON_FINITE and dumped["trip"]["block_round"] == 0


def test_clean_block_clears_watchdog_rule(tmp_path):
    from kubernetes_rescheduling_tpu_torch.telemetry.server import OpsPlane
    from kubernetes_rescheduling_tpu_torch.telemetry.watchdog import RULE_SCAN_TRIPWIRE

    reg = TRegistry()
    ops = OpsPlane.from_config(TConfig(), registry=reg, bundle_dir=str(tmp_path))
    ops.bind(algorithm="communication")
    ops.observe_scan_block(rounds=4, trip={"round": 7, "block_round": 3,
                                           "rules": ["non_finite"]})
    assert RULE_SCAN_TRIPWIRE in ops.watchdog.active and not ops.health.snapshot()[1]
    ops.observe_scan_block(rounds=4, trip=None)
    assert RULE_SCAN_TRIPWIRE not in ops.watchdog.active and ops.health.snapshot()[1]
    ops2 = OpsPlane.from_config(TConfig(slo_scan_tripwire=False), registry=reg,
                                bundle_dir=str(tmp_path))
    ops2.bind(algorithm="communication")
    ops2.observe_scan_block(rounds=4, trip={"round": 1, "block_round": 1,
                                            "rules": ["non_finite"]})
    assert RULE_SCAN_TRIPWIRE not in ops2.watchdog.active


def test_healthz_staleness_scales_with_inflight_block(monkeypatch):
    import time as time_mod

    from kubernetes_rescheduling_tpu_torch.telemetry.server import HealthState

    health = HealthState(max_round_age_s=60.0)
    health.mark_round()
    real_mono = time_mod.monotonic
    monkeypatch.setattr(time_mod, "monotonic", lambda: real_mono() + 120.0)
    payload, healthy = health.snapshot()
    assert payload["stale"] and not healthy
    health.mark_block_inflight(4)
    payload, healthy = health.snapshot()
    assert not payload["stale"] and healthy
    monkeypatch.setattr(time_mod, "monotonic", lambda: real_mono() + 300.0)
    payload, healthy = health.snapshot()
    assert payload["stale"] and not healthy
    monkeypatch.setattr(time_mod, "monotonic", lambda: real_mono() + 330.0)
    health.mark_round()
    payload, healthy = health.snapshot()
    assert not payload["stale"] and healthy
    monkeypatch.setattr(time_mod, "monotonic", lambda: real_mono() + 420.0)
    assert not health.snapshot()[1]


def test_watchdog_burst_flush_matches_paced():
    """A scan block flushes K records back to back: the same verdicts as
    the paced sequential loop (rules judge values and rounds, never
    inter-arrival time)."""
    import time as time_mod
    import types

    from kubernetes_rescheduling_tpu_torch.telemetry.watchdog import SLORules, Watchdog

    def record(rnd, cost, drift=None):
        rec = types.SimpleNamespace(round=rnd, decision_latency_s=0.01, communication_cost=cost)
        if drift is not None:
            rec.reconcile = {"drift_pods": drift}
        return rec

    stream = [record(1, 10.0), record(2, 9.0), record(3, 8.0), record(4, 20.0, drift=3),
              record(5, 21.0, drift=3)]
    rules = dict(window=8, min_samples=2, cost_regression_frac=0.5, max_retraces=0,
                 reconcile_max_drift_pods=1)
    reg_a, reg_b = TRegistry(), TRegistry()
    paced = Watchdog(SLORules(**rules), registry=reg_a)
    real_time = time_mod.time
    for i, rec in enumerate(stream):
        time_mod.time = lambda off=i: real_time() + 10.0 * off
        try:
            paced.observe_round(rec)
        finally:
            time_mod.time = real_time
    burst = Watchdog(SLORules(**rules), registry=reg_b)
    for rec in stream:
        burst.observe_round(rec)
    assert set(paced.active) == set(burst.active) == {"comm_cost_regression",
                                                      "reconcile_divergence"}
    for rule in ("comm_cost_regression", "reconcile_divergence"):
        assert reg_a.value("slo_violations_total", rule=rule) == \
            reg_b.value("slo_violations_total", rule=rule) == 1
    assert paced.healthy == burst.healthy is False


def test_scanned_records_equal_sequential_with_attribution():
    """With a logger (attribution on) the scanned block's rounds carry the
    per-round attribution from the block's bundle: equal to the sequential
    loop's, attribution included, in one round_end read a block."""
    seq, _, _ = run(scan_block=0, n_nodes=6, rounds=8)
    sc, _, reg = run(scan_block=4, n_nodes=6, rounds=8)
    assert all(r.attribution is not None for r in seq.rounds)
    assert [strip(r) for r in sc.rounds] == [strip(r) for r in seq.rounds]
    assert reg.value("device_transfers_total", site="round_end") == 2
