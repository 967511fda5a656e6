"""The in-block tripwires (``telemetry/tripwire.py``) against the JAX
package's, and in the port's scanned loop, after tests/test_tripwire.py's
cases without the ops plane (the watchdog rule, /healthz and the flight
recorder wait for ROADMAP Queue 1 item 4.2) and without the fleet.

The rule kernel is held to the JAX one on seeded (cost, load, most-hazard)
sequences, bit for bit and carry for carry. In the loop: a trip-free block
gives the records of the sequential loop with the plane on and off; a cost
blowup, a hazard streak and a non-finite reading each trip at the round
the host-side simulation of the rules predicts (the same rounds the JAX
scanned loop logs), the replay commits the rounds before it, the trip
round drains under ``scan_drains_total{reason="tripwire"}``, and the whole
record stream still equals the sequential loop's.
"""

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
