"""The proactive fleet plane in the port: the fleet forecast step and the
fleet proactive decision against the port's solo versions (bit for bit)
and against the JAX package (tests/test_fleet_v2.py:254-416).

Bars. The fleet runs the solo ``forecast_step`` and the solo
``decide_with_forecast`` once per tenant in one body, so every tenant's
state, delta, diag and decision must equal the solo ones exactly, masked
rounds included — the pin tests/test_fleet_v2.py:254 asks of the JAX
package, which its vmapped forecaster does not meet (ROADMAP Queue 3).
Against the JAX fleet step the state, deltas and diags are held at the
forecaster's stated tolerance (rtol 1e-4 / atol 1e-5, tests/
test_torch_forecast.py's module docstring: the two frameworks' ridge solves
differ in their last bits); the JAX fleet decision, fed the same deltas,
is equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_compiled import guarded_bodies  # noqa: F401 (fixture)
from test_torch_fleet import fleets, jax_keys, snapshots
from test_torch_forecast import ATOL, RTOL
from test_torch_sim_device import strip

from kubernetes_rescheduling_tpu.forecast import fleet as jff
from kubernetes_rescheduling_tpu.solver import fleet as jfleet
from kubernetes_rescheduling_tpu_torch._random import tenant_seed
from kubernetes_rescheduling_tpu_torch.backends.fleet import make_fleet as t_make_fleet
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.fleet import run_fleet_controller as t_run_fleet
from kubernetes_rescheduling_tpu_torch.config import (
    FleetConfig,
    ForecastConfig,
    RescheduleConfig,
)
from kubernetes_rescheduling_tpu_torch.forecast import fleet as tff
from kubernetes_rescheduling_tpu_torch.forecast import model as tm
from kubernetes_rescheduling_tpu_torch.forecast import plane as tplane
from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS
from kubernetes_rescheduling_tpu_torch.solver import compiled
from kubernetes_rescheduling_tpu_torch.solver import fleet as tfleet
from kubernetes_rescheduling_tpu_torch.solver.round_loop import decide_with_forecast
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry

SCALARS = (1e-3, 0.0, 4.0, 0.85, 0.97)  # ridge, min_skill, min_history, decay, fit_decay


def drifted(states, rnd):
    """tests/test_fleet_v2.py:277's per-round load drift, tenant-dependent."""
    return [s.replace(node_base_cpu=s.node_base_cpu + 7.0 * rnd * ((t + 1) % 2 + 1))
            for t, s in enumerate(states)]


def test_fleet_forecast_bit_exact_vs_port_solo_step():
    """The stacked state evolves exactly as the solo step per tenant,
    including rounds where a tenant is masked out (an inert slot: zero
    delta, zero diag, untouched state)."""
    _, tf = fleets(3)
    states, _ = snapshots(tf)
    n = states[0].num_nodes
    p = torch.tensor(SCALARS, dtype=torch.float32)
    fstack = tff.init_fleet_forecast_state(2, 3, n, device="cpu")
    fsolo = [tm.init_forecast_state(2, n, device="cpu") for _ in range(3)]
    for rnd in range(9):
        sts = drifted(states, rnd)
        mask = np.array([True, rnd % 3 != 0, True])
        fstack, dstack, gstack = tff.fleet_forecast_step(
            tfleet.stack_tenants(sts), fstack, torch.from_numpy(mask), p)
        for t in range(3):
            if not mask[t]:
                assert not dstack[t].any() and not gstack[t].any()
                continue
            before = tfleet.tenant_view(fstack, t)
            fsolo[t], d, g = tm.step_with_params(sts[t], fsolo[t], p)
            assert torch.equal(dstack[t], d) and torch.equal(gstack[t], g)
            for name in tm.FORECAST_FIELDS:
                assert torch.equal(getattr(fsolo[t], name), getattr(before, name)), name
        # a masked tenant's state is the one it had before the round
        if not mask[1]:
            assert torch.equal(fstack.history[1], fsolo[1].history)


def test_fleet_forecast_matches_jax():
    """The same rounds through the JAX fleet step: state, deltas and diags
    at the stated tolerance, the gate's zero pattern and the masked slots
    exactly."""
    jf, tf = fleets(3)
    j_states, _ = snapshots(jf)
    t_states, _ = snapshots(tf)
    n = t_states[0].num_nodes
    p = torch.tensor(SCALARS, dtype=torch.float32)
    sc = [jnp.float32(v) for v in SCALARS]
    fstack = tff.init_fleet_forecast_state(2, 3, n, device="cpu")
    jstack = jff.init_fleet_forecast_state(2, 3, n)
    step = jff._fleet_forecast_step
    for rnd in range(9):
        mask = np.array([True, rnd % 3 != 0, True])
        fstack, td, tg = tff.fleet_forecast_step(
            tfleet.stack_tenants(drifted(t_states, rnd)), fstack, torch.from_numpy(mask), p)
        jstack, jd, jg = step(jfleet.stack_tenants(drifted(j_states, rnd)), jstack,
                              jnp.asarray(mask), *sc)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL * 2e4)
        np.testing.assert_array_equal(td.numpy() == 0, np.asarray(jd) == 0)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=ATOL)
        for name in ("A", "b", "history", "count", "err_model_sum", "err_rounds"):
            np.testing.assert_allclose(getattr(fstack, name).numpy(),
                                       np.asarray(getattr(jstack, name)), rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def test_fleet_forecast_repad_grows_cold_slots():
    """tests/test_fleet_v2.py:299."""
    fst = tff.init_fleet_forecast_state(2, 3, 4, device="cpu")
    grown = tm.repad_forecast_state(fst, 8)
    assert grown.history.shape == (3, 3, 8) and grown.A.shape == (3, 8, 3, 3)
    assert grown.b.shape == (3, 8, 3) and grown.count.shape == (3, 8)
    with pytest.raises(ValueError, match="shrink"):
        tm.repad_forecast_state(grown, 4)
    with pytest.raises(ValueError):
        tff.init_fleet_forecast_state(2, 0, 4, device="cpu")


def test_fleet_solve_proactive_bit_exact_vs_solo_and_jax():
    """tests/test_fleet_v2.py:308: the batched predicted-state decision
    equals the port's solo ``decide_with_forecast`` per tenant and the JAX
    fleet's on the same deltas; the masked slot is a no-op row."""
    jf, tf = fleets(3)
    j_states, j_graphs = snapshots(jf)
    t_states, t_graphs = snapshots(tf)
    n = t_states[0].num_nodes
    deltas = torch.stack([torch.full((n,), 120.0 * (t + 1)) for t in range(3)])
    mask = np.array([True, True, False])
    pid = POLICY_IDS["communication"]
    dec, hz = tfleet.fleet_solve_proactive(tfleet.stack_tenants(t_states), t_graphs, pid, 30.0,
                                           torch.from_numpy(mask), deltas)
    j_dec, j_hz = jfleet.fleet_solve_proactive(
        jfleet.stack_tenants(j_states), jfleet.stack_tenants(j_graphs), jnp.asarray(pid),
        jnp.asarray(30.0), jax_keys(3), jnp.asarray(mask), jnp.asarray(deltas.numpy()))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(j_dec))
    np.testing.assert_array_equal(hz.numpy(), np.asarray(j_hz))
    for t in range(2):
        most, h, victim, svc, target = decide_with_forecast(t_states[t], t_graphs[t], pid, 30.0,
                                                            None, deltas[t])
        assert dec[t].tolist() == [int(most), int(victim), int(svc), int(target)]
        assert torch.equal(hz[t], h)
    assert dec[2].tolist() == [-1, -1, 0, -1] and not hz[2].any()


def test_fleet_proactive_bodies_read_nothing_back(guarded_bodies):
    _, tf = fleets(2)
    states, graphs = snapshots(tf)
    stacked = tfleet.stack_tenants(states)
    plane = tff.FleetForecastPlane(ForecastConfig(min_history=4), 2, device="cpu")
    mask = torch.ones(2, dtype=torch.bool)
    deltas, _ = plane.observe_and_predict(stacked, mask)
    tfleet.fleet_solve_proactive(stacked, graphs, POLICY_IDS["communication"], 30.0, mask,
                                 deltas)
    assert guarded_bodies == ["fleet_forecast", "fleet_solve_proactive"]


def test_fleet_forecast_plane_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tff.FleetForecastPlane(ForecastConfig(), 2)


def record_deltas(monkeypatch, cls):
    got = []
    real = cls.observe_and_predict

    def record(self, *a, **k):
        out = real(self, *a, **k)
        got.append(out[0].clone() if isinstance(out, tuple) else out.clone())
        return out

    monkeypatch.setattr(cls, "observe_and_predict", record)
    return got


@pytest.mark.parametrize("rounds,tenants", [(6, 3), (10, 2)])
def test_fleet_proactive_controller_matches_n_solo_controllers(rounds, tenants, monkeypatch):
    """tests/test_fleet_v2.py:395: the multiplexed proactive loop is N solo
    proactive loops on one device plane — every record field but timing
    (forecast blocks included) and every tenant's delta bits; the forecast
    step and the decision each key one capture; one decision read a round
    carries the diag matrix."""
    fc = ForecastConfig(min_history=4)
    keys = []
    real_run = compiled.GraphCache.run

    def rec(self, fn, key, inputs, make_body, operands=()):
        keys.append(compiled.GraphCache._full_key(fn, key, inputs, operands))
        return real_run(self, fn, key, inputs, make_body, operands)

    monkeypatch.setattr(compiled.GraphCache, "run", rec)
    fleet_deltas = record_deltas(monkeypatch, tff.FleetForecastPlane)
    fleet = t_make_fleet("mubench", tenants, seed=1, device="cpu")
    fleet.inject_imbalance()
    reg = MetricsRegistry()
    res = t_run_fleet(fleet, RescheduleConfig(algorithm="proactive", max_rounds=rounds,
                                              sleep_after_action_s=0.0, forecast=fc,
                                              fleet=FleetConfig(tenants=tenants)),
                      device="cpu", registry=reg)
    assert {k[0] for k in keys} == {"fleet_forecast", "fleet_solve_proactive"}
    assert len({k for k in keys if k[0] == "fleet_forecast"}) == 1
    assert len({k for k in keys if k[0] == "fleet_solve_proactive"}) == 1
    assert reg.value("device_transfers_total", site="fleet_decision") == rounds
    solo_deltas = record_deltas(monkeypatch, tplane.ForecastPlane)
    solo_fleet = t_make_fleet("mubench", tenants, seed=1, device="cpu")
    solo_fleet.inject_imbalance()
    modes = []
    for t, (name, backend) in enumerate(zip(solo_fleet.tenant_names, solo_fleet.backends)):
        del solo_deltas[:]
        solo = t_run(backend, RescheduleConfig(algorithm="proactive", max_rounds=rounds,
                                               sleep_after_action_s=0.0, forecast=fc,
                                               seed=tenant_seed(0, t)),
                     device="cpu", registry=MetricsRegistry())
        fl = res.results[name]
        assert len(solo.rounds) == len(fl.rounds) == rounds
        for a, b in zip(solo.rounds, fl.rounds):
            # `decisions` counts the latency samples: the solo round times its
            # forecast step apart, the fleet round times one shared dispatch
            sa, sb = strip(a), strip(b)
            assert sa.pop("decisions") == 2 and sb.pop("decisions") == 1
            assert sa == sb, a.round
        for r in range(rounds):
            assert torch.equal(solo_deltas[r], fleet_deltas[r][t])
        modes += [r.forecast["mode"] for r in fl.rounds]
        assert reg.value("fleet_forecast_skill", tenant=name) == fl.rounds[-1].forecast["skill"]
    assert "predictive" in modes
    for mode in set(modes):
        assert reg.value("forecast_rounds_total", mode=mode) == modes.count(mode)
