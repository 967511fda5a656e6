"""The forecast plane and ``proactive`` against the JAX package on the CPU,
on the cases of tests/test_forecast.py that need no ops plane or dataset.

Tolerances, and why. The port solves each node's (L+1)² ridge system by an
explicit Gaussian elimination with partial pivoting (``forecast/model.py``);
the JAX package calls ``jnp.linalg.solve`` (LAPACK on its CPU) and lets XLA
fuse the statistics' multiply-adds. On 4,096 seeded f32 SPD 3×3 systems the
two libraries' solves differ in 3,339, by up to rel 1.3e-3 on small entries,
and no elimination written in torch ops reproduces LAPACK's bits. Over a
20-round series (N = 256, a churned slot set, ``test_forecast_step_matches
_jax``) the largest differences measured were 9e-8 on A and b, 3e-7 on the
shadow prediction and on the delta (capacity 2), and 5e-7 on the diag. So
the state, the delta and the diag are held at rtol 1e-4 / atol 1e-5, and
what the gate decides exactly: which nodes get a non-zero delta, the
trained flags, the counts and the history (pure copies of the loads).

Decisions are then held exactly through a seam: ``run_controller(...,
forecast_deltas=...)`` feeds the JAX loop's own deltas to the port, which
must then decide, land and cost every round as the JAX loop does (the
forecast block's floats at the tolerance above, its mode exactly).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_compiled import guarded_bodies  # noqa: F401 (fixture)
from test_torch_controller import DECISIONS

from kubernetes_rescheduling_tpu.bench.controller import run_controller as j_run
from kubernetes_rescheduling_tpu.bench.harness import make_backend as j_make
from kubernetes_rescheduling_tpu.config import ElasticConfig
from kubernetes_rescheduling_tpu.config import ForecastConfig as JForecastConfig
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.core.state import ClusterState as JState
from kubernetes_rescheduling_tpu.forecast import model as jm
from kubernetes_rescheduling_tpu.forecast import plane as jplane
from kubernetes_rescheduling_tpu.oracle import forecast as joracle
from kubernetes_rescheduling_tpu.policies.scoring import POLICY_IDS as J_POLICY_IDS
from kubernetes_rescheduling_tpu.solver import round_loop as jrl
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu_torch import cli as t_cli
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend as t_make
from kubernetes_rescheduling_tpu_torch.bench.harness import run_forecast_headtohead
from kubernetes_rescheduling_tpu_torch.config import ForecastConfig, RescheduleConfig
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState
from kubernetes_rescheduling_tpu_torch.forecast import model as tm
from kubernetes_rescheduling_tpu_torch.forecast import plane as tplane
from kubernetes_rescheduling_tpu_torch.forecast.plane import ForecastPlane
from kubernetes_rescheduling_tpu_torch.oracle import forecast as toracle
from kubernetes_rescheduling_tpu_torch.policies.proactive import predicted_state, scoring_policy
from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS
from kubernetes_rescheduling_tpu_torch.solver import compiled
from kubernetes_rescheduling_tpu_torch.solver.round_loop import decide, decide_with_forecast
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry
from kubernetes_rescheduling_tpu_torch.telemetry.explain import explanation_consistent
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger

# the framework difference of the per-node solve (module docstring)
RTOL, ATOL = 1e-4, 1e-5
TIMING = {"decision_latencies_s", "decision_latency_s", "wall_s", "phase_s", "pipeline"}
FC_FLOATS = ("skill", "mae_model", "mae_persistence", "scored_weight", "model_node_frac")


def loads_state(loads, valid=None, cap=1.0) -> ClusterState:
    """A port state whose node_cpu_used() IS ``loads`` (no pods)."""
    loads = torch.as_tensor(np.asarray(loads, np.float32))
    n = loads.shape[0]
    z = torch.zeros
    return ClusterState(
        node_cpu_cap=torch.full((n,), float(cap)), node_mem_cap=torch.ones(n),
        node_base_cpu=loads, node_base_mem=z(n),
        node_valid=(torch.ones(n, dtype=torch.bool) if valid is None
                    else torch.as_tensor(np.asarray(valid, bool))),
        node_lex_rank=torch.arange(n, dtype=torch.int32), pod_node=z(0, dtype=torch.int32),
        pod_service=z(0, dtype=torch.int32), pod_cpu=z(0), pod_mem=z(0),
        pod_valid=z(0, dtype=torch.bool),
    )


def j_loads_state(loads, valid=None, cap=1.0) -> JState:
    t = loads_state(loads, valid, cap)
    return JState(**{f.name: jnp.asarray(getattr(t, f.name).numpy())
                     for f in dataclasses.fields(t) if isinstance(getattr(t, f.name),
                                                                  torch.Tensor)})


def params(cfg: ForecastConfig) -> torch.Tensor:
    return tm.forecast_params(cfg, "cpu")


def replay(series, cfg: ForecastConfig, valid=None, cap=1.0):
    """The port's step over a [T, N] series: the final state and every
    round's (delta, diag)."""
    t, n = np.asarray(series).shape
    fst = tm.init_forecast_state(cfg.lags, n, device="cpu")
    outs = []
    for i in range(t):
        fst, delta, diag = tm.step_with_params(
            loads_state(series[i], None if valid is None else valid[i], cap), fst, params(cfg))
        outs.append((delta.numpy(), diag.numpy()))
    return fst, outs


def j_replay(series, cfg, valid=None, cap=1.0):
    t, n = np.asarray(series).shape
    fst = jm.init_forecast_state(cfg.lags, n)
    step = jax.jit(jm.forecast_step)
    sc = [jnp.float32(v) for v in (cfg.ridge, cfg.min_skill, cfg.min_history, cfg.decay,
                                   cfg.fit_decay)]
    outs = []
    for i in range(t):
        fst, delta, diag = step(j_loads_state(series[i], None if valid is None else valid[i],
                                              cap), fst, *sc)
        outs.append((np.asarray(delta), np.asarray(diag)))
    return fst, outs


def churned_series(seed=0, t_steps=20, n=256):
    rng = np.random.default_rng(seed)
    t = np.arange(t_steps)
    series = (0.5 + 0.3 * np.sin(t / 3.0)[:, None]
              + np.cumsum(rng.normal(0, 0.05, (t_steps, n)), axis=0)
              + rng.normal(0, 0.02, (t_steps, n)))
    valid = np.ones((t_steps, n), bool)
    valid[8:11, ::7] = False  # every 7th slot drains for three rounds
    return np.clip(series, 0.01, None).astype(np.float32), valid


# ---------------- the step against the JAX package ----------------


@pytest.mark.parametrize("seed,min_history", [(0, 5), (3, 12)])
def test_forecast_step_matches_jax(seed, min_history):
    """20 rounds of the online step on the same seeded series (a churned
    slot set included): the state, delta and diag within the stated
    tolerance every round, the gate's decisions exactly."""
    series, valid = churned_series(seed)
    cfg = ForecastConfig(min_history=min_history)
    jcfg = JForecastConfig(min_history=min_history)
    t, n = series.shape
    tf = tm.init_forecast_state(cfg.lags, n, device="cpu")
    jf = jm.init_forecast_state(cfg.lags, n)
    step = jax.jit(jm.forecast_step)
    sc = [jnp.float32(v) for v in (jcfg.ridge, jcfg.min_skill, jcfg.min_history, jcfg.decay,
                                   jcfg.fit_decay)]
    predictive = 0
    for i in range(t):
        tf, td, tg = tm.step_with_params(loads_state(series[i], valid[i], cap=2.0), tf,
                                         params(cfg))
        jf, jd, jg = step(j_loads_state(series[i], valid[i], cap=2.0), jf, *sc)
        jd, jg = np.asarray(jd), np.asarray(jg)
        np.testing.assert_allclose(td.numpy(), jd, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(td.numpy() == 0.0, jd == 0.0)
        np.testing.assert_allclose(tg.numpy(), jg, rtol=RTOL, atol=ATOL)
        assert tg[tm.DIAG_TRAINED] == jg[jm.DIAG_TRAINED]
        assert tg[tm.DIAG_FRAC_MODEL] == jg[jm.DIAG_FRAC_MODEL]
        for name in ("history", "count", "prev_model_valid", "prev_valid", "steps"):
            np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                          np.asarray(getattr(jf, name)), err_msg=name)
        for name in ("A", "b", "prev_model_pred", "err_model_sum", "err_persist_sum",
                     "err_rounds"):
            np.testing.assert_allclose(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        predictive += bool((td != 0).any())
    assert predictive > 0


def test_fit_ridge_matches_jax_and_oracle():
    """tests/test_forecast.py:149: the batched fit and its predictions
    against the numpy oracle (the port's copy equal to the JAX package's)
    and against the JAX fit."""
    rng = np.random.default_rng(0)
    series = np.cumsum(rng.normal(0, 0.1, (30, 5)), axis=0)
    mask = rng.random((30, 5)) > 0.15
    X, y, base, w = toracle.difference_windows(series, mask, lags=3)
    for a, b in zip((X, y, base, w), joracle.difference_windows(series, mask, lags=3)):
        np.testing.assert_array_equal(a, b)
    W_t = tm.fit_ridge(X, y, w, 1e-3)
    W_np = toracle.fit_ridge_np(X, y, w, 1e-3)
    np.testing.assert_array_equal(W_np, joracle.fit_ridge_np(X, y, w, 1e-3))
    np.testing.assert_allclose(W_t.numpy(), W_np, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(W_t.numpy(), np.asarray(jm.fit_ridge(X, y, w, 1e-3)),
                               rtol=RTOL, atol=ATOL)
    pred = tm.ridge_predict(W_t, X)
    np.testing.assert_allclose(pred.numpy(), toracle.predict_np(W_np, X), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jm.ridge_predict(jnp.asarray(W_t.numpy()),
                                                                         jnp.asarray(X))),
                               rtol=RTOL, atol=ATOL)


def test_online_step_matches_offline_fit_on_clean_series():
    """tests/test_forecast.py:162: with no forgetting the online statistics
    are the offline windows', so the step's next prediction is the oracle
    fit applied to the final features."""
    rng = np.random.default_rng(1)
    t_steps, n = 18, 4
    series = 0.4 + 0.1 * np.sin(np.arange(t_steps))[:, None] + np.cumsum(
        rng.normal(0, 0.01, (t_steps, n)), axis=0)
    series = np.clip(series, 0.01, None).astype(np.float32)
    cfg = ForecastConfig(lags=2, min_history=5, decay=1.0, fit_decay=1.0)
    fst, _ = replay(series, cfg)
    X, y, _base, w = toracle.difference_windows(series, None, lags=cfg.lags)
    W = toracle.fit_ridge_np(X, y, w, cfg.ridge)
    x_next = np.concatenate([np.diff(series, axis=0)[-cfg.lags:], np.ones((1, n))], axis=0).T
    offline = np.maximum(series[-1] + np.einsum("nf,nf->n", W, x_next), 0.0)
    np.testing.assert_allclose(fst.prev_model_pred.numpy(), offline, rtol=2e-3, atol=2e-4)


def test_eval_forecast_np_equals_jax_oracle():
    """tests/test_forecast.py:188 on the port's oracle, equal to the JAX
    package's numpy twin."""
    rng = np.random.default_rng(2)
    t = np.arange(120)
    series = 0.5 + 0.3 * np.sin(t / 12.0)[:, None] + rng.normal(0, 0.01, (120, 6))
    out = toracle.eval_forecast_np(series, None, lags=2, ridge=1e-3)
    assert out == joracle.eval_forecast_np(series, None, lags=2, ridge=1e-3)
    assert out["windows"] > 0 and out["skill"] > 0.1
    assert out["mae_model"] < out["mae_persistence"]
    lx, ly, lw = toracle.lag_windows(series, None, 3)
    for a, b in zip((lx, ly, lw), joracle.lag_windows(series, None, 3)):
        np.testing.assert_array_equal(a, b)


# ---------------- reactive equivalence ----------------


def static_run(algo, *, seed=3, rounds=6, forecast=None, noise=0.0, registry=None, **kw):
    backend = t_make("mubench", seed, device="cpu")
    if noise:
        backend.load = dataclasses.replace(backend.load, noise_frac=noise)
    backend.inject_imbalance(backend.node_names[0])
    cfg = RescheduleConfig(algorithm=algo, max_rounds=rounds, sleep_after_action_s=0.0,
                           seed=seed, forecast=forecast or ForecastConfig(), **kw)
    return t_run(backend, cfg, device="cpu", registry=registry or MetricsRegistry())


def test_cold_start_bit_identical_to_reactive_car():
    """tests/test_forecast.py:222: an untrained forecaster predicts
    persistence (delta exactly 0.0), so every proactive round equals the
    plain CAR round, and nothing is NaN."""
    pro = static_run("proactive", forecast=ForecastConfig(min_history=100))
    rea = static_run("communication")
    assert len(pro.rounds) == len(rea.rounds) == 6
    for p, r in zip(pro.rounds, rea.rounds):
        for k in DECISIONS:
            assert getattr(p, k) == getattr(r, k), k
        assert p.communication_cost == r.communication_cost
        assert p.load_std == r.load_std
        assert p.forecast is not None and p.forecast["mode"] == "cold"
        assert all(np.isfinite(p.forecast[k]) for k in FC_FLOATS)
        assert r.forecast is None


def test_skill_gate_degrades_to_reactive_decisions():
    """tests/test_forecast.py:242: an unreachable skill floor zeroes the
    applied delta: trained rounds decide as reactive CAR while the shadow
    model keeps being scored."""
    fc = ForecastConfig(min_history=4, min_skill=1.0)
    pro = static_run("proactive", forecast=fc, noise=0.03, rounds=8)
    rea = static_run("communication", noise=0.03, rounds=8)
    assert [p.services_moved for p in pro.rounds] == [r.services_moved for r in rea.rounds]
    modes = {p.forecast["mode"] for p in pro.rounds}
    assert "predictive" not in modes and "degraded" in modes
    assert any(p.forecast["skill"] != 0.0 for p in pro.rounds)


# ---------------- mask twins and state mechanics ----------------


def test_mask_twin_forecast_and_proactive_decide():
    """tests/test_forecast.py:262: padded + masked equals unpadded (padded
    slots carry exactly zero delta), and the predicted-state decision is
    the same on the padded twin; the JAX decision too."""
    rng = np.random.default_rng(4)
    t_steps, n = 8, 3
    series = np.clip(0.4 + np.cumsum(rng.normal(0, 0.05, (t_steps, n)), axis=0), 0.01,
                     None).astype(np.float32)
    cfg = ForecastConfig(lags=2, min_history=5)
    _, outs = replay(series, cfg)
    padded = np.zeros((t_steps, 8), np.float32)
    padded[:, :n] = series
    pvalid = np.zeros((t_steps, 8), bool)
    pvalid[:, :n] = True
    _, pouts = replay(padded, cfg, valid=pvalid)
    for (d, g), (pd, pg) in zip(outs, pouts):
        np.testing.assert_allclose(pd[:n], d, rtol=1e-5, atol=1e-6)
        assert not pd[n:].any()
        np.testing.assert_allclose(pg[tm.DIAG_SKILL], g[tm.DIAG_SKILL], rtol=1e-5, atol=1e-6)

    exact = t_make("mubench", 1, device="cpu")
    exact.inject_imbalance(exact.node_names[0])
    pad_b = t_make("mubench", 1, device="cpu")
    pad_b.set_capacities(node=8, pod=64, service=32)
    pad_b.inject_imbalance(pad_b.node_names[0])
    st, gr = exact.monitor(), exact.comm_graph()
    pst, pgr = pad_b.monitor(), pad_b.comm_graph()
    delta = torch.tensor([120.0, -40.0, 0.0])
    pdelta = torch.zeros(pst.num_nodes)
    pdelta[:3] = delta
    pid = POLICY_IDS["communication"]
    a = decide_with_forecast(st, gr, pid, 30.0, None, delta)
    b = decide_with_forecast(pst, pgr, pid, 30.0, None, pdelta)
    for ai, bi in zip(a[:1] + a[2:], b[:1] + b[2:]):
        assert int(ai) == int(bi)
    jb = j_make("mubench", 1)
    jb.inject_imbalance(jb.node_names[0])
    j = jrl.decide_with_forecast(jb.monitor(), jb.comm_graph(),
                                 jnp.asarray(J_POLICY_IDS["communication"]), jnp.asarray(30.0),
                                 jax.random.PRNGKey(9), jnp.asarray(delta.numpy()))
    for ai, ji in zip(a[:1] + a[2:], j[:1] + j[2:]):
        assert int(ai) == int(ji)


def test_zero_delta_predicted_state_is_identity():
    """tests/test_forecast.py:305."""
    backend = t_make("mubench", 2, device="cpu")
    st, graph = backend.monitor(), backend.comm_graph()
    zero = torch.zeros(st.num_nodes)
    assert torch.equal(predicted_state(st, zero).node_base_cpu, st.node_base_cpu)
    pid = POLICY_IDS["communication"]
    a = decide(st, graph, pid, 30.0)
    b = decide_with_forecast(st, graph, pid, 30.0, None, zero)
    for ai, bi in zip(a, b):
        assert torch.equal(ai, bi)


def test_repad_grows_and_refuses_shrink():
    """tests/test_forecast.py:326."""
    fst = tm.init_forecast_state(2, 4, device="cpu")
    grown = tm.repad_forecast_state(fst, 8)
    assert grown.num_nodes == 8 and grown.lags == 2
    assert grown.A.shape == (8, 3, 3) and grown.b.shape == (8, 3)
    assert not grown.prev_valid[4:].any() and not grown.A[4:].any()
    assert tm.repad_forecast_state(fst, 4) is fst
    with pytest.raises(ValueError, match="shrink"):
        tm.repad_forecast_state(grown, 4)
    with pytest.raises(ValueError):
        tm.init_forecast_state(0, 4, device="cpu")


def test_revalidated_slot_restarts_its_series():
    """tests/test_forecast.py:337: a slot that drains and comes back does
    not inherit its old series; its first predictions are persistence."""
    rng = np.random.default_rng(5)
    t_steps, n = 16, 3
    series = np.clip(0.5 + np.cumsum(rng.normal(0, 0.05, (t_steps, n)), axis=0), 0.01,
                     None).astype(np.float32)
    valid = np.ones((t_steps, n), bool)
    valid[8:11, 2] = False
    fst, outs = replay(series, ForecastConfig(lags=2, min_history=5), valid=valid)
    for i in range(8, 13):
        assert outs[i][0][2] == 0.0
    assert float(fst.count[2]) == t_steps - 11


def test_never_nan_on_pathological_series():
    """tests/test_forecast.py:359, and the JAX step on the same series
    (its delta within the stated tolerance, relative to the 1e6 load)."""
    series = np.zeros((20, 4), np.float32)
    series[:, 1] = 1e6
    series[::2, 2] = 5.0
    cfg = ForecastConfig(lags=2, min_history=4)
    _, outs = replay(series, cfg)
    _, j_outs = j_replay(series, JForecastConfig(lags=2, min_history=4))
    for (d, g), (jd, jg) in zip(outs, j_outs):
        assert np.isfinite(d).all() and np.isfinite(g).all()
        np.testing.assert_allclose(d, jd, rtol=RTOL, atol=ATOL * 1e6)


# ---------------- config and CLI ----------------


def test_forecast_config_validation():
    """tests/test_forecast.py:373, with the JAX package's defaults."""
    assert dataclasses.asdict(ForecastConfig()) == dataclasses.asdict(JForecastConfig())
    ForecastConfig().validate()
    for bad in (dict(lags=0), dict(ridge=0.0), dict(lags=3, min_history=4), dict(decay=0.0),
                dict(fit_decay=1.5), dict(base_policy="global")):
        with pytest.raises(ValueError):
            ForecastConfig(**bad).validate()
    RescheduleConfig(algorithm="proactive").validate()
    with pytest.raises(ValueError, match="moves_per_round"):
        RescheduleConfig(algorithm="proactive", moves_per_round="all").validate()
    with pytest.raises(ValueError, match="placement_unit"):
        RescheduleConfig(algorithm="proactive", placement_unit="pod").validate()
    assert scoring_policy("proactive", ForecastConfig()) == "communication"
    assert scoring_policy("proactive", ForecastConfig(base_policy="spread")) == "spread"
    assert scoring_policy("spread", ForecastConfig()) == "spread"


def test_cli_proactive_smoke(capsys):
    """tests/test_forecast.py:426."""
    assert t_cli.main(["reschedule", "--algorithm", "proactive", "--scenario", "mubench",
                       "--rounds", "2", "--imbalance", "--forecast-lags", "2",
                       "--forecast-min-history", "4", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["algorithm"] == "proactive" and len(out["rounds"]) == 2
    assert out["rounds"][0]["forecast"]["mode"] == "cold"


def test_forecast_metrics_and_record_block():
    """tests/test_forecast.py:487: every proactive record carries a
    JSON-safe forecast block, the families are published once a round, and
    the diag rides the round-end read (no read of its own)."""
    reg = MetricsRegistry()
    res = static_run("proactive", forecast=ForecastConfig(lags=2, min_history=4), rounds=6,
                     noise=0.02, registry=reg)
    assert all(r.forecast is not None for r in res.rounds)
    assert json.loads(json.dumps(res.rounds[-1].as_dict()["forecast"]))
    assert reg.value("forecast_skill", target="node_load") == res.rounds[-1].forecast["skill"]
    assert reg.value("forecast_mae", target="node_load") == res.rounds[-1].forecast["mae_model"]
    modes = [r.forecast["mode"] for r in res.rounds]
    for mode in ("cold", "predictive", "degraded"):
        assert reg.value("forecast_rounds_total", mode=mode) == modes.count(mode)
    assert reg.value("device_transfers_total", site="forecast") == 0
    assert all(r.phase_s["forecast"] == r.decision_latencies_s[0] for r in res.rounds)
    # a direct caller without a closer pays one counted read
    plane = ForecastPlane(ForecastConfig(), registry=reg, device="cpu")
    plane.observe_and_predict(t_make("mubench", 0, device="cpu").monitor())
    assert reg.value("device_transfers_total", site="forecast") == 1
    assert plane.round_info()["mode"] == "cold"


def test_forecast_plane_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ForecastPlane(ForecastConfig())


def test_forecast_body_reads_nothing_back(guarded_bodies):
    """The captured step reads nothing back to the host (a read inside a
    capture fails on the card)."""
    series, valid = churned_series(1, t_steps=6, n=16)
    plane = ForecastPlane(ForecastConfig(min_history=4), device="cpu")
    for i in range(6):
        plane.observe_and_predict(loads_state(series[i], valid[i]), closer=None)
    assert guarded_bodies == ["controller_forecast"] * 6


# ---------------- the proactive loop against the JAX loop ----------------


def jax_deltas(monkeypatch):
    """Record every delta the JAX loop's forecast plane returns, in call
    order (one call a round on a run without skips)."""
    got = []
    real = jplane.ForecastPlane.observe_and_predict

    def record(self, state, *, closer=None):
        delta = real(self, state, closer=closer)
        got.append(np.array(delta))
        return delta

    monkeypatch.setattr(jplane.ForecastPlane, "observe_and_predict", record)
    return got


LOOPS = {
    "mubench": dict(scenario="mubench", rounds=8, noise=0.03, fc=dict(min_history=4)),
    "mubench_k3": dict(scenario="mubench", rounds=8, noise=0.03, fc=dict(min_history=4),
                       kw=dict(moves_per_round=3)),
    "dense_diurnal": dict(scenario="dense", rounds=14, noise=0.05, fc=dict(),
                          churn="diurnal-autoscale"),
}


@pytest.mark.parametrize("case", sorted(LOOPS))
def test_proactive_loop_matches_jax_with_its_deltas(case, monkeypatch):
    """The JAX loop's deltas fed through ``forecast_deltas=``: every round's
    decisions, landings, costs and the forecast block's mode equal the JAX
    loop's (its floats at the stated tolerance), and the port's own deltas
    are the JAX ones within that tolerance."""
    spec = LOOPS[case]
    got = jax_deltas(monkeypatch)
    kw = spec.get("kw", {})
    common = dict(algorithm="proactive", max_rounds=spec["rounds"], sleep_after_action_s=0.0,
                  seed=1, **kw)
    jb, tb = j_make(spec["scenario"], 1), t_make(spec["scenario"], 1, device="cpu")
    for b in (jb, tb):
        b.load = dataclasses.replace(b.load, noise_frac=spec["noise"])
        b.inject_imbalance(b.node_names[0])
    j_extra, t_extra = {}, {}
    if spec.get("churn"):
        j_extra["elastic"] = ElasticConfig(profile=spec["churn"], seed=7)
        t_extra = dict(elastic=spec["churn"], elastic_seed=7)
    j = j_run(jb, JConfig(**common, forecast=JForecastConfig(**spec["fc"]), **j_extra),
              registry=JRegistry(), key=jax.random.PRNGKey(1))
    own = []
    real = tplane.ForecastPlane.observe_and_predict

    def record(self, state, *, closer=None):
        delta = real(self, state, closer=closer)
        own.append(delta.numpy().copy())
        return delta

    monkeypatch.setattr(tplane.ForecastPlane, "observe_and_predict", record)
    t = t_run(tb, RescheduleConfig(**common, forecast=ForecastConfig(**spec["fc"]), **t_extra),
              device="cpu", registry=MetricsRegistry(),
              forecast_deltas=lambda rnd: torch.as_tensor(got[rnd - 1]))
    assert len(t.rounds) == len(j.rounds) == len(got) == spec["rounds"]
    for tr, jr in zip(t.rounds, j.rounds):
        for k in DECISIONS:
            assert getattr(tr, k) == getattr(jr, k), (tr.round, k)
        assert tr.communication_cost == jr.communication_cost, tr.round
        assert tr.load_std == pytest.approx(jr.load_std, rel=1e-6)
        assert tr.churn == jr.churn
        assert tr.forecast["mode"] == jr.forecast["mode"]
        assert tr.forecast["trained"] == jr.forecast["trained"]
        for k in FC_FLOATS:
            assert tr.forecast[k] == pytest.approx(jr.forecast[k], rel=RTOL, abs=ATOL), k
    assert any(r.forecast["mode"] == "predictive" for r in t.rounds)
    for o, g in zip(own, got):
        np.testing.assert_allclose(o, g, rtol=RTOL, atol=ATOL * 2e4)  # millicores


def test_pipelined_proactive_equals_sequential():
    """The pipelined schedule observes the same snapshot each round: its
    records equal the sequential loop's, timing aside."""
    def run(pipeline):
        return static_run("proactive", forecast=ForecastConfig(min_history=4), noise=0.03,
                          rounds=8, pipeline=pipeline)

    seq, pipe = run(False), run(True)
    assert [{k: v for k, v in r.as_dict().items() if k not in TIMING} for r in seq.rounds] == \
           [{k: v for k, v in r.as_dict().items() if k not in TIMING} for r in pipe.rounds]
    assert all(r.pipeline is not None for r in pipe.rounds[1:])


def test_proactive_refused_with_scan_block():
    with pytest.raises(ValueError, match="pinning greedy algorithm"):
        RescheduleConfig(algorithm="proactive", scan_block=4).validate()


# ---------------- acceptance ----------------


def test_acceptance_proactive_vs_reactive_diurnal(monkeypatch):
    """tests/test_forecast.py:583 on the port: on the seeded
    diurnal-autoscale soak proactive's mean cost does not exceed reactive
    CAR's, the trained forecaster beats persistence, every explanation
    re-derives its decision, some rounds are predictive, and the captured
    step keys one graph per state shape: 1 + promotions after round 1."""
    keys = []
    real = compiled.GraphCache.run

    def record(self, fn, key, inputs, make_body, operands=()):
        if fn == "controller_forecast":
            keys.append(compiled.GraphCache._full_key(fn, key, inputs, operands))
        return real(self, fn, key, inputs, make_body, operands)

    monkeypatch.setattr(compiled.GraphCache, "run", record)
    out = run_forecast_headtohead(("diurnal-autoscale",), registry=MetricsRegistry(),
                                  logger_factory=lambda: StructuredLogger(name="h2h"),
                                  device="cpu")
    cell = out["profiles"]["diurnal-autoscale"]
    pro, rea = cell["proactive"], cell["communication"]
    assert pro["rounds"] == rea["rounds"] == 40
    assert pro["mean_communication_cost"] <= rea["mean_communication_cost"] * (1 + 1e-6)
    fc = pro["forecast"]
    assert fc["trained"] and fc["skill"] > 0.0 and fc["mae_model"] < fc["mae_persistence"]
    records = cell["_records"]["proactive"]
    first = records[0].churn["promotions"] if records[0].churn else 0
    final = records[-1].churn["promotions"] if records[-1].churn else 0
    assert len(keys) == 40 and len(set(keys)) == 1 + (final - first)
    expls = [e for r in records for e in r.explanations]
    assert expls and all(explanation_consistent(e) for e in expls)
    assert any(r.forecast["mode"] == "predictive" for r in records)


def test_watchdog_forecast_skill_rule():
    """tests/test_forecast.py:451 on the port's watchdog."""
    from types import SimpleNamespace

    from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TReg
    from kubernetes_rescheduling_tpu_torch.telemetry.watchdog import (
        RULE_FORECAST,
        SLORules,
        Watchdog,
    )

    def rec(forecast=None):
        return SimpleNamespace(decision_latency_s=0.01, communication_cost=1.0,
                               forecast=forecast)

    reg = TReg()
    wd = Watchdog(SLORules(max_retraces=0), registry=reg)
    assert wd.observe_round(rec()) == []
    wd.observe_round(rec({"trained": False, "skill": -1.0}))
    assert RULE_FORECAST not in wd.active
    raised = wd.observe_round(rec({"trained": True, "skill": -0.4, "mode": "degraded",
                                   "mae_model": 0.2, "mae_persistence": 0.1}))
    assert [r["rule"] for r in raised] == [RULE_FORECAST]
    assert not wd.healthy
    wd.observe_round(rec({"trained": True, "skill": 0.2, "mode": "predictive"}))
    assert RULE_FORECAST not in wd.active and wd.healthy
    wd.observe_round(rec({"trained": True, "skill": -0.4, "mode": "degraded"}))
    assert RULE_FORECAST in wd.active
    wd.rebase()
    assert wd.check() == [] and RULE_FORECAST not in wd.active
    assert reg.value("slo_violations_total", rule=RULE_FORECAST) == 2
