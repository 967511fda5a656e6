"""Fleet observability in the port (``telemetry/fleet_rollup.py``, the
logger's per-tenant ring shares, the fleet scan's rollups), against the JAX
package's (tests/test_fleet_rollup.py:78-808).

Bars: the port's device rollup equals its numpy twin exactly (the same
sort, positions and tie order; sums within rel 1e-6, an f32 sum in another
order) and equals the JAX package's jitted rollup (quantiles, worst values
and indices exactly, sums within rel 1e-6); the host halves (decode,
events, the budget gate, the summary ring, the health block, the logger)
give the JAX package's outputs on the same inputs. In the fleet loop the
rollup events re-derive from the per-tenant records (the JAX test's
oracle and tolerances: rel/abs 1e-5 on values, 1e-4 on sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fleet import fleets

from kubernetes_rescheduling_tpu.telemetry import fleet_rollup as jroll
from kubernetes_rescheduling_tpu.telemetry.registry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu.utils.logging import StructuredLogger as JLogger
from kubernetes_rescheduling_tpu_torch.bench.fleet import run_fleet_controller as t_run_fleet
from kubernetes_rescheduling_tpu_torch.config import FleetConfig, RescheduleConfig
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry
from kubernetes_rescheduling_tpu_torch.telemetry.fleet_rollup import (
    DIMS,
    NUM_DIMS,
    QUANTS,
    TenantSeries,
    TenantSummaryRing,
    decode_rollup,
    fleet_health_block,
    publish_rollup,
    rollup_event,
    rollup_matrix,
    rollup_numpy,
    rollup_size,
)
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger


def tenant_labeled(reg) -> list[str]:
    """Families with a ``tenant`` label that hold any series."""
    return [name for name, m in reg._metrics.items()
            if "tenant" in m.labelnames and m._children]


# ---------------- the device rollup ----------------


@pytest.mark.parametrize("tenants,top_k", [(5, 1), (64, 3), (256, 4)])
def test_rollup_matrix_matches_numpy_twin(tenants, top_k):
    """tests/test_fleet_rollup.py:78, and the JAX package's jitted rollup on
    the same matrix."""
    rng = np.random.default_rng(7 + tenants)
    matrix = rng.uniform(0.0, 100.0, size=(tenants, NUM_DIMS)).astype(np.float32)
    dev = rollup_matrix(torch.from_numpy(matrix), top_k=top_k).numpy()
    host = rollup_numpy(matrix, top_k=top_k)
    jdev = np.asarray(jax.jit(lambda m: jroll.rollup_matrix(m, top_k=top_k))(
        jnp.asarray(matrix)))
    assert dev.shape == host.shape == jdev.shape == (rollup_size(top_k),)
    nq = NUM_DIMS * len(QUANTS)
    sums = slice(nq, nq + NUM_DIMS)
    rest = np.r_[0:nq, nq + NUM_DIMS:dev.size]
    np.testing.assert_array_equal(dev[rest], host[rest])
    np.testing.assert_array_equal(dev[rest], jdev[rest])
    np.testing.assert_allclose(dev[sums], host[sums], rtol=1e-6)
    np.testing.assert_allclose(dev[sums], jdev[sums], rtol=1e-6)


def test_rollup_tie_order_is_lowest_index_first():
    """tests/test_fleet_rollup.py:109."""
    matrix = np.ones((6, NUM_DIMS), np.float32)
    dev = rollup_matrix(torch.from_numpy(matrix), top_k=3).numpy()
    np.testing.assert_array_equal(dev, rollup_numpy(matrix, top_k=3))
    np.testing.assert_array_equal(dev, np.asarray(jroll.rollup_matrix(jnp.asarray(matrix),
                                                                      top_k=3)))
    decoded = decode_rollup(dev, top_k=3)
    assert [r["tenant"] for r in decoded["dims"]["cost"]["worst"]] == [0, 1, 2]


def test_decode_rollup_roundtrip_and_errors():
    """tests/test_fleet_rollup.py:123, and the JAX decode of the same
    vector."""
    matrix = np.arange(4 * NUM_DIMS, dtype=np.float32).reshape(4, NUM_DIMS)
    flat = rollup_numpy(matrix, top_k=2)
    d = decode_rollup(flat, top_k=2)
    assert d == jroll.decode_rollup(flat, top_k=2)
    assert set(d["dims"]) == set(DIMS)
    cost = d["dims"]["cost"]
    assert set(cost["quantiles"]) == set(QUANTS)
    assert cost["quantiles"]["max"] == matrix[:, 0].max()
    assert cost["sum"] == pytest.approx(matrix[:, 0].sum())
    assert cost["worst"][0]["tenant"] == 3
    with pytest.raises(ValueError, match="does not decode"):
        decode_rollup(flat[:-1], top_k=2)


def test_rollup_event_names_tenants():
    """tests/test_fleet_rollup.py:808."""
    matrix = np.zeros((3, NUM_DIMS), np.float32)
    matrix[:, 0] = [1.0, 9.0, 5.0]
    rollup = decode_rollup(rollup_numpy(matrix, top_k=2), top_k=2)
    ev = rollup_event(rollup, ["a", "b", "c"], round=7)
    assert ev == jroll.rollup_event(rollup, ["a", "b", "c"], round=7)
    assert ev["round"] == 7
    assert [w["tenant"] for w in ev["worst"] if w["dim"] == "cost"] == ["b", "c"]


# ---------------- the budget gate and the bounded views ----------------


def test_tenant_series_budget_gate():
    """tests/test_fleet_rollup.py:140."""
    reg = TRegistry()
    under = TenantSeries(reg, tenants=3, budget=4)
    under.counter_inc("fleet_rounds_total", "h", "t0")
    under.gauge_set("fleet_communication_cost", "h", "t0", 5.0)
    assert reg.value("fleet_rounds_total", tenant="t0") == 1
    over = TenantSeries(reg, tenants=5, budget=4)
    assert not over.enabled
    over.counter_inc("fleet_moves_total", "h", "t1")
    over.gauge_set("fleet_load_std", "h", "t1", 1.0)
    assert "fleet_moves_total" not in reg._metrics
    assert reg.value("tenant_series_suppressed_total", family="fleet_moves_total") == 1
    assert reg.value("tenant_series_suppressed_total", family="fleet_load_std") == 1
    assert TenantSeries(reg, tenants=10_000, budget=None).enabled


def test_tenant_summary_ring_bounded_and_lru():
    """tests/test_fleet_rollup.py:163, step for step against the JAX ring."""
    rings = [TenantSummaryRing(cost_window=2, max_tenants=3),
             jroll.TenantSummaryRing(cost_window=2, max_tenants=3)]
    for ring in rings:
        for i in range(5):
            ring.observe(f"t{i}", record={"round": 1, "communication_cost": float(i),
                                          "degraded": False, "moved": True},
                         breaker="closed", drift=i)
        assert len(ring) == 3 and ring.evicted == 2
        assert ring.detail("t0") is None
        d = ring.detail("t4")
        assert d["drift"] == 4 and d["costs"] == [4.0]
        ring.observe("t4", record={"communication_cost": 9.0})
        ring.observe("t4", record={"communication_cost": 8.0})
        assert ring.detail("t4")["costs"] == [9.0, 8.0]
        assert [r["tenant"] for r in ring.overview()] == ["t2", "t3", "t4"]
        ring.observe("t2", skipped=True, breaker="open")
        assert ring.detail("t2")["skipped_rounds"] == 1
        assert ring.overview()[-1]["tenant"] == "t2"
    assert rings[0].overview() == rings[1].overview()
    with pytest.raises(ValueError, match=">= 1"):
        TenantSummaryRing(cost_window=0)


def test_fleet_health_block_budget_gate():
    """tests/test_fleet_rollup.py:187."""
    rows = {f"t{i}": {"breaker": "closed", "rounds": 2, "skipped_rounds": 0,
                      "degraded_rounds": 0} for i in range(4)}
    assert fleet_health_block(rows, budget=4) is rows
    rows["t0"]["breaker"] = "open"
    out = fleet_health_block(rows, budget=3)
    assert out == jroll.fleet_health_block(rows, budget=3)
    assert out["suppressed"] and out["tenants"] == 4
    assert out["breaker_states"] == {"closed": 3, "open": 1}
    assert out["rounds"] == 8
    matrix = np.arange(4 * NUM_DIMS, dtype=np.float32).reshape(4, NUM_DIMS)
    rollup = decode_rollup(rollup_numpy(matrix, top_k=2), top_k=2)
    out = fleet_health_block(rows, budget=3, event=rollup_event(rollup, list(rows)))
    assert out["worst"][0]["tenant"] == "t3"
    assert set(out["quantiles"]) == set(DIMS)


def test_publish_rollup_families():
    """The bounded families a rollup publishes (tests/test_fleet_rollup.py:778's
    family list), with the JAX package's values on the same rollup."""
    matrix = np.random.default_rng(3).uniform(0, 50, size=(8, NUM_DIMS)).astype(np.float32)
    rollup = decode_rollup(rollup_numpy(matrix, top_k=2), top_k=2)
    reg, jreg = TRegistry(), JRegistry()
    publish_rollup(reg, rollup)
    jroll.publish_rollup(jreg, rollup)
    for fam in ("fleet_cost_quantile", "fleet_load_std_quantile", "fleet_drift_quantile"):
        for q in QUANTS:
            assert reg.value(fam, q=q) == jreg.gauge(fam, labelnames=("q",)).labels(q=q).value
    for fam in ("fleet_degraded_tenants", "fleet_skipped_tenants", "fleet_drift_pods"):
        assert reg.value(fam) == jreg.gauge(fam).value
    worst = reg._metrics["fleet_worst_tenant"]
    assert len(worst._children) == 2 * NUM_DIMS
    for dim in DIMS:
        for rank in range(2):
            assert reg.value("fleet_worst_tenant", rank=str(rank), dim=dim) == \
                jreg.gauge("fleet_worst_tenant", labelnames=("rank", "dim")).labels(
                    rank=str(rank), dim=dim).value


# ---------------- the logger's ring shares ----------------


@pytest.mark.parametrize("logger_cls,registry_cls", [(StructuredLogger, TRegistry),
                                                     (JLogger, JRegistry)],
                         ids=["torch", "jax"])
def test_logger_ring_fairness_caps_chatty_tenant(logger_cls, registry_cls):
    """tests/test_fleet_rollup.py:278, on the port's logger and the JAX
    package's (the same records and counts)."""
    reg = registry_cls()
    log = logger_cls(max_records=16, max_records_per_tenant=4, registry=reg)
    for i in range(40):
        log.info("spam", tenant="chatty", i=i)
    log.info("quiet_event", tenant="quiet")
    for i in range(40):
        log.info("spam", tenant="chatty", i=i)
    recs = log.records
    assert sum(1 for r in recs if r.get("tenant") == "chatty") == 4
    assert any(r.get("tenant") == "quiet" for r in recs)
    drops = reg.counter("fleet_events_dropped_total", labelnames=("reason",))
    assert drops.labels(reason="tenant_cap").value == 76
    assert log.dropped_by_tenant["chatty"] == 76
    assert log.dropped_by_tenant["quiet"] == 0


def test_logger_ring_full_evictions_are_counted():
    """tests/test_fleet_rollup.py:299."""
    reg = TRegistry()
    log = StructuredLogger(max_records=4, registry=reg)
    for i in range(4):
        log.info("e", tenant=f"t{i}")
    log.info("no_tenant_event")
    assert reg.value("fleet_events_dropped_total", reason="ring_full") == 1
    assert log.dropped_by_tenant["t0"] == 1
    log.info("another")
    assert reg.value("fleet_events_dropped_total", reason="ring_full") == 2
    # a zero ring keeps nothing, as the JAX package's
    zero = StructuredLogger(max_records=0, registry=reg)
    zero.info("e", tenant="t0")
    assert zero.records == []


# ---------------- rollups in the fleet loop ----------------


def _recompute_matrix(res, rnd: int, tenants: int) -> np.ndarray:
    """tests/test_fleet_rollup.py:472's oracle: the round's matrix from the
    per-tenant records."""
    matrix = np.zeros((tenants, NUM_DIMS), np.float32)
    for i in range(tenants):
        rec = next(r for r in res.results[f"tenant{i}"].rounds if r.round == rnd)
        matrix[i, 0] = rec.communication_cost
        matrix[i, 1] = rec.load_std
        matrix[i, 2] = 1.0 if rec.degraded else 0.0
        matrix[i, 4] = float((rec.reconcile or {}).get("drift_pods") or 0)
    return matrix


def _check_rollup_events(events, res, tenants, top_k):
    assert events
    for ev in events:
        oracle = decode_rollup(rollup_numpy(_recompute_matrix(res, ev["round"], tenants),
                                            top_k=top_k), top_k=top_k)
        for dim in DIMS:
            for q in QUANTS:
                assert ev["quantiles"][dim][q] == pytest.approx(
                    oracle["dims"][dim]["quantiles"][q], rel=1e-5, abs=1e-5)
            assert ev["sums"][dim] == pytest.approx(oracle["dims"][dim]["sum"], rel=1e-4,
                                                    abs=1e-4)
        got = {(w["dim"], w["rank"]): w["value"] for w in ev["worst"]}
        for dim in DIMS:
            for rank, row in enumerate(oracle["dims"][dim]["worst"]):
                assert got[(dim, rank)] == pytest.approx(row["value"], rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("scan", [False, True], ids=["per-round", "scan-block"])
def test_fleet_rollup_acceptance_t256(scan):
    """tests/test_fleet_rollup.py:514 and :561: a 256-tenant fleet over its
    label budget — no tenant-labeled series, the rollup events re-derive
    from the per-tenant records, one counted transfer a round (per round) or
    a block (scanned), and the scanned records equal the per-round ones."""
    tenants, k = 256, 3

    def run(scan_block):
        reg, logger = TRegistry(), StructuredLogger(max_records=4096)
        cfg = RescheduleConfig(algorithm="communication", max_rounds=k,
                               sleep_after_action_s=0.0, fleet=FleetConfig(tenants=tenants),
                               tenant_label_budget=64, scan_block=scan_block)
        res = t_run_fleet(fleets(tenants)[1], cfg, device="cpu", registry=reg, logger=logger)
        return res, reg, logger

    res, reg, logger = run(k if scan else 0)
    assert res.total_rounds == tenants * k
    assert tenant_labeled(reg) == []
    assert reg.value("tenant_series_suppressed_total", family="fleet_rounds_total") == \
        tenants * k
    if scan:
        assert reg.value("scan_blocks_total") == 1
        assert reg.value("device_transfers_total", site="round_end") == 1
        assert reg.value("device_transfers_total", site="fleet_decision") == 0
        ref, _, _ = run(0)
        for name in res.tenants:
            a, b = res.results[name].rounds, ref.results[name].rounds
            assert [(r.round, r.moved, r.service, r.target, r.communication_cost, r.load_std)
                    for r in a] == \
                [(r.round, r.moved, r.service, r.target, r.communication_cost, r.load_std)
                 for r in b]
    else:
        assert reg.value("device_transfers_total", site="fleet_decision") == k
        assert reg.value("device_transfers_total", site="fleet_metrics") == k
    events = [r for r in logger.records if r["event"] == "fleet_rollup"]
    assert len(events) == k
    _check_rollup_events(events, res, tenants, top_k=3)


def test_fleet_rollup_matches_jax_fleet():
    """The port's fleet rollups on the JAX package's fleet run (the same
    tenants and decisions): equal events, cost exactly, load std within
    rel 1e-6."""
    import jax as _jax

    from kubernetes_rescheduling_tpu.bench.fleet import run_fleet_controller as j_run_fleet
    from kubernetes_rescheduling_tpu.config import FleetConfig as JFleetConfig
    from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig

    jf, tf = fleets(4)
    kw = dict(algorithm="communication", max_rounds=3, sleep_after_action_s=0.0)
    jlog, tlog = JLogger(), StructuredLogger()
    j_run_fleet(jf, JConfig(**kw, fleet=JFleetConfig(tenants=4)), key=_jax.random.PRNGKey(0),
                registry=JRegistry(), logger=jlog)
    t_run_fleet(tf, RescheduleConfig(**kw, fleet=FleetConfig(tenants=4)), device="cpu",
                registry=TRegistry(), logger=tlog)
    jev = [r for r in jlog.records if r["event"] == "fleet_rollup"]
    tev = [r for r in tlog.records if r["event"] == "fleet_rollup"]
    assert len(jev) == len(tev) == 3
    for a, b in zip(tev, jev):
        assert a["round"] == b["round"] and a["top_k"] == b["top_k"]
        for dim in DIMS:
            for q in QUANTS:
                assert a["quantiles"][dim][q] == pytest.approx(b["quantiles"][dim][q],
                                                               rel=1e-6)
        assert [(w["dim"], w["rank"], w["tenant"]) for w in a["worst"]] == \
            [(w["dim"], w["rank"], w["tenant"]) for w in b["worst"]]


def test_obs_config_fleet_rollup_validation():
    """tests/test_fleet_rollup.py:726 on the port's flat fields (the SLO's
    ``slo_fleet_tail_frac`` comes with the watchdog, ROADMAP Queue 1 item 4)."""
    RescheduleConfig(tenant_label_budget=0, fleet_rollup_top_k=1).validate()
    with pytest.raises(ValueError, match="tenant_label_budget"):
        RescheduleConfig(tenant_label_budget=-1).validate()
    with pytest.raises(ValueError, match="fleet_rollup_top_k"):
        RescheduleConfig(fleet_rollup_top_k=0).validate()
    with pytest.raises(ValueError, match="elastic tenants"):
        RescheduleConfig(elastic_tenants=(-1,)).validate()


def test_rollup_off_keeps_legacy_metrics():
    """tests/test_fleet_rollup.py:756: with ``fleet_rollup`` off no rollup
    family exists and the round closes on the plain metrics pair."""
    reg = TRegistry()
    cfg = RescheduleConfig(algorithm="communication", max_rounds=2, sleep_after_action_s=0.0,
                           fleet=FleetConfig(tenants=3), fleet_rollup=False)
    res = t_run_fleet(fleets(3)[1], cfg, device="cpu", registry=reg)
    assert not any(name.startswith("fleet_cost_quantile") for name in reg._metrics)
    assert reg.value("device_transfers_total", site="fleet_metrics") == 2
    assert all(r.communication_cost > 0 for res_t in res.results.values()
               for r in res_t.rounds)
