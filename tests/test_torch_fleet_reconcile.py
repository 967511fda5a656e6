"""Per-tenant intent ledgers and fleet churn in the port's fleet loop,
against the JAX package's.

- ``TestFleetReconcile.test_per_tenant_ledgers_and_isolation``
  (tests/test_reconcile.py:1259): drift on one tenant is detected and
  repaired by that tenant's ledger only, and the drift gauge is
  tenant-labeled. The JAX case drifts its tenant through the chaos
  backend's ``reconcile`` profile, which waits with ``backends/chaos.py``
  (ROADMAP Queue 1 item 4); here the same drift is another actor's
  ``SimBackend.external_move_random`` between rounds (an ``on_round`` hook,
  seeded), run identically on both packages.
- Fleet churn on a tenant subset (``elastic_tenants``, the JAX package's
  ``ElasticConfig.tenants``; tests/test_fleet_v2.py:607's engines over one
  shared set of buckets): the churned tenant's records equal the JAX
  fleet's, and the other tenants' records equal a run without churn.

Bars: records (decisions, moves, landings, reconcile and churn blocks,
breaker state) exactly equal; cost exactly; load std within rel 1e-6.
"""

import random

import jax
import pytest
from test_torch_controller import DECISIONS
from test_torch_fleet import fleets

from kubernetes_rescheduling_tpu.backends.fleet import FleetBackend as JFleetBackend
from kubernetes_rescheduling_tpu.backends.sim import LoadModel as JLoad
from kubernetes_rescheduling_tpu.backends.sim import SimBackend as JSim
from kubernetes_rescheduling_tpu.bench.fleet import run_fleet_controller as j_run_fleet
from kubernetes_rescheduling_tpu.config import ElasticConfig as JElastic
from kubernetes_rescheduling_tpu.config import FleetConfig as JFleetConfig
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.core import workmodel as jwm
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu_torch.backends.fleet import FleetBackend
from kubernetes_rescheduling_tpu_torch.backends.sim import LoadModel as TLoad
from kubernetes_rescheduling_tpu_torch.backends.sim import SimBackend as TSim
from kubernetes_rescheduling_tpu_torch.bench.fleet import run_fleet_controller as t_run_fleet
from kubernetes_rescheduling_tpu_torch.config import FleetConfig, RescheduleConfig
from kubernetes_rescheduling_tpu_torch.core import workmodel as twm
from kubernetes_rescheduling_tpu_torch.elastic.engine import make_fleet_churn
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry

NAMES = ("t-chaos", "t-clean")


def _backend(package: str, n_nodes: int = 8, seed: int = 1):
    """tests/test_reconcile.py:91's simulator in either package."""
    sim, load, wm, kw = ((JSim, JLoad, jwm, {}) if package == "jax"
                         else (TSim, TLoad, twm, {"device": "cpu"}))
    b = sim(workmodel=wm.mubench_workmodel_c(), node_names=[f"rc{i}" for i in range(n_nodes)],
            node_cpu_cap_m=20_000.0, seed=seed,
            load=load(entry_rps=100.0, cost_per_req_m=8.0, idle_m=50.0), **kw)
    b.inject_imbalance(b.node_names[0])
    return b


def _drift_hook(backend, rounds=(2, 4, 6, 8)):
    """Another actor drifts one seeded-random pod of ``t-chaos`` after the
    given rounds."""
    rng = random.Random(3)

    def on_round(tenant, record, state):
        if tenant == NAMES[0] and record.round in rounds:
            backend.external_move_random(rng)
    return on_round


def _assert_same_records(t_res, j_res, names):
    for name in names:
        tr, jr = t_res.results[name].rounds, j_res.results[name].rounds
        assert len(tr) == len(jr)
        for a, b in zip(tr, jr):
            for k in DECISIONS:
                assert getattr(a, k) == getattr(b, k), (name, a.round, k)
            assert a.reconcile == b.reconcile, (name, a.round)
            assert a.churn == b.churn, (name, a.round)
            assert a.communication_cost == b.communication_cost
            assert a.load_std == pytest.approx(b.load_std, rel=1e-6)


class TestFleetReconcile:
    def test_per_tenant_ledgers_and_isolation(self):
        """Drift on ``t-chaos`` only: that tenant detects and repairs its
        divergences, ``t-clean`` sees none, both converge, and the drift
        gauge is per tenant — equal to the JAX fleet's run."""
        runs = {}
        for package in ("torch", "jax"):
            chaos, clean = _backend(package, seed=1), _backend(package, seed=2)
            kw = dict(algorithm="communication", max_rounds=12, sleep_after_action_s=0.0)
            if package == "torch":
                reg = TRegistry()
                res = t_run_fleet(FleetBackend([chaos, clean], tenant_names=NAMES),
                                  RescheduleConfig(**kw, fleet=FleetConfig(tenants=2)),
                                  device="cpu", registry=reg, on_round=_drift_hook(chaos))
            else:
                reg = JRegistry()
                res = j_run_fleet(JFleetBackend([chaos, clean], tenant_names=NAMES),
                                  JConfig(**kw, fleet=JFleetConfig(tenants=2)),
                                  key=jax.random.PRNGKey(0), registry=reg,
                                  on_round=_drift_hook(chaos))
            runs[package] = (res, reg)
        res, reg = runs["torch"]
        div = {name: [d for rec in r.rounds for d in (rec.reconcile or {}).get("divergences", ())]
               for name, r in res.results.items()}
        assert div["t-chaos"]
        assert div["t-clean"] == []
        repairs = [m for rec in res.results["t-chaos"].rounds
                   for m in (rec.reconcile or {}).get("repairs", ())]
        assert repairs
        for name in NAMES:
            assert reg.value("fleet_reconcile_drift_pods", tenant=name) == 0
        assert "reconcile_drift_pods" not in reg._metrics
        _assert_same_records(res, runs["jax"][0], NAMES)


@pytest.mark.parametrize("algorithm", ["communication", "global"])
def test_fleet_churn_on_a_tenant_subset(algorithm):
    """``steady`` churn on tenant 1 only: tenant 1 churns exactly as in the
    JAX fleet (greedy plane: every record), and tenants 0 and 2 keep the
    records of the run without churn although the shared buckets re-pad
    them."""
    seed = 1
    kw = dict(algorithm=algorithm, max_rounds=8, sleep_after_action_s=0.0, seed=seed,
              global_solver_iters=3)
    _, clean_fleet = fleets(3, seed=seed)
    clean = t_run_fleet(clean_fleet, RescheduleConfig(**kw, fleet=FleetConfig(tenants=3)),
                        device="cpu", registry=TRegistry())
    jf, tf = fleets(3, seed=seed)
    reg = TRegistry()
    churned = t_run_fleet(tf, RescheduleConfig(**kw, fleet=FleetConfig(tenants=3),
                                               elastic="steady", elastic_seed=3,
                                               elastic_tenants=(1,)),
                          device="cpu", registry=reg)
    events = [e for rec in churned.results["tenant1"].rounds for e in (rec.churn or {})
              .get("events", ())]
    assert events
    assert reg.value("churn_events_total", kind=events[0]["kind"]) >= 1
    for name in ("tenant0", "tenant2"):
        a, b = clean.results[name].rounds, churned.results[name].rounds
        assert [r.churn for r in b] == [None] * 8
        for ra, rb in zip(a, b):
            for k in DECISIONS:
                if algorithm == "global" and k in ("objective_before", "objective_after"):
                    # the re-padded solve sums the same terms over more slots
                    assert getattr(ra, k) == pytest.approx(getattr(rb, k), rel=1e-6)
                else:
                    assert getattr(ra, k) == getattr(rb, k), (name, ra.round, k)
            assert ra.communication_cost == rb.communication_cost
    if algorithm == "communication":
        j = j_run_fleet(jf, JConfig(**kw, fleet=JFleetConfig(tenants=3),
                                    elastic=JElastic(profile="steady", seed=3, tenants=(1,))),
                        key=jax.random.PRNGKey(seed), registry=JRegistry())
        _assert_same_records(churned, j, ("tenant0", "tenant1", "tenant2"))


def test_make_fleet_churn_shares_buckets():
    """``make_fleet_churn``: one engine per selected tenant, seeded
    ``elastic_seed + index``, over one shared set of buckets pushed into
    every tenant."""
    _, tf = fleets(3)
    cfg = RescheduleConfig(elastic="steady", elastic_seed=5, elastic_tenants=(0, 2))
    engines = make_fleet_churn(tf, cfg, registry=TRegistry())
    assert sorted(engines) == [0, 2]
    assert engines[0].buckets is engines[2].buckets
    assert [e.seed for e in engines.values()] == [5, 7]
    assert engines[0].capacity_sinks == list(tf.backends)
    assert make_fleet_churn(tf, RescheduleConfig(), registry=TRegistry()) == {}
    with pytest.raises(ValueError, match="out of range"):
        make_fleet_churn(tf, RescheduleConfig(elastic="steady", elastic_tenants=(3,)))
