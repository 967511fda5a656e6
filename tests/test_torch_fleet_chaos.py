"""Chaos tenants and the pipelined fleet in the port's fleet loop, against the
port's serial fleet and the JAX package's fleet.

- tests/test_fleet.py:249 and tests/test_fleet_v2.py:469: a seeded ``soak``
  on one tenant leaves every other tenant's records as in a clean run,
  while the chaotic tenant skips rounds, opens its breaker and still
  accounts every round (greedy, dense global and proactive); the greedy
  chaos run equals the JAX fleet's.
- tests/test_fleet_rollup.py:313: the chatty chaotic tenant cannot evict
  the healthy tenants' events from a small shared ring.
- tests/test_pipeline.py:548: under ``pipeline`` the tenants' boundary
  phases run on a worker pool, and each tenant's records equal the serial
  fleet's — greedy, dense global and proactive, with chaos tenants and
  with ``steady`` churn on one tenant — with one ``fleet_decision`` and one
  ``fleet_metrics`` read a round and no capture key of its own; the
  pipelined greedy fleet equals the JAX pipelined fleet.

Bars: against the port's serial fleet or a clean run every record field but
timing is equal; against the JAX fleet decisions, moves, landings, skips,
breaker transitions, reconcile blocks and costs are exactly equal and the
load std is within rel 1e-6 (an f32 std whose reductions may run in another
order).
"""

import threading

import jax
import pytest
from test_torch_controller import DECISIONS
from test_torch_fleet import fleets
from test_torch_sim_device import strip

from kubernetes_rescheduling_tpu.bench.fleet import run_fleet_controller as j_run_fleet
from kubernetes_rescheduling_tpu.config import ChaosConfig, ControllerConfig
from kubernetes_rescheduling_tpu.config import FleetConfig as JFleetConfig
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu.utils.retry import RetryPolicy as JRetry
from kubernetes_rescheduling_tpu_torch.backends.chaos import with_chaos
from kubernetes_rescheduling_tpu_torch.bench.controller import _WALL_MS_BUCKETS
from kubernetes_rescheduling_tpu_torch.bench.fleet import run_fleet_controller as t_run_fleet
from kubernetes_rescheduling_tpu_torch.config import FleetConfig, RescheduleConfig
from kubernetes_rescheduling_tpu_torch.solver import compiled
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger as TLogger
from kubernetes_rescheduling_tpu_torch.utils.retry import RetryPolicy as TRetry

EXTRA = {"communication": {}, "global": {"balance_weight": 0.5, "global_solver_iters": 3},
         "proactive": {"forecast_min_history": 4}}


def _cfg(algo: str, tenants: int, rounds: int, *, chaos: tuple = (), pipeline=False, **kw):
    extra = dict(EXTRA[algo])
    if "forecast_min_history" in extra:
        from kubernetes_rescheduling_tpu_torch.config import ForecastConfig

        extra["forecast"] = ForecastConfig(min_history=extra.pop("forecast_min_history"))
    return RescheduleConfig(
        algorithm=algo, max_rounds=rounds, sleep_after_action_s=0.0,
        retry=TRetry(max_attempts=1, base_delay_s=0.01), max_consecutive_failures=2,
        breaker_cooldown_rounds=2, chaos="soak" if chaos else "none", chaos_seed=5,
        pipeline=pipeline, fleet=FleetConfig(tenants=tenants, chaos_tenants=chaos),
        **extra, **kw)


def _run(algo, tenants, rounds, *, logger=None, registry=None, **kw):
    _, tf = fleets(tenants)
    reg = registry if registry is not None else TRegistry()
    return t_run_fleet(tf, _cfg(algo, tenants, rounds, **kw), device="cpu", registry=reg,
                       logger=logger), reg


def _same_tenant(a, b):
    assert len(a.rounds) == len(b.rounds)
    for ra, rb in zip(a.rounds, b.rounds):
        assert strip(ra) == strip(rb), ra.round
    assert a.skipped_rounds == b.skipped_rounds
    assert a.breaker_transitions == b.breaker_transitions
    assert a.boundary_failures == b.boundary_failures


def test_fleet_chaos_isolation_acceptance():
    """tests/test_fleet.py:249: ``soak`` on tenant 3 leaves tenants 0-2 as in
    a clean run; tenant 3 skips (open breaker), absorbs failures and still
    accounts all 14 rounds; its skips are counted per tenant; and the chaos
    run equals the JAX fleet's."""
    clean, _ = _run("communication", 4, 14)
    chaotic, reg = _run("communication", 4, 14, chaos=(3,))
    for name in ("tenant0", "tenant1", "tenant2"):
        a, b = clean.results[name], chaotic.results[name]
        assert len(a.rounds) == 14 and a.skipped_rounds == 0
        _same_tenant(a, b)
    t3 = chaotic.results["tenant3"]
    assert len(t3.rounds) + t3.skipped_rounds == 14
    assert t3.skipped_rounds > 0 and t3.boundary_failures > 0
    assert any(tr["to"] == "open" for tr in t3.breaker_transitions)
    assert reg.value("fleet_rounds_skipped_total", tenant="tenant3") == t3.skipped_rounds

    jf, _ = fleets(4)
    j = j_run_fleet(jf, JConfig(algorithm="communication", max_rounds=14,
                                sleep_after_action_s=0.0,
                                retry=JRetry(max_attempts=1, base_delay_s=0.01),
                                max_consecutive_failures=2, breaker_cooldown_rounds=2,
                                chaos=ChaosConfig(profile="soak", seed=5),
                                fleet=JFleetConfig(tenants=4, chaos_tenants=(3,))),
                    key=jax.random.PRNGKey(0), registry=JRegistry())
    for name in chaotic.tenants:
        tr, jr = chaotic.results[name], j.results[name]
        assert len(tr.rounds) == len(jr.rounds)
        for a, b in zip(tr.rounds, jr.rounds):
            for k in DECISIONS:
                assert getattr(a, k) == getattr(b, k), (name, a.round, k)
            assert a.reconcile == b.reconcile, (name, a.round)
            assert a.communication_cost == b.communication_cost
            assert a.load_std == pytest.approx(b.load_std, rel=1e-6)
        assert tr.skipped_rounds == jr.skipped_rounds
        assert tr.breaker_transitions == jr.breaker_transitions
        assert tr.boundary_failures == jr.boundary_failures


@pytest.mark.parametrize("algo", ["global", "proactive"])
def test_fleet_new_planes_chaos_isolation(algo):
    """tests/test_fleet_v2.py:469: the isolation pin on the dense global and
    proactive planes — ``soak`` on the last tenant leaves the others as in
    a clean run."""
    clean, _ = _run(algo, 3, 8)
    chaotic, _ = _run(algo, 3, 8, chaos=(2,))
    for name in ("tenant0", "tenant1"):
        a, b = clean.results[name], chaotic.results[name]
        assert len(a.rounds) == 8 and a.skipped_rounds == 0
        _same_tenant(a, b)
    t2 = chaotic.results["tenant2"]
    assert len(t2.rounds) + t2.skipped_rounds == 8
    assert t2.boundary_failures > 0


def test_fleet_chaos_soak_ring_fairness():
    """tests/test_fleet_rollup.py:313: the chaotic tenant's events cannot
    evict the healthy tenants' from a small shared ring; its overflow is
    counted drops, and the loop restores the logger's own settings."""
    logger = TLogger(max_records=24)
    _, reg = _run("communication", 4, 14, chaos=(3,), logger=logger)
    assert logger.max_records_per_tenant == 0 and logger.registry is None
    by_tenant = {}
    for r in logger.records:
        if r.get("tenant"):
            by_tenant.setdefault(r["tenant"], []).append(r)
    for name in ("tenant0", "tenant1", "tenant2"):
        assert by_tenant.get(name), f"{name} evicted from the ring"
    drops = sum(reg.value("fleet_events_dropped_total", reason=r)
                for r in ("tenant_cap", "ring_full"))
    assert drops > 0
    assert sum(logger.dropped_by_tenant.values()) == drops


def _record_keys(monkeypatch) -> list:
    keys = []
    real = compiled.GraphCache.run

    def record(self, fn, key, inputs, make_body, operands=()):
        keys.append(compiled.GraphCache._full_key(fn, key, inputs, operands))
        return real(self, fn, key, inputs, make_body, operands)

    monkeypatch.setattr(compiled.GraphCache, "run", record)
    return keys


@pytest.mark.parametrize("variant", ["chaos", "churn"])
@pytest.mark.parametrize("algo", ["communication", "global", "proactive"])
def test_fleet_pipelined_bit_identical_per_tenant(algo, variant, monkeypatch):
    """tests/test_pipeline.py:548: the pipelined fleet's per-tenant records
    equal the serial fleet's, with chaos on one tenant or ``steady`` churn
    on another; one decision and one metrics read a round in both; the
    pipelined run makes the serial run's capture-cache calls under as many
    keys; the
    round-wall histogram, ``pipeline_depth`` and the overlap ratio move."""
    kw = (dict(chaos=(2,)) if variant == "chaos"
          else dict(elastic="steady", elastic_seed=1, elastic_tenants=(1,)))
    keys = _record_keys(monkeypatch)
    seq, sreg = _run(algo, 4, 6, **kw)
    n_keys = len(keys)
    pl, preg = _run(algo, 4, 6, pipeline=True, **kw)
    assert seq.tenants == pl.tenants
    for name in seq.tenants:
        _same_tenant(seq.results[name], pl.results[name])
    if variant == "chaos":
        assert seq.results["tenant2"].boundary_failures > 0
    else:
        assert any(r.churn for r in pl.results["tenant1"].rounds)
    # the same calls to the capture cache, under as many keys (a key holds
    # the run's own adjacencies by identity, so the runs' keys differ)
    seq_keys, pl_keys = keys[:n_keys], keys[n_keys:]
    assert len(pl_keys) == len(seq_keys) > 0
    assert len(set(pl_keys)) == len(set(seq_keys))
    assert [k[0] for k in pl_keys] == [k[0] for k in seq_keys]
    for reg, res in ((sreg, seq), (preg, pl)):
        executed = len(res.round_wall_s)
        assert reg.value("device_transfers_total", site="fleet_decision") == executed
        assert reg.value("device_transfers_total", site="fleet_metrics") == executed
    hist = preg.histogram("wall_round_ms", labelnames=("mode",),
                          buckets=_WALL_MS_BUCKETS).labels(mode="fleet")
    assert hist.count == len(pl.round_wall_s)
    assert preg.value("pipeline_depth") == 2
    assert sreg.value("pipeline_depth") == 0
    assert len(pl.pipeline_overlap) == len(pl.round_wall_s)
    assert all(0.0 <= r <= 1.0 for r in pl.pipeline_overlap)
    assert seq.pipeline_overlap == []


def test_fleet_pipelined_matches_jax_pipelined():
    """The pipelined greedy fleet (tests/test_pipeline.py:517's run, with a
    chaotic tenant) equals the JAX pipelined fleet tenant by tenant."""
    cfg = dict(algorithm="communication", max_rounds=6, sleep_after_action_s=0.0,
               max_consecutive_failures=2)
    _, tf = fleets(3, seed=2)
    t = t_run_fleet(tf, RescheduleConfig(**cfg, pipeline=True, chaos="soak", chaos_seed=1,
                                         retry=TRetry(max_attempts=1),
                                         fleet=FleetConfig(tenants=3, chaos_tenants=(0,))),
                    device="cpu", registry=TRegistry())
    jf, _ = fleets(3, seed=2)
    j = j_run_fleet(jf, JConfig(**cfg, controller=ControllerConfig(pipeline=True),
                                chaos=ChaosConfig(profile="soak", seed=1),
                                retry=JRetry(max_attempts=1),
                                fleet=JFleetConfig(tenants=3, chaos_tenants=(0,))),
                    key=jax.random.PRNGKey(2), registry=JRegistry())
    for name in t.tenants:
        tr, jr = t.results[name], j.results[name]
        assert len(tr.rounds) == len(jr.rounds)
        for a, b in zip(tr.rounds, jr.rounds):
            for k in DECISIONS:
                assert getattr(a, k) == getattr(b, k), (name, a.round, k)
            assert a.communication_cost == b.communication_cost
            assert a.load_std == pytest.approx(b.load_std, rel=1e-6)
        assert tr.skipped_rounds == jr.skipped_rounds
        assert tr.breaker_transitions == jr.breaker_transitions
    assert tf.backends[1].events == jf.backends[1].events


def test_fleet_chaos_wraps_only_the_chosen_tenants(monkeypatch):
    """``chaos_tenants`` wraps only those tenants, tenant t seeded
    ``chaos_seed + t``; an empty tuple wraps every tenant."""
    from kubernetes_rescheduling_tpu_torch.bench import fleet as fleet_mod

    for chosen, expect in (((1,), {1: 5 + 1}), ((), {0: 5, 1: 6, 2: 7})):
        _, tf = fleets(3)
        wrapped = {}

        def spy(backend, profile, seed=0, registry=None, _w=wrapped, _tf=tf):
            _w[_tf.backends.index(backend)] = seed
            return with_chaos(backend, profile, seed=seed, registry=registry)

        monkeypatch.setattr(fleet_mod, "with_chaos", spy)
        cfg = RescheduleConfig(algorithm="communication", max_rounds=2,
                               sleep_after_action_s=0.0, chaos="flaky-moves", chaos_seed=5,
                               fleet=FleetConfig(tenants=3, chaos_tenants=chosen))
        t_run_fleet(tf, cfg, device="cpu", registry=TRegistry())
        assert wrapped == expect


def test_pipelined_fleet_worker_error_reaches_the_caller():
    """A worker's exception reaches the caller as ``future.result()`` gives
    it (nothing falls back to the serial fleet), and the pool's threads are
    gone when the run ends."""
    _, tf = fleets(3)

    class Boom(RuntimeError):
        pass

    calls = {"n": 0}
    inner = tf.backends[1]
    real_apply = inner.apply_move

    def apply_move(move):
        calls["n"] += 1
        raise Boom("worker failed")

    inner.apply_move = apply_move
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(Boom):
        t_run_fleet(tf, RescheduleConfig(algorithm="communication", max_rounds=3,
                                         sleep_after_action_s=0.0, pipeline=True,
                                         fleet=FleetConfig(tenants=3)),
                    device="cpu", registry=TRegistry())
    inner.apply_move = real_apply
    assert calls["n"] == 1
    assert not [t for t in threading.enumerate()
                if t.name.startswith("krt-fleet") and t.name not in before]


def _counters(reg) -> dict:
    """Every counter series of a registry (label values included)."""
    out = {}
    for name, m in reg._metrics.items():
        if m.kind != "counter":
            continue
        out.update({(name, k): c.value for k, c in m._children.items()} if m.labelnames
                   else {(name, ()): m.value})
    return out


def test_pipelined_fleet_shared_state_under_thread_switching():
    """The workers share the registry, the logger's ring and the tenant
    series gate: 16 chaotic tenants on 8 workers, with the interpreter
    switching threads every microsecond, count every fault, divergence,
    repair and round the serial fleet counts, log the same events per
    tenant, and give the same records (a lost update would break a
    count). The run is bounded by a joined thread's timeout."""
    import sys

    kw = dict(algorithm="communication", max_rounds=5, sleep_after_action_s=0.0,
              chaos="soak", chaos_seed=2, retry=TRetry(max_attempts=1),
              max_consecutive_failures=2)
    runs = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for pipeline in (False, True):
            _, tf = fleets(16)
            reg, log = TRegistry(), TLogger(max_records=100_000)
            box = {}

            def go(tf=tf, reg=reg, log=log, pipeline=pipeline, box=box):
                box["res"] = t_run_fleet(tf, RescheduleConfig(**kw, pipeline=pipeline),
                                         device="cpu", registry=reg, logger=log)

            worker = threading.Thread(target=go)
            worker.start()
            worker.join(timeout=120)
            assert not worker.is_alive() and "res" in box
            runs[pipeline] = (box["res"], reg, log)
    finally:
        sys.setswitchinterval(interval)
    (seq, sreg, slog), (pl, preg, plog) = runs[False], runs[True]
    for name in seq.tenants:
        _same_tenant(seq.results[name], pl.results[name])
    assert _counters(preg) == _counters(sreg)
    assert sum(v for (n, _), v in _counters(preg).items() if n == "chaos_faults_total") > 0

    def per_tenant(log):
        out = {}
        for r in log.records:
            if r.get("tenant"):
                out.setdefault(r["tenant"], []).append(
                    {k: v for k, v in r.items() if k != "ts"})
        return out

    assert per_tenant(plog) == per_tenant(slog)
