"""Chaos through the port's three schedules, against the port's sequential
loop and the JAX package's loop on the same seeds.

- tests/test_pipeline.py:163: under the seeded ``soak`` profile the
  breaker opens mid-flight, the pipelined loop drains to the sequential
  path, every round is accounted, and the records equal the sequential
  chaos run's (the backend sees the same call order, so the same faults).
- tests/test_scan.py:323: a chaos wrapper drains every scanned round to the
  per-round path under reason ``"backend"``, bit-identical to the
  sequential chaos run.
- tests/test_reconcile.py:874-975: the ``reconcile`` soak acceptance (the
  JAX package's fast pin, ``communication``), the pipelined reconcile soak
  and the unknown-landing regression under node-flap chaos.
- The deterministic policies (``communication``, ``spread``, ``binpack``,
  ``kubescheduling``) under ``soak`` give the JAX loop's records, fault
  counts, skips and breaker transitions.

Bars: against the port's own loop every record field but timing is equal;
against the JAX loop decisions, moves, landings, skips, breaker
transitions, fault counts and costs are exactly equal and the load std is
within rel 1e-6 (an f32 std whose reductions may run in another order).
"""

import dataclasses
import math

import jax
import pytest
from test_torch_controller import DECISIONS, assert_same_records
from test_torch_sim_device import sim_pair, strip

from kubernetes_rescheduling_tpu.backends.chaos import with_chaos as j_with_chaos
from kubernetes_rescheduling_tpu.bench.controller import run_controller as j_run
from kubernetes_rescheduling_tpu.config import ChaosConfig
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu.utils.retry import RetryPolicy as JRetry
from kubernetes_rescheduling_tpu_torch.backends.chaos import with_chaos as t_with_chaos
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.reconcile import (
    KIND_EXTERNAL_DRIFT,
    KIND_WRONG_NODE,
)
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger as TLogger
from kubernetes_rescheduling_tpu_torch.utils.retry import RetryPolicy as TRetry


def _faults(reg) -> dict:
    m = reg._metrics.get("chaos_faults_total")
    return {} if m is None else {k[0]: c.value for k, c in m._children.items()}


def _j_faults(reg) -> dict:
    return {r["labels"]["kind"]: r["value"] for r in reg.snapshot()
            if r["metric"] == "chaos_faults_total"}


def _total(reg, name: str) -> float:
    """A family's sum over its label children (or its unlabeled value)."""
    m = reg._metrics.get(name)
    if m is None:
        return 0.0
    return sum(c.value for c in m._children.values()) if m.labelnames else m.value


def t_chaos_run(n_nodes, *, rounds, prefix="sn", seed=0, logger=False, backend=None, **cfg):
    """The port's loop on tests/test_scan.py's (or a prefix's) simulator."""
    b = backend if backend is not None else sim_pair(n_nodes, seed=seed, prefix=prefix)[1]
    reg = TRegistry()
    log = TLogger(name="t") if logger else None
    res = t_run(b, TConfig(max_rounds=rounds, sleep_after_action_s=0.0, seed=seed, **cfg),
                device="cpu", registry=reg, logger=log)
    return res, reg, log


def assert_same_run(a, b):
    assert len(a.rounds) == len(b.rounds)
    for ra, rb in zip(a.rounds, b.rounds):
        assert strip(ra) == strip(rb), ra.round
    assert a.skipped_rounds == b.skipped_rounds
    assert a.breaker_transitions == b.breaker_transitions
    assert a.boundary_failures == b.boundary_failures


def test_pipelined_chaos_soak_drains_with_zero_lost_rounds():
    """tests/test_pipeline.py:163: the breaker opens mid-flight, the
    pipeline drains, every round is accounted, and the records equal the
    sequential chaos run's."""
    kw = dict(rounds=18, prefix="pl", chaos="soak", chaos_seed=0,
              retry=TRetry(max_attempts=1), max_consecutive_failures=2)
    seq, seq_reg, _ = t_chaos_run(11, **kw)
    pl, pl_reg, _ = t_chaos_run(11, pipeline=True, **kw)
    assert len(pl.rounds) + pl.skipped_rounds == 18
    assert pl.skipped_rounds == seq.skipped_rounds > 0
    assert "open" in {t["to"] for t in pl.breaker_transitions}
    assert_same_run(seq, pl)
    assert _faults(seq_reg) == _faults(pl_reg)
    # some rounds pipelined, the breaker's drained the rest
    assert 0 < sum(r.pipeline is not None for r in pl.rounds) < len(pl.rounds)


def test_scanned_chaos_drain_soak_bit_identical():
    """tests/test_scan.py:323: a chaos wrapper drains EVERY round to the
    per-round path under ``backend``, bit-identical to the sequential chaos
    run — skips, breaker transitions and records included."""
    kw = dict(rounds=14, chaos="soak", retry=TRetry(max_attempts=1),
              max_consecutive_failures=2)
    seq, _, _ = t_chaos_run(19, **kw)
    sc, reg, _ = t_chaos_run(19, scan_block=4, **kw)
    assert len(sc.rounds) + sc.skipped_rounds == 14
    assert sc.skipped_rounds == seq.skipped_rounds > 0
    assert_same_run(seq, sc)
    assert reg.value("scan_drains_total", reason="backend") == 14
    assert reg.value("scan_blocks_total") == 0


def _rc_pair(n_nodes: int, seed: int = 1):
    """tests/test_reconcile.py:91's simulator in both packages."""
    return sim_pair(n_nodes, seed=seed, prefix="rc")


def test_reconcile_soak_acceptance_communication():
    """tests/test_reconcile.py:874 (``communication``, the JAX package's
    fast pin): 30 rounds under the ``reconcile`` profile never raise; the
    fault counts equal the registry's and every reconcile kind fired; the
    admission guard quarantined, the ledger classified wrong-node and
    external drift and repaired back to zero standing drift; every cost and
    load std is finite; every round is accounted — and the run equals the
    JAX package's (records, reconcile blocks, counters)."""
    jb, tb = _rc_pair(17)
    tchaos = t_with_chaos(tb, "reconcile", seed=3, registry=(treg := TRegistry()))
    res = t_run(tchaos, TConfig(algorithm="communication", max_rounds=30,
                                sleep_after_action_s=0.0, seed=0),
                device="cpu", registry=treg)
    assert len(res.rounds) + res.skipped_rounds == 30
    assert tchaos.fault_counts and _faults(treg) == tchaos.fault_counts
    for kind in ("monitor_corrupt", "external_drift", "move_lost"):
        assert tchaos.fault_counts.get(kind, 0) >= 1, kind
    assert _total(treg, "admission_quarantined_total") >= 1
    seen = {d["kind"] for r in res.rounds for d in (r.reconcile or {}).get("divergences", ())}
    assert {KIND_WRONG_NODE, KIND_EXTERNAL_DRIFT} <= seen
    assert _total(treg, "reconcile_repair_moves_total") >= 1
    assert treg.value("reconcile_drift_pods") == 0
    for r in res.rounds:
        assert math.isfinite(r.communication_cost) and math.isfinite(r.load_std)

    jreg = JRegistry()
    jchaos = j_with_chaos(jb, "reconcile", seed=3, registry=jreg)
    j = j_run(jchaos, JConfig(algorithm="communication", max_rounds=30,
                              sleep_after_action_s=0.0, seed=0),
              key=jax.random.PRNGKey(0), registry=jreg)
    assert_same_records(res, j)
    for a, b in zip(res.rounds, j.rounds):
        assert a.reconcile == b.reconcile, a.round
    assert tchaos.fault_counts == jchaos.fault_counts
    assert tb.events == jb.events


def test_pipelined_reconcile_soak_bit_identical_to_sequential():
    """tests/test_reconcile.py:947: the pipelined schedule under the full
    reconcile fault menu — the same divergences, repairs and records."""
    kw = dict(rounds=12, prefix="rc", seed=1, chaos="reconcile", chaos_seed=3)
    seq, _, _ = t_chaos_run(8, **kw)
    pl, _, _ = t_chaos_run(8, pipeline=True, **kw)
    assert [strip(a) for a in seq.rounds] == [strip(b) for b in pl.rounds]
    assert seq.skipped_rounds == pl.skipped_rounds
    assert any(r.reconcile for r in pl.rounds)


class AutoscaleLanding:
    """tests/test_reconcile.py:965: a wrapper playing the cluster
    autoscaler — the first move lands on a node that joined mid-flight."""

    def __init__(self, inner):
        self.inner = inner
        self.fired = False

    def apply_move(self, move):
        if not self.fired:
            self.fired = True
            self.inner.add_node("autoscaled-x")
            return self.inner.apply_move(dataclasses.replace(move, target_node="autoscaled-x"))
        return self.inner.apply_move(move)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_unknown_landing_regression():
    """tests/test_reconcile.py:955: under node-flap chaos a move lands on a
    node the snapshot does not know; the greedy round counts an
    ``unknown_landing`` divergence and finishes degraded, and the run equals
    the JAX package's."""
    jb, tb = _rc_pair(8)
    tw, jw = AutoscaleLanding(tb), AutoscaleLanding(jb)
    treg = TRegistry()
    res = t_run(tw, TConfig(max_rounds=6, moves_per_round=2, sleep_after_action_s=0.0, seed=0,
                            chaos="node-flap", chaos_seed=2),
                device="cpu", registry=treg)
    assert tw.fired
    assert treg.value("reconcile_divergences_total", kind="unknown_landing") >= 1
    assert res.rounds[0].degraded
    assert len(res.rounds) + res.skipped_rounds == 6
    j = j_run(jw, JConfig(max_rounds=6, moves_per_round=2, sleep_after_action_s=0.0, seed=0,
                          chaos=ChaosConfig(profile="node-flap", seed=2)),
              key=jax.random.PRNGKey(0), registry=JRegistry())
    assert_same_records(res, j)
    assert tb.events == jb.events


@pytest.mark.parametrize("policy", ["communication", "spread", "binpack", "kubescheduling"])
def test_soak_records_match_jax(policy):
    """The deterministic policies under the ``soak`` profile: the JAX loop's
    records, skips, breaker transitions, fault counts and event log."""
    jb, tb = sim_pair(13, seed=2, prefix="ck")
    kw = dict(algorithm=policy, max_rounds=16, sleep_after_action_s=0.0, seed=2,
              max_consecutive_failures=2)
    treg, jreg = TRegistry(), JRegistry()
    t = t_run(tb, TConfig(**kw, chaos="soak", chaos_seed=4, retry=TRetry(max_attempts=1)),
              device="cpu", registry=treg)
    j = j_run(jb, JConfig(**kw, chaos=ChaosConfig(profile="soak", seed=4),
                          retry=JRetry(max_attempts=1)),
              key=jax.random.PRNGKey(2), registry=jreg)
    assert t.skipped_rounds > 0 and any(r.moved for r in t.rounds)
    assert_same_records(t, j)
    for a, b in zip(t.rounds, j.rounds):
        for k in DECISIONS:
            assert getattr(a, k) == getattr(b, k)
        assert a.reconcile == b.reconcile, a.round
    assert _faults(treg) == _j_faults(jreg)
    assert tb.events == jb.events


def test_greedy_wrong_node_landing_is_classified_wrong_node():
    """A wrong-node redirect reaches the record as the landed node, and the
    ledger classifies it ``wrong_node`` (tests/test_reconcile.py's
    classification, through the wrapper)."""
    _, tb = _rc_pair(9)
    res, reg, _ = t_chaos_run(9, rounds=10, backend=tb, chaos="flaky-moves", chaos_seed=1,
                              retry=TRetry(max_attempts=1), max_consecutive_failures=0)
    wrong = [r for r in res.rounds
             if any(d["kind"] == KIND_WRONG_NODE
                    for d in (r.reconcile or {}).get("divergences", ()))]
    assert _faults(reg).get("move_wrong_node", 0) >= 1
    assert wrong
