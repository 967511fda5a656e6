"""The admission guard, the intent ledger and their wiring into the
controller, against the JAX package on the CPU.

Each case of tests/test_reconcile.py's ``TestAdmissionGuard``,
``TestIntentLedger`` and (without chaos, churn, the pipelined schedule or
the watchdog) ``TestControllerReconcile`` is written once over a package
namespace and run on both packages: the case's own assertions hold in each,
and what it observes — classifications, repaired values, counters, issued
repairs, records — is equal between them.
"""

import dataclasses
import random
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu.backends.base import MoveRequest as JMove
from kubernetes_rescheduling_tpu.backends.sim import LoadModel as JLoad
from kubernetes_rescheduling_tpu.backends.sim import SimBackend as JSim
from kubernetes_rescheduling_tpu.bench import admission as jadm
from kubernetes_rescheduling_tpu.bench import reconcile as jrec
from kubernetes_rescheduling_tpu.bench.controller import run_controller as j_run
from kubernetes_rescheduling_tpu.config import ReconcileConfig
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.core import workmodel as jwm
from kubernetes_rescheduling_tpu.elastic.engine import ChurnEngine as JEngine
from kubernetes_rescheduling_tpu.elastic.events import ServiceTeardown as JTeardown
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu_torch.backends.base import MoveRequest as TMove
from kubernetes_rescheduling_tpu_torch.backends.sim import LoadModel as TLoad
from kubernetes_rescheduling_tpu_torch.backends.sim import SimBackend as TSim
from kubernetes_rescheduling_tpu_torch.bench import admission as tadm
from kubernetes_rescheduling_tpu_torch.bench import reconcile as trec
from kubernetes_rescheduling_tpu_torch.bench.controller import RoundRecord as TRecord
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.core import workmodel as twm
from kubernetes_rescheduling_tpu_torch.elastic.engine import ChurnEngine as TEngine
from kubernetes_rescheduling_tpu_torch.elastic.events import ServiceTeardown as TTeardown
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry

FAMILIES = ("admission_quarantined_total", "admission_rejected_total",
            "reconcile_divergences_total", "reconcile_repair_moves_total",
            "reconcile_drift_pods")
TIMING = {"decision_latencies_s", "decision_latency_s", "wall_s", "phase_s"}


def _j_counters(reg) -> dict:
    return {(r["metric"], tuple(sorted(r["labels"].items()))): r["value"]
            for r in reg.snapshot() if r["metric"] in FAMILIES}


def _t_counters(reg) -> dict:
    out = {}
    for name in FAMILIES:
        m = reg._metrics.get(name)
        if m is None:
            continue
        if not m.labelnames:
            out[(name, ())] = m.value
        for key, child in m._children.items():
            out[(name, tuple(sorted(zip(m.labelnames, key))))] = child.value
    return out


def _j_guard(reg, **kw):
    rejects: list[str] = []
    g = jadm.AdmissionGuard(ReconcileConfig(**kw), registry=reg, on_reject=rejects.append)
    g.rejects = rejects
    return g


def _t_guard(reg, **kw):
    rejects: list[str] = []
    g = tadm.AdmissionGuard(**kw, registry=reg, on_reject=rejects.append)
    g.rejects = rejects
    return g


def _j_run(backend, reg, *, rounds, algo="communication", moves_per_round=1, planes=True,
           checkpoint_dir=None):
    cfg = JConfig(algorithm=algo, max_rounds=rounds, moves_per_round=moves_per_round,
                  sleep_after_action_s=0.0, seed=0,
                  reconcile=ReconcileConfig(admission=planes, enabled=planes))
    return j_run(backend, cfg, key=jax.random.PRNGKey(0), registry=reg,
                 checkpoint_dir=checkpoint_dir)


def _t_run(backend, reg, *, rounds, algo="communication", moves_per_round=1, planes=True,
           checkpoint_dir=None):
    cfg = TConfig(algorithm=algo, max_rounds=rounds, moves_per_round=moves_per_round,
                  sleep_after_action_s=0.0, seed=0, reconcile_admission=planes,
                  reconcile_enabled=planes)
    return t_run(backend, cfg, device="cpu", registry=reg, checkpoint_dir=checkpoint_dir)


def _j_churn_run(backend, reg, *, rounds, checkpoint_dir, churn, on_round=None):
    cfg = JConfig(algorithm="communication", max_rounds=rounds, sleep_after_action_s=0.0,
                  seed=3, max_consecutive_failures=2)
    return j_run(backend, cfg, key=jax.random.PRNGKey(3), registry=reg,
                 checkpoint_dir=checkpoint_dir, churn=churn, on_round=on_round)


def _t_churn_run(backend, reg, *, rounds, checkpoint_dir, churn, on_round=None):
    cfg = TConfig(algorithm="communication", max_rounds=rounds, sleep_after_action_s=0.0,
                  seed=3, max_consecutive_failures=2)
    return t_run(backend, cfg, device="cpu", registry=reg, checkpoint_dir=checkpoint_dir,
                 churn=churn, on_round=on_round)


JAX = SimpleNamespace(
    Sim=JSim, Load=JLoad, Move=JMove, workmodel=jwm.mubench_workmodel_c, dev={},
    guard=_j_guard, ledger=lambda reg: jrec.IntentLedger(ReconcileConfig(), registry=reg),
    block=jrec.reconcile_round_block, Registry=JRegistry, counters=_j_counters,
    put=lambda state, **arrays: state.replace(**arrays), run=_j_run, adm=jadm, rec=jrec,
    Engine=JEngine, Teardown=JTeardown, churn_run=_j_churn_run,
)
TORCH = SimpleNamespace(
    Sim=TSim, Load=TLoad, Move=TMove, workmodel=twm.mubench_workmodel_c, dev={"device": "cpu"},
    guard=_t_guard, ledger=lambda reg: trec.IntentLedger(registry=reg),
    block=trec.reconcile_round_block, Registry=TRegistry, counters=_t_counters,
    put=lambda state, **arrays: state.replace(**{
        k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in arrays.items()}),
    run=_t_run, adm=tadm, rec=trec,
    Engine=TEngine, Teardown=TTeardown, churn_run=_t_churn_run,
)


def backend(P, n_nodes: int = 8, seed: int = 1):
    b = P.Sim(workmodel=P.workmodel(), node_names=[f"rc{i}" for i in range(n_nodes)],
              node_cpu_cap_m=20_000.0, seed=seed,
              load=P.Load(entry_rps=100.0, cost_per_req_m=8.0, idle_m=50.0), **P.dev)
    b.inject_imbalance(b.node_names[0])
    return b


def arr(x) -> np.ndarray:
    return np.array(x)


# ---------------- admission: classify -> action -> metric ----------------


def adm_clean_snapshot_returns_same_object(P, reg):
    g = P.guard(reg)
    state = backend(P).monitor()
    assert g.admit(state) is state
    assert g.admit(None) is None
    assert g.take_info() == {}
    return {}


def adm_quarantine_sweep(P, reg):
    g = P.guard(reg)
    b = backend(P)
    baseline = g.admit(b.monitor())
    poisons = {P.adm.REASON_NAN: lambda v: np.nan, P.adm.REASON_INF: lambda v: np.inf,
               P.adm.REASON_NEGATIVE: lambda v: -abs(v) - 1.0}
    rng = random.Random(7)
    infos, outs = [], []
    for _ in range(12):
        field = rng.choice(["pod_cpu", "pod_mem"])
        reason = rng.choice(sorted(poisons))
        state = b.monitor()
        a = arr(getattr(state, field)).copy()
        valid = np.flatnonzero(arr(state.pod_valid))
        hit = rng.sample(list(valid), k=rng.randint(1, 3))
        for i in hit:
            a[i] = poisons[reason](a[i])
        admitted = g.admit(P.put(state, **{field: a}))
        out, good = arr(getattr(admitted, field)), arr(getattr(baseline, field))
        assert np.all(np.isfinite(out)) and np.all(out >= 0.0)
        assert all(out[i] == good[i] for i in hit)
        info = g.take_info()
        assert info == {f"{field}:{reason}": len(hit)}
        infos.append(info)
        outs.append(out.tolist())
        baseline = admitted
    return {"infos": infos, "outs": outs}


def adm_over_capacity_clamps(P, reg):
    g = P.guard(reg)
    b = backend(P)
    g.admit(b.monitor())
    state = b.monitor()
    cap = float(np.max(arr(state.node_cpu_cap)))
    cpu = arr(state.pod_cpu).copy()
    i = int(np.flatnonzero(arr(state.pod_valid))[0])
    cpu[i] = cap * 50.0
    admitted = g.admit(P.put(state, pod_cpu=cpu))
    assert float(arr(admitted.pod_cpu)[i]) == cap
    assert g.take_info() == {f"pod_cpu:{P.adm.REASON_OVER_CAPACITY}": 1}
    return {"cpu": arr(admitted.pod_cpu).tolist()}


def adm_node_field_reuses_last_good(P, reg):
    g = P.guard(reg)
    b = backend(P)
    g.admit(b.monitor())
    state = b.monitor()
    caps = arr(state.node_cpu_cap).copy()
    good = float(caps[2])
    caps[2] = np.nan
    admitted = g.admit(P.put(state, node_cpu_cap=caps))
    assert float(arr(admitted.node_cpu_cap)[2]) == good
    assert g.take_info() == {f"node_cpu_cap:{P.adm.REASON_NAN}": 1}
    return {}


def adm_shrunken_ceiling(P, reg):
    g = P.guard(reg)
    b = backend(P)
    state = b.monitor()
    cpu = arr(state.pod_cpu).copy()
    i = int(np.flatnonzero(arr(state.pod_valid))[0])
    cpu[i] = 18_000.0
    assert g.admit(P.put(state, pod_cpu=cpu)) is not None
    state = b.monitor()
    caps = np.full_like(arr(state.node_cpu_cap), 10_000.0)
    cpu = arr(state.pod_cpu).copy()
    cpu[i] = np.nan
    admitted = g.admit(P.put(state, node_cpu_cap=caps, pod_cpu=cpu))
    assert float(arr(admitted.pod_cpu)[i]) == 10_000.0
    assert g.take_info() == {f"pod_cpu:{P.adm.REASON_NAN}": 1}
    return {"cpu": arr(admitted.pod_cpu).tolist()}


def adm_duplicate_pod_rejects(P, reg):
    g = P.guard(reg)
    state = backend(P).monitor()
    names = list(state.pod_names)
    names[1] = names[0]
    assert g.admit(P.put(state, pod_names=tuple(names))) is None
    assert g.rejects == ["duplicate_pod"]
    return {"rejects": g.rejects, "info": g.take_info()}


def adm_unknown_node_rejects(P, reg):
    g = P.guard(reg)
    state = backend(P).monitor()
    nodes = arr(state.pod_node).copy()
    nodes[0] = state.num_nodes + 3
    assert g.admit(P.put(state, pod_node=nodes)) is None
    assert g.rejects == ["unknown_node"]
    return {"rejects": g.rejects}


def adm_padded_slot_rejects(P, reg):
    g = P.guard(reg)
    state = backend(P).monitor()
    nodes = arr(state.pod_node).copy()
    nodes[0] = state.num_nodes - 1
    assert g.admit(P.put(state, pod_node=nodes, node_names=state.node_names[:-1])) is None
    assert g.rejects == ["unknown_node"]
    return {"rejects": g.rejects}


def adm_quarantine_overflow_rejects(P, reg):
    g = P.guard(reg, max_quarantine_frac=0.25)
    b = backend(P)
    g.admit(b.monitor())
    state = b.monitor()
    cpu = arr(state.pod_cpu).copy()
    valid = np.flatnonzero(arr(state.pod_valid))
    for i in valid[: max(2, int(len(valid) * 0.5))]:
        cpu[i] = np.nan
    assert g.admit(P.put(state, pod_cpu=cpu)) is None
    assert g.rejects == ["quarantine_overflow"]
    return {"rejects": g.rejects}


def adm_sim_name_tuples_are_identity_stable(P, reg):
    b = backend(P)
    s1, s2 = b.monitor(), b.monitor()
    assert s1.pod_names is s2.pod_names and s1.node_names is s2.node_names
    return {}


def adm_sim_name_tuples_follow_a_teardown(P, reg):
    """The teardown half of tests/test_reconcile.py:302: a workload change
    gives the correct tuples (content-compared, no invalidation hook)."""
    b = backend(P)
    s1 = b.monitor()
    svc = b.workmodel.services[0].name
    b.teardown_service(svc)
    s3 = b.monitor()
    assert s3.pod_names != s1.pod_names
    assert all(not p.startswith(f"{svc}-") for p in s3.pod_names)
    return {"pods": list(s3.pod_names)}


def adm_host_arrays_handoff(P, reg):
    g = P.guard(reg)
    b = backend(P)
    state = g.admit(b.monitor())
    arrays = g.host_arrays(state)
    for f in ("pod_valid", "pod_node", "pod_service", "node_valid"):
        np.testing.assert_array_equal(arrays[f], arr(getattr(state, f)))
    assert g.host_arrays(b.monitor()) is None
    led = P.ledger(reg)
    names = b.comm_graph().names
    led.rebase(state, service_names=names)
    assert led.observe(state, service_names=names, host_arrays=arrays)["divergences"] == []
    return {}


# ---------------- the intent ledger ----------------


def _setup_ledger(P, reg):
    b = backend(P)
    led = P.ledger(reg)
    names = b.comm_graph().names
    led.rebase(b.monitor(), service_names=names)
    return b, led, names


class _Boundary:
    def __init__(self, b):
        self.b = b

    def apply_move(self, move):
        return self.b.apply_move(move)


def led_wrong_node_and_lost_move(P, reg):
    b, led, names = _setup_ledger(P, reg)
    pod, svc = b.monitor().pod_names[0], names[0]
    led.record_moves([(svc, pod, "rc3", "rc5")])
    b.apply_move(P.Move(service=svc, pod=pod, target_node="rc5"))
    first = led.observe(b.monitor(), service_names=names)
    assert {d["kind"] for d in first["divergences"]} == {"wrong_node"}
    assert led.drift_pods >= 1
    led.rebase(b.monitor(), service_names=names)
    led.record_moves([(svc, pod, "rc6", "rc6")])
    second = led.observe(b.monitor(), service_names=names)
    assert {d["kind"] for d in second["divergences"]} == {"lost_move"}
    return {"first": first, "second": second, "repairs": led.repairs}


def led_external_drift_repaired(P, reg):
    b, led, names = _setup_ledger(P, reg)
    moved = b.external_move_random(random.Random(3))
    out = led.observe(b.monitor(), service_names=names)
    assert [d["kind"] for d in out["divergences"]] == ["external_drift"]
    issued = led.issue_repairs(_Boundary(b), budget=2)
    assert [r["pod"] for r in issued] == [moved["pod"]]
    after = led.observe(b.monitor(), service_names=names)
    assert after["divergences"] == [] and led.drift_pods == 0
    return {"moved": moved, "out": out, "issued": issued}


def led_repair_budget_and_requeue(P, reg):
    b, led, names = _setup_ledger(P, reg)
    rng = random.Random(5)
    drifted = {b.external_move_random(rng)["pod"] for _ in range(4)}
    led.observe(b.monitor(), service_names=names)
    assert led.drift_pods == len(drifted)

    class Dark:
        calls = 0

        def apply_move(self, move):
            type(self).calls += 1
            return None

    issued = led.issue_repairs(Dark(), budget=2)
    assert len(issued) == 2 and Dark.calls == 2
    assert led.drift_pods == len(drifted)
    assert led.issue_repairs(Dark(), budget=0) == []
    return {"issued": issued, "repairs": led.repairs}


def led_pending_divergence_counted_once(P, reg):
    b, led, names = _setup_ledger(P, reg)
    b.external_move_random(random.Random(7))
    for _ in range(3):
        led.observe(b.monitor(), service_names=names)
    assert led.drift_pods == 1
    led.rebase(b.monitor(), service_names=names)
    pod, svc = b.monitor().pod_names[0], names[0]
    led.record_moves([(svc, pod, "rc3", "rc5")])
    b.apply_move(P.Move(service=svc, pod=pod, target_node="rc5"))
    for _ in range(2):
        led.observe(b.monitor(), service_names=names)
    issued = led.issue_repairs(_Boundary(b), budget=4)
    assert {r["kind"] for r in issued} >= {"wrong_node"}
    return {"issued": issued}


def led_phantom_and_missing_debounce(P, reg):
    b = backend(P)
    led = P.ledger(reg)
    names = b.comm_graph().names
    state = b.monitor()
    led.rebase(state, service_names=names)
    valid = arr(state.pod_valid).copy()
    gone = int(np.flatnonzero(valid)[0])
    valid[gone] = False
    outs = [led.observe(P.put(state, pod_valid=valid), service_names=names)
            for _ in range(2)]
    assert outs[0]["divergences"] == []
    assert [d["kind"] for d in outs[1]["divergences"]] == ["missing_pod"]
    assert state.pod_names[gone] not in led.intent
    outs += [led.observe(b.monitor(), service_names=names) for _ in range(2)]
    assert outs[2]["divergences"] == []
    assert [d["kind"] for d in outs[3]["divergences"]] == ["phantom_pod"]
    assert state.pod_names[gone] in led.intent
    return {"outs": outs}


def led_lost_repair_is_lost_move(P, reg):
    b, led, names = _setup_ledger(P, reg)
    moved = b.external_move_random(random.Random(3))
    led.observe(b.monitor(), service_names=names)

    class Lying:
        def apply_move(self, move):
            return move.target_node

    issued = led.issue_repairs(Lying(), budget=1)
    assert issued[0]["from"] == moved["to"]
    out = led.observe(b.monitor(), service_names=names)
    assert [d["kind"] for d in out["divergences"]] == ["lost_move"]
    assert led.repairs[moved["pod"]]["target"] == moved["from"]
    return {"issued": issued, "out": out}


def led_stale_snapshot_not_rediffed(P, reg):
    b, led, names = _setup_ledger(P, reg)
    s1 = b.monitor()
    led.observe(s1, service_names=names)
    pod, svc = s1.pod_names[0], names[0]
    b.apply_move(P.Move(service=svc, pod=pod, target_node="rc5"))
    led.record_moves([(svc, pod, "rc5", "rc5")])
    assert led.observe(s1, service_names=names)["divergences"] == []
    assert pod in led.moves
    assert led.observe(b.monitor(), service_names=names)["divergences"] == []
    assert led.observe(s1, service_names=names)["divergences"] == []
    return {}


def led_move_meta_survives_missing_debounce(P, reg):
    """A moved pod that is missing for one (debounced) snapshot keeps its
    move's meta: when it shows again on its old node, the move reads as
    lost, not as drift."""
    b = backend(P)
    led = P.ledger(reg)
    names = b.comm_graph().names
    state = b.monitor()
    led.rebase(state, service_names=names)
    pod, svc = state.pod_names[0], names[0]
    led.record_moves([(svc, pod, "rc6", "rc6")])
    valid = arr(state.pod_valid).copy()
    valid[0] = False
    assert led.observe(P.put(state, pod_valid=valid), service_names=names)["divergences"] == []
    out = led.observe(b.monitor(), service_names=names)
    assert [d["kind"] for d in out["divergences"]] == ["lost_move"]
    return {"out": out}


def led_churn_events_consumed_before_drift(P, reg):
    """The same placement change, but a churn event explains the node:
    re-placement after a drain's rescheduling is adopted, not drift."""
    b, led, names = _setup_ledger(P, reg)
    moved = b.external_move_random(random.Random(3))
    out = led.observe(b.monitor(), service_names=names,
                      churn_events=[{"kind": "node_add", "node": moved["to"]}])
    assert out["divergences"] == [] and led.drift_pods == 0
    assert led.intent[moved["pod"]] == moved["to"]
    return {"out": out, "moved": moved}


def _torn_down(P, b, led):
    """A snapshot whose first valid pod disappeared, and its service."""
    state = b.monitor()
    valid = arr(state.pod_valid).copy()
    gone = int(np.flatnonzero(valid)[0])
    valid[gone] = False
    return state, P.put(state, pod_valid=valid), led.pod_service[state.pod_names[gone]]


def led_degraded_round_churn_events_survive(P, reg):
    """A churn event carried by a DEGRADED round waits in the ledger for the
    next fresh diff; dropping it would let the teardown's pods pass the
    debounce and read as missing pods."""
    b, led, names = _setup_ledger(P, reg)
    state, partial, svc = _torn_down(P, b, led)
    block, drift = P.block(None, led, state=state, service_names=names,
                           churn_events=[{"kind": "service_teardown", "service": svc}],
                           fresh=False, last_drift=0, boundary=None, repair_budget=0)
    assert block is None and drift == 0 and led.pending_events
    for _ in range(2):
        block, _ = P.block(None, led, state=partial, service_names=names, churn_events=(),
                           fresh=True, last_drift=0, boundary=None, repair_budget=0)
        assert block is None
    assert led.pending_events == []
    return {"intent": led.intent}


def led_pending_events_survive_checkpoint(P, reg):
    b, led, names = _setup_ledger(P, reg)
    state, partial, svc = _torn_down(P, b, led)
    led.note_churn([{"kind": "service_teardown", "service": svc}])
    led2 = P.ledger(reg)
    led2.restore(led.snapshot())
    assert led2.pending_events == led.pending_events
    outs = [led2.observe(partial, service_names=names) for _ in range(2)]
    assert all(o["divergences"] == [] for o in outs)
    return {"snapshot": led.snapshot(), "outs": outs}


def led_snapshot_restore_roundtrip(P, reg):
    b, led, names = _setup_ledger(P, reg)
    led2 = P.ledger(reg)
    led2.restore(led.snapshot())
    assert led2.intent == led.intent and led2.pod_service == led.pod_service
    moved = b.external_move_random(random.Random(9))
    out = led2.observe(b.monitor(), service_names=names)
    assert [d["kind"] for d in out["divergences"]] == ["external_drift"]
    assert out["divergences"][0]["pod"] == moved["pod"]
    led3 = P.ledger(reg)
    led3.restore(None)
    led3.restore({})
    return {"out": out, "intent": led.intent}


# ---------------- the controller integration ----------------


RECORD_KEYS = [f.name for f in dataclasses.fields(TRecord) if f.name not in TIMING]


def _records(result) -> list[dict]:
    """The records' fields the port carries (the JAX record has more
    planes), timing fields left out."""
    return [{k: getattr(r, k) for k in RECORD_KEYS} for r in result.rounds]


def ctl_clean_run_golden_pin(P, reg):
    on = P.run(backend(P), reg, rounds=12)
    off = P.run(backend(P), P.Registry(), rounds=12, planes=False)
    assert _records(on) == _records(off)
    assert all(r.reconcile is None for r in on.rounds)
    return {"records": _records(on)}


def ctl_admission_reject_degrades(P, reg):
    class DuplicatePodOnce:
        def __init__(self, inner):
            self.inner = inner
            self.calls = 0

        def monitor(self):
            state = self.inner.monitor()
            self.calls += 1
            if self.calls == 3:  # round 2's post-move snapshot
                names = list(state.pod_names)
                names[1] = names[0]
                return state.replace(pod_names=tuple(names))
            return state

        def __getattr__(self, name):
            return getattr(self.inner, name)

    res = P.run(DuplicatePodOnce(backend(P)), reg, rounds=4)
    degraded = [r for r in res.rounds if r.degraded]
    assert len(degraded) == 1
    assert degraded[0].reconcile["admission"] == {"rejected:duplicate_pod": 1}
    assert len(res.rounds) == 4
    return {"records": _records(res)}


def ctl_unknown_landing(P, reg):
    """A move the backend reports on a node the snapshot does not know (a
    node that joined mid-flight): a counted ``unknown_landing``, and the
    round finishes degraded."""

    class UnknownLanding:
        def __init__(self, inner):
            self.inner = inner
            self.fired = False

        def apply_move(self, move):
            landed = self.inner.apply_move(move)
            if not self.fired and landed is not None:
                self.fired = True
                return "autoscaled-x"
            return landed

        def __getattr__(self, name):
            return getattr(self.inner, name)

    wrapped = UnknownLanding(backend(P))
    res = P.run(wrapped, reg, rounds=6, moves_per_round=2)
    assert wrapped.fired and res.rounds[0].degraded
    assert len(res.rounds) + res.skipped_rounds == 6
    return {"records": _records(res)}


def ctl_advisory_override_is_not_drift(P, reg):
    class SchedulerOverride:
        def __init__(self, inner):
            self.inner = inner
            self.overrode = 0

        def apply_move(self, move):
            if move.mechanism == "affinityOnly":
                other = next(n for n in self.inner.node_names if n != move.target_node)
                self.overrode += 1
                return self.inner.apply_move(
                    dataclasses.replace(move, mechanism="nodeSelector", target_node=other))
            return self.inner.apply_move(move)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    wrapped = SchedulerOverride(backend(P))
    res = P.run(wrapped, reg, rounds=6, algo="kubescheduling")
    assert wrapped.overrode > 0
    assert all(r.reconcile is None for r in res.rounds)
    return {"records": _records(res)}


def ctl_checkpoint_resume_reconciles_drift(P, reg, tmp_path):
    sim = backend(P)

    class LiveCluster:
        """The live-cluster surface only: no restore, so a resume must
        trust the ledger, not a rewind."""

        def __init__(self, inner):
            self.monitor = inner.monitor
            self.comm_graph = inner.comm_graph
            self.apply_move = inner.apply_move
            self.advance = inner.advance

    P.run(LiveCluster(sim), reg, rounds=4, checkpoint_dir=str(tmp_path))
    moved = sim.external_move_random(random.Random(0))
    res = P.run(LiveCluster(sim), reg, rounds=6, checkpoint_dir=str(tmp_path))
    assert res.resumed_from_round == 5
    divergences = [d for r in res.rounds for d in (r.reconcile or {}).get("divergences", ())]
    assert any(d["kind"] == "external_drift" and d["pod"] == moved["pod"] for d in divergences)
    state = sim.monitor()
    i = state.pod_names.index(moved["pod"])
    assert state.node_names[int(arr(state.pod_node)[i])] == moved["from"]
    return {"records": _records(res), "moved": moved}


def ctl_skip_round_checkpoint_keeps_churn_events(P, reg, tmp_path):
    """tests/test_reconcile.py:1110: a checkpoint written by a SKIPPED round
    carries churn its preamble applied and no record carried yet; the
    resume restores the debt, the first executed record carries it and the
    ledger consumes it (no missing or phantom pods)."""
    class Flaky:
        def __init__(self, inner):
            self._inner, self.fail = inner, False

        def monitor(self):
            if self.fail:
                raise ConnectionError("monitor window down")
            return self._inner.monitor()

        def __getattr__(self, name):
            return getattr(self._inner, name)

    class TeardownAt:
        def __init__(self, svc, rnd):
            self.svc, self.rnd = svc, rnd

        def events(self, rng, rnd, horizon, view):
            return [P.Teardown(service=self.svc)] if rnd == self.rnd else []

    def engine(svc):
        eng = P.Engine("steady", seed=0, registry=reg)
        eng.profile = TeardownAt(svc, 5)   # fires while the breaker is open
        return eng

    svc = backend(P).comm_graph().names[-1]
    flaky = Flaky(backend(P))

    def arm(rec, _state):
        if rec.round == 2:
            flaky.fail = True   # the post-move monitors fail from round 3

    res = P.churn_run(flaky, reg, rounds=8, checkpoint_dir=str(tmp_path), churn=engine(svc),
                      on_round=arm)
    assert res.skipped_rounds > 0
    resumed = P.churn_run(Flaky(backend(P)), reg, rounds=10, checkpoint_dir=str(tmp_path),
                          churn=engine(svc))
    assert resumed.resumed_from_round == 9 and len(resumed.rounds) == 2
    first = resumed.rounds[0]
    assert any(e["kind"] == "service_teardown" and e["service"] == svc
               for e in (first.churn or {}).get("events", ()))
    return {"records": _records(res) + _records(resumed)}


CASES = [f for name, f in sorted(globals().items())
         if name.startswith(("adm_", "led_", "ctl_")) and callable(f)]


@pytest.mark.parametrize("case", CASES, ids=[f.__name__ for f in CASES])
def test_reconcile_case_matches_jax(case, tmp_path):
    """The case's assertions hold in both packages, and its observations,
    counters included, are equal."""
    seen = []
    for P in (JAX, TORCH):
        reg = P.Registry()
        kw = {"tmp_path": tmp_path / ("jax" if P is JAX else "torch")} \
            if "tmp_path" in case.__code__.co_varnames else {}
        out = case(P, reg, **kw)
        seen.append((out, P.counters(reg)))
    assert seen[1] == seen[0]


def _watchdog_record(reconcile):
    return TRecord(round=1, moved=False, most_hazard=None, service=None, target=None,
                   communication_cost=1.0, load_std=0.0, reconcile=reconcile)


def test_watchdog_reconcile_divergence_rule():
    """tests/test_reconcile.py:1199 on the port's watchdog and records."""
    from kubernetes_rescheduling_tpu_torch.telemetry.watchdog import (
        RULE_RECONCILE,
        SLORules,
        Watchdog,
    )

    reg = TRegistry()
    wd = Watchdog(SLORules(reconcile_max_drift_pods=1), registry=reg)
    assert wd.observe_round(_watchdog_record(None)) == []
    raised = wd.observe_round(_watchdog_record({"drift_pods": 2}))
    assert [v["rule"] for v in raised] == [RULE_RECONCILE]
    assert not wd.healthy
    assert reg.value("slo_violations_total", rule=RULE_RECONCILE) == 1
    assert wd.observe_round(_watchdog_record({"drift_pods": 0})) == []
    assert wd.healthy


def test_watchdog_reconcile_rule_is_per_tenant():
    """tests/test_reconcile.py:1224: a clean tenant's round never clears a
    drifting tenant's violation; only that tenant's convergence does."""
    from kubernetes_rescheduling_tpu_torch.telemetry.watchdog import (
        RULE_RECONCILE,
        SLORules,
        Watchdog,
    )

    reg = TRegistry()
    wd = Watchdog(SLORules(reconcile_max_drift_pods=1), registry=reg)
    raised = wd.observe_round(_watchdog_record({"drift_pods": 3}), tenant="t-drift")
    assert [v["rule"] for v in raised] == [RULE_RECONCILE]
    assert raised[0]["tenant"] == "t-drift"
    assert wd.observe_round(_watchdog_record({"drift_pods": 0}), tenant="t-clean") == []
    assert not wd.healthy
    assert reg.value("slo_violations_total", rule=RULE_RECONCILE) == 1
    assert wd.observe_round(_watchdog_record({"drift_pods": 0}), tenant="t-drift") == []
    assert wd.healthy
