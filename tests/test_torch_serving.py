"""The serving plane on both packages: every case of tests/test_serving.py
that needs no ops server, written once over a package namespace and run on
the JAX package and on the port (CPU), plus the port's parity with the JAX
engine.

Bars: the case's own assertions hold in each package; a served placement
equals ``place_one`` and the round's ``choose_node`` on the same snapshot
bit for bit; every batch row equals ``place_one``; the accounting identity
``placed + no_candidate + shed + timed_out == submitted`` is exact; the
port's engine serves the same nodes as the JAX engine for all five
policies (``random`` through the ``gumbel_rows`` seam fed the JAX engine's
``fold_in(PRNGKey(seed), seq)`` rows). Steady state holds one compiled
program: the JAX package counts its traces, the port the distinct capture
keys ``solver/compiled.py`` is asked for (one graph a key on the card).

The ops-server cases (the engine's feeds, ``/healthz``, the
``serving_p99`` rule and its bundle, ``POST /place``) run the same way, at
the bottom. ``test_alibaba_fixture_served_parity`` runs in
tests/test_torch_shadow.py with the replay backend, and
``test_serving_config_from_toml`` in tests/test_torch_report.py with the
other TOML files of the JAX tests.
"""

import dataclasses
import json
import math
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_compiled import guarded_bodies  # noqa: F401 (fixture)

from kubernetes_rescheduling_tpu import config as jconfig
from kubernetes_rescheduling_tpu import serving as jserving
from kubernetes_rescheduling_tpu.bench import harness as jharness
from kubernetes_rescheduling_tpu.bench import loadgen as jloadgen
from kubernetes_rescheduling_tpu.bench import serve as jserve
from kubernetes_rescheduling_tpu.policies import hazard as jhazard
from kubernetes_rescheduling_tpu.policies import scoring as jscoring
from kubernetes_rescheduling_tpu.serving import engine as jengine
from kubernetes_rescheduling_tpu.solver import round_loop as jrl
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu.telemetry import registry as jregistry
from kubernetes_rescheduling_tpu.telemetry import server as jserver
from kubernetes_rescheduling_tpu.telemetry import watchdog as jwatchdog
from kubernetes_rescheduling_tpu_torch import config as tconfig
from kubernetes_rescheduling_tpu_torch import serving as tserving
from kubernetes_rescheduling_tpu_torch.bench import harness as tharness
from kubernetes_rescheduling_tpu_torch.bench import loadgen as tloadgen
from kubernetes_rescheduling_tpu_torch.bench import serve as tserve
from kubernetes_rescheduling_tpu_torch.policies import hazard as thazard
from kubernetes_rescheduling_tpu_torch.policies import scoring as tscoring
from kubernetes_rescheduling_tpu_torch.serving import engine as tengine
from kubernetes_rescheduling_tpu_torch.solver import compiled
from kubernetes_rescheduling_tpu_torch.solver import round_loop as trl
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry
from kubernetes_rescheduling_tpu_torch.telemetry import registry as tregistry
from kubernetes_rescheduling_tpu_torch.telemetry import server as tserver
from kubernetes_rescheduling_tpu_torch.telemetry import watchdog as twatchdog

POLICIES = ["spread", "binpack", "random", "kubescheduling", "communication"]


def jax_row(seed: int, seq: int, n: int) -> torch.Tensor:
    """The ``random`` policy's noise row of the JAX engine's request
    ``seq``: ``gumbel(fold_in(PRNGKey(seed), seq), (N,))``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), seq)
    return torch.tensor(np.asarray(jax.random.gumbel(key, (n,))))


class JaxPkg:
    name = "jax"
    config, serving, engine, serve, loadgen = jconfig, jserving, jengine, jserve, jloadgen
    server, watchdog = jserver, jwatchdog

    def obs(self, **kw):
        return jconfig.ObsConfig(**kw).validate()

    def registry(self):
        return JRegistry()

    def engine_(self, registry, scenario="mubench", **kw):
        kw.setdefault("config", jconfig.ServingConfig())
        return jserving.ServingEngine(jharness.make_backend(scenario, 0), registry=registry,
                                      **kw)

    def metric(self, registry, name, **labels):
        for rec in registry.snapshot():
            if rec["metric"] == name and (rec.get("labels") or {}) == labels:
                return rec.get("value")
        return None

    def stage_labels(self, registry):
        return {(r.get("labels") or {}).get("stage") for r in registry.snapshot()
                if r["metric"] == "serving_request_seconds"}

    def has_family(self, registry, name):
        return any(r["metric"] == name for r in registry.snapshot())

    def kernel_inputs(self, engine, seqs):
        keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), s) for s in seqs])
        return (jnp.asarray(jscoring.POLICY_IDS[engine.policy], jnp.int32),
                jnp.asarray(30.0, jnp.float32), keys)

    def place_one(self, engine, svc, seq):
        pid, thr, keys = self.kernel_inputs(engine, [seq])
        out = jserving.place_one(engine.state, engine.graph, pid, thr,
                                 jnp.asarray(svc, jnp.int32), keys[0])
        return tuple(np.asarray(x) for x in out)

    def place_batch(self, engine, svcs, seqs):
        pid, thr, keys = self.kernel_inputs(engine, seqs)
        out = jserving.place_batch(engine.state, engine.graph, pid, thr,
                                   jnp.asarray(svcs, jnp.int32), keys)
        return tuple(np.asarray(x) for x in out)

    def choose_node(self, engine, svc, seq):
        pid, thr, keys = self.kernel_inputs(engine, [seq])
        guarded = jrl.finite_guard(engine.state)
        _, hazard = jhazard.detect_hazard(guarded, thr)
        return int(jscoring.choose_node(pid, guarded, engine.graph, jnp.asarray(svc, jnp.int32),
                                        hazard, keys[0]))

    def compiled_programs(self):
        return jserving.place_batch.traces()


class TorchPkg:
    name = "torch"
    config, serving, engine, serve, loadgen = tconfig, tserving, tengine, tserve, tloadgen
    server, watchdog = tserver, twatchdog

    def obs(self, **kw):
        return tconfig.RescheduleConfig(**kw).validate()

    def __init__(self):
        self.keys = set()

    def registry(self):
        return TRegistry()

    def engine_(self, registry, scenario="mubench", **kw):
        kw.setdefault("config", tconfig.ServingConfig())
        # the JAX engine's noise stream, so the random policy serves alike
        kw.setdefault("gumbel_rows", lambda seq: jax_row(kw.get("seed", 0), seq,
                                                         len(backend.node_names)))
        backend = tharness.make_backend(scenario, 0, device="cpu")
        return tserving.ServingEngine(backend, registry=registry, device="cpu", **kw)

    def metric(self, registry, name, **labels):
        m = registry._metrics.get(name)
        if m is None:
            return None
        if m.labelnames:
            m = m._children.get(tuple(str(labels[n]) for n in m.labelnames))
        return None if m is None else m.value

    def stage_labels(self, registry):
        m = registry._metrics.get("serving_request_seconds")
        return {k[0] for k in m._children} if m is not None else set()

    def has_family(self, registry, name):
        return name in registry._metrics

    def gumbel(self, engine, seqs):
        if engine.policy != "random":
            return None
        return torch.stack([jax_row(0, s, engine.state.num_nodes) for s in seqs])

    def place_one(self, engine, svc, seq):
        g = self.gumbel(engine, [seq])
        out = tserving.place_one(engine.state, engine.graph, tscoring.POLICY_IDS[engine.policy],
                                 30.0, torch.tensor(svc), None if g is None else g[0])
        return tuple(x.numpy() for x in out)

    def place_batch(self, engine, svcs, seqs):
        out = tserving.place_batch(engine.state, engine.graph,
                                   tscoring.POLICY_IDS[engine.policy], 30.0,
                                   torch.as_tensor(svcs), self.gumbel(engine, seqs))
        return tuple(x.numpy() for x in out)

    def choose_node(self, engine, svc, seq):
        g = self.gumbel(engine, [seq])
        guarded = trl.finite_guard(engine.state)
        _, hazard = thazard.detect_hazard(guarded, 30.0)
        return int(tscoring.choose_node(tscoring.POLICY_IDS[engine.policy], guarded,
                                        engine.graph, torch.tensor(svc), hazard,
                                        None if g is None else g[0]))

    def compiled_programs(self):
        return len(self.keys)


@pytest.fixture(params=["jax", "torch"])
def pkg(request, monkeypatch):
    if request.param == "jax":
        return JaxPkg()
    p = TorchPkg()
    real = compiled.GraphCache.run

    def record(self, fn, key, inputs, make_body, operands=()):
        if fn == "serving_place":
            p.keys.add(compiled.GraphCache._full_key(fn, key, inputs, operands))
        return real(self, fn, key, inputs, make_body, operands)

    monkeypatch.setattr(compiled.GraphCache, "run", record)
    return p


def prestage(engine, services, deadline_ms=0.0):
    """tests/test_serving.py:108: enqueue into a batcher that is not running
    yet (the running flag flipped by hand), from threads, and wait until
    every request is queued or shed."""
    engine._running = True
    threads = []
    for svc in services:
        t = threading.Thread(target=engine.place, args=(svc,),
                             kwargs={"deadline_ms": deadline_ms}, daemon=True)
        t.start()
        threads.append(t)
    deadline = time.time() + 20
    while time.time() < deadline:
        with engine._cond:
            settled = len(engine._queue) + engine.outcomes.get("shed", 0)
        if settled == len(services):
            return threads
        time.sleep(0.005)
    raise AssertionError("prestage never settled")


# ---------------- config surface ----------------


def test_serving_config_validation(pkg):
    """tests/test_serving.py:137."""
    cfg = pkg.config.ServingConfig
    cfg().validate()
    for bad in (dict(max_batch=0), dict(batch_window_ms=-1.0), dict(queue_depth=0),
                dict(deadline_ms=-5.0), dict(window=1), dict(ring=0)):
        with pytest.raises(ValueError):
            cfg(**bad).validate()


def test_serving_config_defaults_match_jax():
    assert (dataclasses.asdict(tconfig.ServingConfig())
            == dataclasses.asdict(jconfig.ServingConfig()))


def test_serving_requires_greedy_algorithm(pkg):
    """tests/test_serving.py:173."""
    cfg = pkg.config.RescheduleConfig(algorithm="global",
                                      serving=pkg.config.ServingConfig(enabled=True))
    with pytest.raises(ValueError, match="serving"):
        cfg.validate()
    pkg.config.RescheduleConfig(serving=pkg.config.ServingConfig(enabled=True)).validate()


def test_engine_rejects_unknown_policy(pkg):
    """tests/test_serving.py:181."""
    with pytest.raises(ValueError, match="unknown serving policy"):
        pkg.engine_(pkg.registry(), policy="nope")


def test_open_loop_arrivals_shape_and_seed(pkg):
    """tests/test_serving.py:189, and the port's offsets equal the JAX
    package's."""
    arr = pkg.loadgen.open_loop_arrivals
    a, b, c = arr(200.0, 500, seed=7), arr(200.0, 500, seed=7), arr(200.0, 500, seed=8)
    assert a.shape == (500,)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert np.all(np.diff(a) >= 0)
    assert abs(np.diff(a).mean() - 1 / 200.0) < 1 / 200.0
    np.testing.assert_array_equal(a, jloadgen.open_loop_arrivals(200.0, 500, seed=7))
    with pytest.raises(ValueError):
        arr(0.0, 10)
    with pytest.raises(ValueError):
        arr(10.0, -1)


# ---------------- serve-vs-batch parity ----------------


@pytest.mark.parametrize("policy", ["communication", "random"])
def test_place_one_matches_choose_node(pkg, policy):
    """tests/test_serving.py:217: the served target is ``choose_node`` on
    the same guarded state."""
    engine = pkg.engine_(pkg.registry(), policy=policy)
    _, target, _ = pkg.place_one(engine, 2, 0)
    assert int(target) == pkg.choose_node(engine, 2, 0)


@pytest.mark.parametrize("policy", ["communication", "random"])
def test_place_batch_rows_bit_identical_to_place_one(pkg, policy):
    """tests/test_serving.py:234: every batch row is the solo decision on
    that row's inputs, bit for bit."""
    engine = pkg.engine_(pkg.registry(), policy=policy)
    n_svc = len(engine.graph.names)
    svcs = [i % n_svc for i in range(6)]
    most_b, target_b, bundle_b = pkg.place_batch(engine, svcs, list(range(6)))
    for i in range(6):
        most_1, target_1, bundle_1 = pkg.place_one(engine, svcs[i], i)
        assert int(most_b[i]) == int(most_1) and int(target_b[i]) == int(target_1)
        np.testing.assert_array_equal(bundle_b[i], bundle_1)


def test_served_decision_matches_solo_kernel(pkg):
    """tests/test_serving.py:256: through the engine, a served request's
    node is ``place_one``'s on the same state and request number."""
    with pkg.engine_(pkg.registry()) as engine:
        svc = engine.graph.names[1]
        result = engine.place(svc)
    assert result.outcome in ("placed", "no_candidate")
    _, target, _ = pkg.place_one(engine, engine._svc_index[svc], result.request_id)
    assert result.node_index == int(target)
    assert set(result.timings_ms) == set(pkg.engine.STAGES)
    assert result.explain["service"] == svc and result.explain["chosen"] == result.node


@pytest.mark.parametrize("policy", POLICIES)
def test_served_placements_equal_jax(policy):
    """The port's engine and the JAX engine serve the same requests to the
    same nodes, with the same explanations' choices (``random``: the JAX
    engine's noise rows through the seam)."""
    services = None
    nodes = {}
    for p in (JaxPkg(), TorchPkg()):
        engine = p.engine_(p.registry(), policy=policy,
                           config=p.config.ServingConfig(max_batch=4, deadline_ms=0.0))
        services = services or [engine.graph.names[i % 7] for i in range(10)]
        threads = prestage(engine, services)
        engine._running = False
        engine.start()
        for t in threads:
            t.join(timeout=30)
        engine.stop()
        results = sorted(engine.ring(), key=lambda e: e["request_id"])
        nodes[p.name] = [(e["request_id"], e["service"], e["node"], e["outcome"])
                         for e in results]
    assert nodes["torch"] == nodes["jax"]
    assert {n for _, _, n, _ in nodes["torch"]} - {None}


# ---------------- snapshot admission ----------------


class RejectGuard:
    def admit(self, state):
        return None


def test_first_rejected_snapshot_raises(pkg):
    """tests/test_serving.py:321."""
    with pytest.raises(RuntimeError, match="admission guard"):
        pkg.engine_(pkg.registry(), guard=RejectGuard())


def test_rejected_refresh_keeps_last_good(pkg):
    """tests/test_serving.py:327."""
    engine = pkg.engine_(pkg.registry())
    good = engine.state
    engine._guard = RejectGuard()
    engine.refresh_snapshot()
    assert engine.state is good


# ---------------- batcher determinism and accounting ----------------


def test_dispatch_count_is_ceil_of_queue_over_max_batch(pkg):
    """tests/test_serving.py:338: a pre-staged queue of 10 drains in exactly
    ceil(10 / 4) dispatches."""
    engine = pkg.engine_(pkg.registry(), config=pkg.config.ServingConfig(
        max_batch=4, queue_depth=64, deadline_ms=0.0))
    threads = prestage(engine, [engine.graph.names[i % 3] for i in range(10)])
    engine.start()
    for t in threads:
        t.join(timeout=30)
    engine.stop()
    assert engine.dispatches == math.ceil(10 / 4)
    assert engine.outcomes.get("placed", 0) + engine.outcomes.get("no_candidate", 0) == 10
    assert engine.submitted == 10
    assert sum(k * v for k, v in engine._batch_sizes.items()) == 10
    assert max(engine._batch_sizes) <= 4


def test_queue_full_sheds_are_counted_exactly(pkg):
    """tests/test_serving.py:362."""
    reg = pkg.registry()
    engine = pkg.engine_(reg, config=pkg.config.ServingConfig(max_batch=8, queue_depth=4,
                                                              deadline_ms=0.0))
    threads = prestage(engine, [engine.graph.names[0]] * 7)
    assert engine.shed_reasons.get("queue_full", 0) == 3
    engine.start()
    for t in threads:
        t.join(timeout=30)
    engine.stop()
    answered = engine.outcomes.get("placed", 0) + engine.outcomes.get("no_candidate", 0)
    assert answered == 4 and engine.outcomes.get("shed", 0) == 3
    assert answered + engine.outcomes["shed"] == engine.submitted == 7
    assert pkg.metric(reg, "serving_shed_total", reason="queue_full") == 3
    assert pkg.metric(reg, "serving_placements_total", outcome="shed") == 3


def test_expired_deadlines_complete_timeout_without_dispatch(pkg):
    """tests/test_serving.py:389: requests whose deadline passed by dequeue
    complete ``timeout`` (outcome and shed reason ``deadline`` alike) and
    take no batch slot."""
    reg = pkg.registry()
    engine = pkg.engine_(reg, config=pkg.config.ServingConfig(max_batch=8, queue_depth=16))
    threads = prestage(engine, [engine.graph.names[0]] * 3, deadline_ms=20.0)
    time.sleep(0.06)
    engine.start()
    for t in threads:
        t.join(timeout=30)
    engine.stop()
    assert engine.outcomes.get("timeout", 0) == 3 and engine.dispatches == 0
    assert pkg.metric(reg, "serving_placements_total", outcome="timeout") == 3
    assert pkg.metric(reg, "serving_shed_total", reason="deadline") == 3
    assert engine.shed_reasons.get("deadline", 0) == 3
    assert engine.summary()["shed"].get("deadline") == 3
    for entry in engine.ring():
        assert entry["outcome"] == "timeout" and entry["shed_reason"] == "deadline"


def test_place_on_stopped_engine_sheds_shutdown(pkg):
    """tests/test_serving.py:420."""
    engine = pkg.engine_(pkg.registry())
    result = engine.place(engine.graph.names[0])
    assert result.outcome == "shed" and result.shed_reason == "shutdown"


def test_place_unknown_service_raises_before_submit(pkg):
    """tests/test_serving.py:483."""
    engine = pkg.engine_(pkg.registry())
    with pytest.raises(ValueError, match="unknown service"):
        engine.place("not-a-service")
    assert engine.submitted == 0


# ---------------- the seeded concurrency soaks ----------------


def soak(pkg, registry, n, rate_rps, max_batch, queue_depth=None):
    engine = pkg.engine_(registry, config=pkg.config.ServingConfig(
        max_batch=max_batch, queue_depth=queue_depth or max(n, 64), deadline_ms=0.0))
    services = list(engine.graph.names)
    with engine:
        engine.place(services[0])  # the first batch compiles (JAX) or captures
        programs0 = pkg.compiled_programs()
        report = pkg.serve.run_serve_soak(engine, services,
                                          pkg.loadgen.open_loop_arrivals(rate_rps, n, seed=0))
    return engine, report, pkg.compiled_programs() - programs0


def test_acceptance_serve_soak_fast(pkg):
    """tests/test_serving.py:512: open-loop arrivals, exact accounting,
    between ceil(N/B) and N dispatches, no new program in steady state."""
    n, max_batch = 24, 4
    engine, report, new_programs = soak(pkg, pkg.registry(), n, 600.0, max_batch)
    assert report["submitted"] == n
    assert report["answered"] + report["shed"] + report["timed_out"] == n
    assert report["placed"] > 0 and report["placements_per_sec"] > 0
    assert report["p99_ms"] >= report["p50_ms"] >= 0
    assert math.ceil(n / max_batch) <= engine.dispatches <= n
    assert new_programs == 0
    summary = engine.summary()
    assert summary["submitted"] == n + 1
    assert summary["count"] > 0 and summary["p99_ms"] >= summary["p50_ms"]
    assert sum(summary["outcomes"].values()) == n + 1


def test_serve_soak_long(pkg):
    """tests/test_serving.py:539 (200 requests at 800 rps)."""
    n = 200
    engine, report, new_programs = soak(pkg, pkg.registry(), n, 800.0, 8)
    assert report["answered"] + report["shed"] + report["timed_out"] == n
    assert engine.dispatches <= n
    assert new_programs == 0
    assert report["placements_per_sec"] > 0


def test_serve_soak_overload_counts_shedding(pkg):
    """tests/test_serving.py:549: a tiny queue and a tight deadline under a
    hot rate shed visibly and still account exactly."""
    engine = pkg.engine_(pkg.registry(), config=pkg.config.ServingConfig(
        max_batch=2, queue_depth=2, deadline_ms=5.0))
    services = list(engine.graph.names)
    n = 120
    with engine:
        engine.place(services[0], deadline_ms=0.0)
        report = pkg.serve.run_serve_soak(engine, services,
                                          pkg.loadgen.open_loop_arrivals(3000.0, n, seed=1),
                                          deadline_ms=5.0)
    assert report["answered"] + report["shed"] + report["timed_out"] == n
    assert report["shed"] + report["timed_out"] > 0
    for reason, count in report["shed_reasons"].items():
        assert reason in ("queue_full", "deadline") and count > 0


# ---------------- metrics and the ring ----------------


def test_serving_metrics_families(pkg):
    """tests/test_serving.py:578."""
    reg = pkg.registry()
    with pkg.engine_(reg) as engine:
        engine.place(engine.graph.names[0])
    assert pkg.stage_labels(reg) == set(pkg.engine.STAGES)
    assert (pkg.metric(reg, "serving_placements_total", outcome="placed")
            or pkg.metric(reg, "serving_placements_total", outcome="no_candidate"))
    assert pkg.has_family(reg, "serving_batch_size")
    assert pkg.has_family(reg, "serving_inflight")


def test_ring_is_bounded_and_carries_outcomes(pkg):
    """tests/test_serving.py:615."""
    engine = pkg.engine_(pkg.registry(), config=pkg.config.ServingConfig(ring=4,
                                                                         deadline_ms=0.0))
    with engine:
        for i in range(6):
            engine.place(engine.graph.names[i % 3])
    ring = engine.ring()
    assert len(ring) == 4 and [e["request_id"] for e in ring] == [2, 3, 4, 5]
    for e in ring:
        assert e["outcome"] in ("placed", "no_candidate") and "total_ms" in e


# ---------------- the port's own surface ----------------


def test_engine_refuses_ops_hooks():
    """The engine no longer refuses an ops plane: it feeds the plane its
    summary and ring after every dispatched batch and admission shed,
    never while holding its own condition lock."""
    seen = []

    class Plane:
        def observe_serving(self, summary, requests=None):
            assert not engine._cond._is_owned()
            seen.append((summary["outcomes"], len(requests)))

    engine = tserving.ServingEngine(tharness.make_backend("mubench", 0, device="cpu"),
                                    device="cpu", ops=Plane())
    with engine:
        engine.place(engine.graph.names[0])
    assert seen and seen[-1][0].get("placed", 0) + seen[-1][0].get("no_candidate", 0) == 1


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserving.ServingEngine(tharness.make_backend("mubench", 0, device="cpu"))


@pytest.mark.parametrize("policy", ["communication", "random"])
def test_serving_body_reads_nothing_back(guarded_bodies, policy):
    """The batch body reads nothing back to the host (a read inside a
    capture fails on the card); one read a batch, counted."""
    reg = TRegistry()
    engine = TorchPkg().engine_(reg, policy=policy,
                                config=tconfig.ServingConfig(max_batch=4, deadline_ms=0.0))
    threads = prestage(engine, [engine.graph.names[i] for i in range(6)])
    engine._running = False
    engine.start()
    for t in threads:
        t.join(timeout=30)
    engine.stop()
    assert guarded_bodies == ["serving_place"] * 2
    assert reg.value("device_transfers_total", site="serving") == 2


def test_accounting_holds_under_thread_switching():
    """More submitting threads than cores and the interpreter switching
    threads every microsecond: every request resolves to exactly one
    counted outcome, in the engine's counts and in the registry's (a lost
    update would break the identity)."""
    reg = TRegistry()
    engine = TorchPkg().engine_(reg, config=tconfig.ServingConfig(max_batch=4, queue_depth=16,
                                                                  deadline_ms=2.0))
    n = 300
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with engine:
            report = tserve.run_serve_soak(engine, list(engine.graph.names),
                                           tloadgen.open_loop_arrivals(5000.0, n, seed=3))
    finally:
        sys.setswitchinterval(prev)
    assert engine._thread is None
    assert report["answered"] + report["shed"] + report["timed_out"] == n
    assert engine.submitted == n and sum(engine.outcomes.values()) == n
    counted = sum(reg.value("serving_placements_total", outcome=o)
                  for o in ("placed", "no_candidate", "shed", "timeout"))
    assert counted == n
    assert sum(engine.shed_reasons.values()) == report["shed"] + report["timed_out"]


# ---------------- the ops-server cases ----------------


def _get(port, path):
    """(status, body bytes, headers) without raising on non-200."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _post(port, path, payload=None, raw=None):
    import json as json_mod
    import urllib.error
    import urllib.request

    data = raw if raw is not None else json_mod.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


class _CondProbeOps:
    """An ops stub that checks from ANOTHER thread whether the engine's
    _cond is held while observe_serving runs."""

    def __init__(self, engine):
        self._engine = engine
        self.cond_held_during_feed: list[bool] = []

    def observe_serving(self, summary, requests=None):
        got: list[bool] = []

        def probe():
            acquired = self._engine._cond.acquire(timeout=2)
            if acquired:
                self._engine._cond.release()
            got.append(acquired)

        t = threading.Thread(target=probe)
        t.start()
        t.join(timeout=10)
        self.cond_held_during_feed.append(not got[0])


def test_admission_shed_feeds_ops_after_releasing_cond(pkg):
    reg = pkg.registry()
    engine = pkg.engine_(reg, config=pkg.config.ServingConfig(max_batch=8, queue_depth=1))
    probe = engine.ops = _CondProbeOps(engine)
    svc = engine.graph.names[0]
    assert engine.place(svc).shed_reason == pkg.engine.SHED_SHUTDOWN
    engine._running = True
    t = threading.Thread(target=engine.place, args=(svc,), daemon=True)
    t.start()
    deadline = time.time() + 10
    while time.time() < deadline:
        with engine._cond:
            if len(engine._queue) == 1:
                break
        time.sleep(0.005)
    else:
        raise AssertionError("the queued request never landed")
    assert engine.place(svc).shed_reason == pkg.engine.SHED_QUEUE_FULL
    assert probe.cond_held_during_feed == [False, False]
    engine.start()
    t.join(timeout=30)
    engine.stop()


def test_serving_exposition_micro_buckets_conformant(pkg):
    from test_torch_ops_plane import assert_exposition_conformant

    reg = pkg.registry()
    with pkg.engine_(reg) as engine:
        engine.place(engine.graph.names[0])
    text = reg.expose()
    assert_exposition_conformant(text)
    micro = (jregistry if pkg.name == "jax" else tregistry).MICRO_BUCKETS
    assert text.count("serving_request_seconds_bucket{") == \
        len(pkg.engine.STAGES) * (len(micro) + 1)
    assert 'le="5e-05"' in text


def _summary(count, p99_ms):
    return {"submitted": count, "completed": count, "count": count, "rate_rps": 10.0,
            "p50_ms": p99_ms / 2, "p95_ms": p99_ms, "p99_ms": p99_ms,
            "batch_sizes": {"1": count}, "dispatches": count, "outcomes": {"placed": count},
            "shed": {}, "inflight": 0}


def test_healthz_serving_p99_flip_and_recover(pkg, tmp_path):
    reg = pkg.registry()
    ops = pkg.server.OpsPlane.from_config(pkg.obs(serve_port=0, slo_serving_p99_ms=50.0),
                                          registry=reg, bundle_dir=str(tmp_path)).start()
    try:
        port = ops.server.port
        assert _get(port, "/healthz")[0] == 200
        ops.observe_serving(_summary(count=8, p99_ms=120.0),
                            requests=[{"request_id": 7, "outcome": "placed"}])
        status, body, _ = _get(port, "/healthz")
        assert status == 503
        doc = json.loads(body)
        assert doc["status"] == "unhealthy" and doc["serving"]["p99_ms"] == 120.0
        active = {v["rule"]: v for v in doc["slo"]["active"]}
        assert active["serving_p99"]["threshold_ms"] == 50.0
        bundles = list(tmp_path.glob("*serving_p99*"))
        assert bundles
        payload = json.loads(bundles[0].read_text())
        assert payload["serving"]["p99_ms"] == 120.0
        assert payload["requests"][0]["request_id"] == 7
        ops.observe_serving(_summary(count=8, p99_ms=4.0))
        status, body, _ = _get(port, "/healthz")
        assert status == 200 and json.loads(body)["serving"]["p99_ms"] == 4.0
        ops.watchdog.rebase()
        ops.observe_serving(_summary(count=2, p99_ms=500.0))
        assert _get(port, "/healthz")[0] == 200
    finally:
        ops.close()


def test_round_and_serving_watchdog_feeds_are_serialized(pkg):
    reg = pkg.registry()
    wd = pkg.watchdog.Watchdog(pkg.watchdog.SLORules(
        window=8, min_samples=2, latency_p95_s=10.0, max_retraces=0, serving_p99_ms=1000.0),
        registry=reg)
    ops = pkg.server.OpsPlane(registry=reg, watchdog=wd)
    rounds_n = serve_n = 150
    errors = []

    def round_feeder():
        import types

        rec = types.SimpleNamespace(decision_latency_s=0.01, communication_cost=10.0,
                                    degraded=False, round=1)
        for _ in range(rounds_n):
            try:
                ops.observe_round(rec)
            except Exception as e:  # noqa: BLE001 — the test's verdict
                errors.append(e)

    def serve_feeder():
        for _ in range(serve_n):
            try:
                ops.observe_serving(_summary(count=8, p99_ms=5.0))
            except Exception as e:  # noqa: BLE001
                errors.append(e)

    threads = [threading.Thread(target=round_feeder), threading.Thread(target=serve_feeder),
               threading.Thread(target=serve_feeder)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert errors == []
    assert ops.health.rounds == rounds_n and ops.health.serving["p99_ms"] == 5.0
    assert wd.healthy


def test_breaker_bundle_carries_serving_ring(pkg, tmp_path):
    reg = pkg.registry()
    ops = pkg.server.OpsPlane.from_config(pkg.obs(), registry=reg, bundle_dir=str(tmp_path))
    engine = pkg.engine_(reg)
    with engine:
        engine.place(engine.graph.names[0])
    ops.bind_serving(engine)
    assert engine.ops is ops
    ops.on_breaker_transition({"to": "open", "from": "closed"})
    bundles = list(tmp_path.glob("*breaker*"))
    assert bundles
    ring = json.loads(bundles[0].read_text()).get("serving_requests")
    assert ring and ring[-1]["outcome"] in (pkg.engine.OUTCOME_PLACED,
                                            pkg.engine.OUTCOME_NO_CANDIDATE)


def _served_plane(pkg):
    reg = pkg.registry()
    ops = pkg.server.OpsPlane.from_config(pkg.obs(serve_port=0), registry=reg)
    engine = pkg.engine_(reg).start()
    ops.bind_serving(engine)
    ops.start()
    return reg, ops, engine


def test_post_place_endpoint_roundtrip(pkg):
    reg, ops, engine = _served_plane(pkg)
    try:
        port = ops.server.port
        svc = engine.graph.names[0]
        status, body, _ = _post(port, "/place", {"service": svc})
        assert status == 200
        doc = json.loads(body)
        assert doc["service"] == svc
        assert doc["outcome"] in (pkg.engine.OUTCOME_PLACED, pkg.engine.OUTCOME_NO_CANDIDATE)
        assert set(doc["timings_ms"]) == set(pkg.engine.STAGES)
        assert doc["explain"]["policy"] == "communication"
        if doc["outcome"] == pkg.engine.OUTCOME_PLACED:
            assert doc["node"] in engine._node_names
            assert doc["explain"]["chosen"] == doc["node"]
        status, body, _ = _get(port, "/healthz")
        assert status == 200 and json.loads(body)["serving"]["submitted"] >= 1
        status, body, _ = _post(port, "/place", {"service": "nope"})
        assert status == 400 and "unknown service" in json.loads(body)["error"]
        assert _post(port, "/place", {"deadline_ms": 5})[0] == 400
        status, body, _ = _post(port, "/place", {"service": svc, "deadline_ms": [1]})
        assert status == 400 and "deadline_ms" in json.loads(body)["error"]
        assert _post(port, "/place", {"service": svc, "deadline_ms": "soon"})[0] == 400
        assert _post(port, "/place", payload=[1, 2])[0] == 400
        assert _post(port, "/place", raw=b"{not json")[0] == 400
        assert _post(port, "/nope", {"service": svc})[0] == 404
        status, _, headers = _get(port, "/place")
        assert status == 405 and headers.get("Allow") == "POST"
    finally:
        ops.close()
        engine.stop()


def test_post_place_without_engine_is_503(pkg):
    srv = pkg.server.OpsServer(port=0, registry=pkg.registry())
    srv.start()
    try:
        status, body, _ = _post(srv.port, "/place", {"service": "s0"})
        assert status == 503 and "no serving engine" in json.loads(body)["error"]
    finally:
        srv.stop()


def test_http_request_cardinality_stays_bounded(pkg):
    reg, ops, engine = _served_plane(pkg)
    try:
        port = ops.server.port
        svc = engine.graph.names[0]
        for path in ("/", "/metrics", "/healthz", "/events", "/tenants", "/tenants/acme",
                     "/tenants/zebra", "/favicon.ico", "/admin/.env", "/place",
                     "/wp-login.php"):
            _get(port, path)
        _post(port, "/place", {"service": svc})
        _post(port, "/place", {"service": svc})
        _post(port, "/evil", {"service": svc})
        seen = {(rec.get("labels") or {}).get("endpoint") for rec in reg.snapshot()
                if rec["metric"] == "ops_http_requests_total"}
        assert seen == {"/", "/metrics", "/healthz", "/events", "/tenants", "/tenants/<name>",
                        "/place", "<other>"}
        assert pkg.metric(reg, "ops_http_requests_total", endpoint="/place") == 3
    finally:
        ops.close()
        engine.stop()


def test_metrics_scrape_does_not_block_place(pkg):
    reg, ops, engine = _served_plane(pkg)
    try:
        port = ops.server.port
        svc = engine.graph.names[0]
        _post(port, "/place", {"service": svc})
        with ops.server._read_lock:  # a scrape stuck mid-exposition
            assert _post(port, "/place", {"service": svc})[0] == 200
            assert _get(port, "/healthz")[0] == 200
    finally:
        ops.close()
        engine.stop()


def test_post_place_served_nodes_equal_jax(tmp_path):
    """The same requests through both packages' ``POST /place``: the same
    outcome and node a request (the deterministic policy)."""
    out = {}
    for p in (JaxPkg(), TorchPkg()):
        reg, ops, engine = _served_plane(p)
        try:
            names = engine.graph.names
            out[p.name] = [json.loads(_post(ops.server.port, "/place",
                                            {"service": names[i % len(names)]})[1])
                           for i in range(12)]
        finally:
            ops.close()
            engine.stop()
    for j, t in zip(out["jax"], out["torch"]):
        assert (t["outcome"], t["node"]) == (j["outcome"], j["node"])
