"""The live ops plane on both packages: tests/test_observability.py's
exposition, ops-server, watchdog, flight-recorder and live-soak cases,
written once over a package namespace and run on the JAX package and on
the port (CPU), plus the port against the JAX package on the same inputs.

Bars: each case's own assertions hold in each package; the port's registry
exposes ``tests/fixtures/exposition_golden.prom`` byte for byte; the two
watchdogs fed the same record dicts raise, clear and report the same
violations (the ``since`` timestamps aside); the two flight recorders
digest the same placement alike; the live soak's ``/healthz`` goes 503
while the breaker is open and 200 once it closes, in both packages.
"""

import json
import math
import os
import re
import signal
import threading
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from kubernetes_rescheduling_tpu import telemetry as jtel
from kubernetes_rescheduling_tpu.bench import boundary as jboundary
from kubernetes_rescheduling_tpu.bench.harness import make_backend as j_make
from kubernetes_rescheduling_tpu.bench.harness import run_chaos_soak as j_soak
from kubernetes_rescheduling_tpu.config import ObsConfig as JObs
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.telemetry import attribution as jattr
from kubernetes_rescheduling_tpu.telemetry import fleet_rollup as jroll
from kubernetes_rescheduling_tpu.telemetry import flight_recorder as jfr
from kubernetes_rescheduling_tpu.telemetry import registry as jregistry
from kubernetes_rescheduling_tpu.telemetry import server as jserver
from kubernetes_rescheduling_tpu.telemetry import slo as jslo
from kubernetes_rescheduling_tpu.telemetry import timeseries as jts
from kubernetes_rescheduling_tpu.telemetry.explain import check_decisions as j_check_decisions
from kubernetes_rescheduling_tpu.telemetry.explain import iter_decisions as j_iter_decisions
from kubernetes_rescheduling_tpu.utils import logging as jlog
from kubernetes_rescheduling_tpu.utils.retry import RetryPolicy as JRetry
from kubernetes_rescheduling_tpu_torch import telemetry as ttel
from kubernetes_rescheduling_tpu_torch.bench import boundary as tboundary
from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend as t_make
from kubernetes_rescheduling_tpu_torch.bench.harness import run_chaos_soak as t_soak
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.telemetry import attribution as tattr
from kubernetes_rescheduling_tpu_torch.telemetry import fleet_rollup as troll
from kubernetes_rescheduling_tpu_torch.telemetry import flight_recorder as tfr
from kubernetes_rescheduling_tpu_torch.telemetry import registry as tregistry
from kubernetes_rescheduling_tpu_torch.telemetry import server as tserver
from kubernetes_rescheduling_tpu_torch.telemetry import slo as tslo
from kubernetes_rescheduling_tpu_torch.telemetry import timeseries as tts
from kubernetes_rescheduling_tpu_torch.telemetry.explain import check_decisions as t_check_decisions
from kubernetes_rescheduling_tpu_torch.telemetry.explain import iter_decisions as t_iter_decisions
from kubernetes_rescheduling_tpu_torch.utils import logging as tlog
from kubernetes_rescheduling_tpu_torch.utils.retry import RetryPolicy as TRetry

GOLDEN = Path(__file__).parent / "fixtures" / "exposition_golden.prom"

PKGS = {
    "jax": types.SimpleNamespace(
        tel=jtel, registry_mod=jregistry, server=jserver, boundary=jboundary, log=jlog,
        attr=jattr, roll=jroll, slo=jslo, ts=jts, fr=jfr,
        obs=lambda **kw: JObs(**kw),
        config=lambda **kw: JConfig(obs=JObs(**kw)),
        soak=lambda **kw: j_soak(retry=JRetry(max_attempts=1), **kw),
        iter_decisions=j_iter_decisions, check_decisions=j_check_decisions,
        traces_metric="jax_traces_total",
    ),
    "torch": types.SimpleNamespace(
        tel=ttel, registry_mod=tregistry, server=tserver, boundary=tboundary, log=tlog,
        attr=tattr, roll=troll, slo=tslo, ts=tts, fr=tfr,
        obs=lambda **kw: TConfig(**kw),
        config=lambda **kw: TConfig(**kw),
        soak=lambda **kw: t_soak(retry=TRetry(max_attempts=1), device="cpu", **kw),
        iter_decisions=t_iter_decisions, check_decisions=t_check_decisions,
        traces_metric="cuda_graph_captures_total",
    ),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture()
def registry(pkg):
    prev = pkg.tel.set_registry(pkg.tel.MetricsRegistry())
    try:
        yield pkg.tel.get_registry()
    finally:
        pkg.tel.set_registry(prev)


def _get(port, path):
    """(status, body bytes) without raising on non-200."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


# ---------------- Prometheus exposition conformance ----------------


_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s(\S+)$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v):
    return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def parse_exposition(text):
    """Strict parser for text format 0.0.4: (families, samples); raises on
    malformed lines or duplicate samples."""
    families, samples = {}, {}
    assert text.endswith("\n"), "exposition must end with a newline"
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            name, help_text = line[len("# HELP "):].split(" ", 1)
            families.setdefault(name, {})["help"] = help_text
        elif line.startswith("# TYPE "):
            name, kind = line[len("# TYPE "):].split(" ", 1)
            families.setdefault(name, {})["type"] = kind
        else:
            m = _SAMPLE.match(line)
            assert m, f"malformed sample line: {line!r}"
            name, labelstr, value = m.groups()
            labels = {}
            if labelstr:
                for lm in _LABEL.finditer(labelstr):
                    labels[lm.group(1)] = _unescape(lm.group(2))
                stripped = re.sub(r"[,\s]", "", labelstr)
                joined = re.sub(r"[,\s]", "", "".join(
                    f'{lm.group(1)}="{lm.group(2)}"' for lm in _LABEL.finditer(labelstr)))
                assert stripped == joined, f"unparsed label text in {line!r}"
            v = float("inf") if value == "+Inf" else float(value)
            key = (name, frozenset(labels.items()))
            assert key not in samples, f"duplicate sample {line!r}"
            samples[key] = v
    return families, samples


def assert_exposition_conformant(text):
    """The wire-format invariants the /metrics endpoint must keep."""
    families, samples = parse_exposition(text)
    by_family = {}
    for (name, labels), v in samples.items():
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        fam = base if base in families else name
        by_family.setdefault(fam, []).append((name, dict(labels), v))
    for name, meta in families.items():
        assert "type" in meta, f"{name}: TYPE line missing"
        rows = by_family.get(name, [])
        assert rows, f"{name}: family declared but no samples"
        if meta["type"] != "histogram":
            continue
        series = {}
        for sample_name, labels, v in rows:
            key = frozenset((k, lv) for k, lv in labels.items() if k != "le")
            s = series.setdefault(key, {"buckets": [], "sum": None, "count": None})
            if sample_name.endswith("_bucket"):
                s["buckets"].append((float(labels["le"]), v))
            elif sample_name.endswith("_sum"):
                s["sum"] = v
            elif sample_name.endswith("_count"):
                s["count"] = v
            else:
                raise AssertionError(f"stray histogram sample {sample_name}")
        for s in series.values():
            assert s["sum"] is not None and s["count"] is not None
            buckets = sorted(s["buckets"])
            assert buckets and buckets[-1][0] == math.inf, f"{name}: +Inf bucket missing"
            counts = [c for _, c in buckets]
            assert counts == sorted(counts), f"{name}: buckets not cumulative"
            assert buckets[-1][1] == s["count"], f"{name}: +Inf bucket != count"
    return families, samples


def test_exposition_conformance_generated(pkg, registry):
    registry.counter("a_total", "As", labelnames=("k",)).labels(k='we"ird\\lab\nel').inc(2)
    registry.gauge("g", "G").set(-1.5)
    h = registry.histogram("h_seconds", "H", labelnames=("x",), buckets=(0.1, 1.0))
    for v, x in ((0.05, "a"), (0.5, "a"), (99.0, "a"), (0.2, "b")):
        h.labels(x=x).observe(v)
    families, samples = assert_exposition_conformant(registry.expose())
    assert families["a_total"]["type"] == "counter"
    assert families["h_seconds"]["type"] == "histogram"
    assert samples[("a_total", frozenset([("k", 'we"ird\\lab\nel')]))] == 2
    assert samples[("g", frozenset())] == -1.5


def feed_golden(pkg, registry) -> None:
    """tests/test_observability.py::test_exposition_golden_file's feed,
    through ``pkg``'s own publishers."""
    registry.counter("rounds_total", "rescheduling rounds executed",
                     labelnames=("algorithm",)).labels(algorithm="communication").inc(3)
    registry.gauge("communication_cost", "cost", labelnames=("algorithm",)).labels(
        algorithm="communication").set(12.5)
    h = registry.histogram("decision_seconds", "latency", labelnames=("algorithm",),
                           buckets=(0.001, 0.01, 0.1)).labels(algorithm="communication")
    for v in (0.0005, 0.005, 0.05, 0.5):
        h.observe(v)
    registry.counter("esc_total", "label escaping", labelnames=("p",)).labels(
        p='a"b\\c\nd').inc()
    pkg.attr.publish_attribution(registry, {
        "total": 10.0, "tail": 1.0,
        "edges": [{"src_service": "a", "dst_service": "b", "src_node": "n0",
                   "dst_node": "n1", "cost": 6.0}],
        "node_pairs": [["n0", "n1", 12.0], ["n1", "n0", 12.0]],
        "ingress": {"n0": 5.0, "n1": 5.0}, "egress": {"n0": 5.0, "n1": 5.0},
    }, top_k=2)
    matrix = np.asarray([[10.0, 1.0, 0.0, 0.0, 0.0], [40.0, 4.0, 1.0, 0.0, 2.0],
                         [20.0, 2.0, 0.0, 0.0, 0.0], [30.0, 3.0, 0.0, 1.0, 1.0]])
    pkg.roll.publish_rollup(registry, pkg.roll.decode_rollup(
        pkg.roll.rollup_numpy(matrix, top_k=2), top_k=2))
    sr = registry.histogram("serving_request_seconds", "per-request serving latency by stage",
                            labelnames=("stage",), buckets=pkg.registry_mod.MICRO_BUCKETS)
    for v, stage in ((20e-6, "total"), (300e-6, "total"), (0.004, "total"), (0.5, "total"),
                     (120e-6, "queue_wait")):
        sr.labels(stage=stage).observe(v)
    store = pkg.ts.SeriesStore(capacity=8, max_series=2, registry=registry,
                               families=("ok_total", "bad_total", "spill_total"))
    for tick, (ok, bad) in enumerate(((10, 0), (20, 1), (30, 3), (40, 6)), start=1):
        store.sample([
            {"metric": "ok_total", "type": "counter", "labels": {}, "value": float(ok)},
            {"metric": "bad_total", "type": "counter", "labels": {}, "value": float(bad)},
        ], tick)
    engine = pkg.slo.SloEngine(
        (pkg.slo.SloSpec(name="golden", objective=0.9, good=(("ok_total", ()),),
                         bad=(("bad_total", ()),)),),
        store, registry=registry, budget_window=8, fast_window=4, fast_burn=2.0,
        slow_window=6, slow_burn=1.5,
    )
    engine.evaluate(4)
    store.sample([{"metric": "spill_total", "type": "counter", "labels": {}, "value": 1.0}], 5)


def test_exposition_golden_file(pkg, registry):
    """Byte-exact pin of the wire format a scraper sees, the same golden
    file for both packages."""
    feed_golden(pkg, registry)
    assert registry.expose() == GOLDEN.read_text()


def test_port_registry_equals_jax_registry_byte_for_byte():
    """The two registries fed the same series expose the same bytes and the
    same snapshot records (timestamps aside)."""
    regs = {}
    for name, p in PKGS.items():
        reg = p.tel.MetricsRegistry()
        feed_golden(p, reg)
        regs[name] = reg
    assert regs["torch"].expose() == regs["jax"].expose()
    snap = {n: [{k: v for k, v in r.items() if k != "ts"} for r in reg.snapshot()]
            for n, reg in regs.items()}
    assert snap["torch"] == snap["jax"]


def test_exposition_conformance_attribution_families(pkg, registry):
    for rnd in range(3):
        pkg.attr.publish_attribution(registry, {
            "total": 10.0 + rnd, "tail": 0.0,
            "edges": [{"src_service": "a", "dst_service": "b", "src_node": f"n{rnd % 2}",
                       "dst_node": "n2", "cost": 10.0 + rnd}],
            "node_pairs": [[f"n{rnd % 2}", "n2", 2 * (10.0 + rnd)],
                           ["n2", f"n{rnd % 2}", 2 * (10.0 + rnd)]],
            "ingress": {"n0": 5.0, "n1": 0.0, "n2": 5.0 + rnd},
            "egress": {"n0": 5.0, "n1": 0.0, "n2": 5.0 + rnd},
        }, top_k=3)
    families, samples = assert_exposition_conformant(registry.expose())
    for name in ("comm_cost_node_pair", "comm_cost_node_ingress", "comm_cost_node_egress",
                 "comm_cost_edge_topk"):
        assert families[name]["type"] == "gauge"
    assert samples[("comm_cost_edge_topk", frozenset([("rank", "0")]))] == 12.0
    assert samples[("comm_cost_node_pair", frozenset([("src", "n1"), ("dst", "n2")]))] == 0.0


def test_exposition_conformance_slo_families(pkg, registry):
    store = pkg.ts.SeriesStore(capacity=4, max_series=2, registry=registry, families=None)
    engine = pkg.slo.SloEngine(
        (pkg.slo.SloSpec(name="avail", objective=0.95, good=(("ok_total", ()),),
                         bad=(("bad_total", ()),)),),
        store, registry=registry, budget_window=8, fast_window=4, slow_window=6,
    )
    for tick in range(1, 6):
        store.sample([
            {"metric": "ok_total", "type": "counter", "labels": {}, "value": 10.0 * tick},
            {"metric": "bad_total", "type": "counter", "labels": {}, "value": 1.0 * tick},
        ], tick)
        engine.evaluate(tick)
    store.sample([{"metric": "spill_total", "type": "counter", "labels": {}, "value": 1.0}], 6)
    families, samples = assert_exposition_conformant(registry.expose())
    assert families["slo_budget_remaining_frac"]["type"] == "gauge"
    assert families["slo_burn_rate"]["type"] == "gauge"
    assert families["timeseries_evictions_total"]["type"] == "counter"
    assert samples[("timeseries_series", frozenset())] == 2.0
    assert samples[("timeseries_evictions_total", frozenset())] == 1.0
    assert ("slo_burn_rate", frozenset([("slo", "avail"), ("window", "fast")])) in samples


# ---------------- ops server ----------------


def test_metrics_endpoint_serves_live_registry(pkg, registry):
    registry.counter("x_total", "x").inc(7)
    srv = pkg.server.OpsServer(port=0, registry=registry)
    port = srv.start()
    try:
        status, body = _get(port, "/metrics")
        assert status == 200 and "x_total 7" in body.decode()
        registry.counter("x_total").inc()
        _, body2 = _get(port, "/metrics")
        assert "x_total 8" in body2.decode()
        assert_exposition_conformant(body2.decode())
    finally:
        srv.stop()


def test_healthz_follows_breaker_state(pkg, registry):
    health = pkg.server.HealthState()
    breaker = pkg.boundary.CircuitBreaker(max_consecutive_failures=1, registry=registry)
    health.breaker = breaker
    srv = pkg.server.OpsServer(port=0, registry=registry, health=health)
    port = srv.start()
    try:
        status, body = _get(port, "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
        breaker.record_failure()  # opens at 1
        status, body = _get(port, "/healthz")
        payload = json.loads(body)
        assert status == 503 and payload["status"] == "unhealthy"
        assert payload["breaker"] == "open"
        breaker.record_success()
        assert _get(port, "/healthz")[0] == 200
    finally:
        srv.stop()


def test_events_endpoint_serves_logger_tail(pkg, registry):
    logger = pkg.log.StructuredLogger(name="t")
    for i in range(10):
        logger.info("tick", i=i)
    srv = pkg.server.OpsServer(port=0, registry=registry, events_source=lambda: logger.records)
    port = srv.start()
    try:
        status, body = _get(port, "/events?n=3")
        assert status == 200 and [e["i"] for e in json.loads(body)] == [7, 8, 9]
        assert _get(port, "/nope")[0] == 404
    finally:
        srv.stop()


def test_events_tail_limit_bounds_and_defaults(pkg, registry):
    logger = pkg.log.StructuredLogger(name="t", max_records=16)
    for i in range(20):
        logger.info("tick", i=i)
    srv = pkg.server.OpsServer(port=0, registry=registry, events_source=lambda: logger.records)
    port = srv.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/events", timeout=10) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"] == "application/json"
            events = json.loads(resp.read())
        assert [e["i"] for e in events] == list(range(4, 20))
        assert [e["i"] for e in json.loads(_get(port, "/events?n=2")[1])] == [18, 19]
        assert len(json.loads(_get(port, "/events?n=9999")[1])) == 16
        assert json.loads(_get(port, "/events?n=0")[1]) == []
        assert len(json.loads(_get(port, "/events?n=bogus")[1])) == 16
    finally:
        srv.stop()


def test_healthz_round_age_survives_wall_clock_step(pkg, registry, monkeypatch):
    import time as time_mod

    health = pkg.server.HealthState(max_round_age_s=60.0)
    health.mark_round()
    payload, healthy = health.snapshot()
    assert healthy and payload["last_round_age_s"] < 1.0
    real_time = time_mod.time
    monkeypatch.setattr(time_mod, "time", lambda: real_time() + 86400.0)
    payload, healthy = health.snapshot()
    assert healthy and payload["last_round_age_s"] < 1.0 and not payload["stale"]
    real_mono = time_mod.monotonic
    monkeypatch.setattr(time_mod, "monotonic", lambda: real_mono() + 120.0)
    payload, healthy = health.snapshot()
    assert payload["stale"] and not healthy
    srv = pkg.server.OpsServer(port=0, registry=registry, health=health)
    port = srv.start()
    try:
        status, body = _get(port, "/healthz")
        assert status == 503 and json.loads(body)["stale"] is True
    finally:
        srv.stop()


def test_requests_are_counted_not_printed(pkg, registry):
    srv = pkg.server.OpsServer(port=0, registry=registry)
    port = srv.start()
    try:
        _get(port, "/healthz")
        _get(port, "/healthz")
        fam = registry.counter("ops_http_requests_total", labelnames=("endpoint",))
        assert fam.labels(endpoint="/healthz").value == 2
    finally:
        srv.stop()


def test_endpoints_without_their_planes(pkg, registry):
    """A plane with no fleet, serving engine, mesh or slo attached answers
    /tenants, /devices, /slo and /query 404 and POST /place 503, GET /place
    and GET /profile 405, a bad POST /profile body 400, and arms one capture
    (then 409) on a good one."""
    plane = pkg.server.OpsPlane.from_config(pkg.obs(serve_port=0), registry=registry,
                                            bundle_dir=None)
    plane.profiler._start_backend = lambda log_dir: None
    plane.profiler._stop_backend = lambda: None
    plane.start()
    port = plane.server.port
    try:
        for path in ("/tenants", "/tenants/t0", "/devices", "/slo", "/query"):
            assert _get(port, path)[0] == 404, path
        for path in ("/place", "/profile"):
            assert _get(port, path)[0] == 405, path

        def post(path, body):
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                         method="POST")
            try:
                with urllib.request.urlopen(req, timeout=10) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        assert post("/place", b'{"service": "a"}')[0] == 503
        assert post("/profile", b"[1]")[0] == 400
        assert post("/profile", b'{"rounds": true}')[0] == 400
        code, payload = post("/profile", b'{"rounds": 2}')
        assert code == 200 and payload["armed"] and payload["rounds"] == 2
        code, payload = post("/profile", b"{}")
        assert code == 409 and payload["status"]["pending_rounds"] == 2
    finally:
        plane.close()


# ---------------- SLO watchdog ----------------


def _rec(lat=0.01, cost=10.0):
    return types.SimpleNamespace(decision_latency_s=lat, communication_cost=cost)


def test_latency_p95_rule_fires_and_recovers(pkg, registry):
    logger = pkg.log.StructuredLogger(name="t")
    wd = pkg.tel.Watchdog(pkg.tel.SLORules(window=8, min_samples=4, latency_p95_s=0.1,
                                           max_retraces=0), registry=registry, logger=logger)
    for _ in range(4):
        assert wd.observe_round(_rec(lat=0.01)) == []
    raised = []
    for _ in range(6):
        raised += wd.observe_round(_rec(lat=1.0))
    assert any(v["rule"] == "round_latency_p95" for v in raised)
    assert not wd.healthy
    fam = registry.counter("slo_violations_total", labelnames=("rule",))
    assert fam.labels(rule="round_latency_p95").value == 1
    for _ in range(8):
        wd.observe_round(_rec(lat=0.001))
    assert wd.healthy
    events = [r["event"] for r in logger.records]
    assert "slo_violation" in events and "slo_recovered" in events


def test_cost_regression_rule(pkg, registry):
    wd = pkg.tel.Watchdog(pkg.tel.SLORules(window=10, min_samples=3, cost_regression_frac=0.5,
                                           max_retraces=0), registry=registry)
    for c in (10.0, 9.0, 8.0):
        wd.observe_round(_rec(cost=c))
    assert wd.healthy
    wd.observe_round(_rec(cost=20.0))
    assert not wd.healthy and "comm_cost_regression" in wd.active


def test_retrace_rule_reads_registry(pkg, registry):
    """The JAX watchdog reads ``jax_traces_total``, the port's the capture
    counter ``cuda_graph_captures_total``."""
    wd = pkg.tel.Watchdog(pkg.tel.SLORules(max_retraces=1), registry=registry)
    fam = registry.counter(pkg.traces_metric, "t", labelnames=("fn",))
    fam.labels(fn="hot").inc()
    wd.observe_round(_rec())
    assert wd.healthy
    fam.labels(fn="hot").inc()
    wd.observe_round(_rec())
    assert not wd.healthy and wd.active["retrace"]["fns"] == {"hot": 2}


def test_cost_rule_min_samples_one_does_not_crash(pkg, registry):
    wd = pkg.tel.Watchdog(pkg.tel.SLORules(min_samples=1, cost_regression_frac=0.5,
                                           max_retraces=0), registry=registry)
    assert wd.observe_round(_rec(cost=10.0)) == []
    wd.observe_round(_rec(cost=20.0))
    assert "comm_cost_regression" in wd.active


def test_rebase_starts_fresh_window(pkg, registry):
    wd = pkg.tel.Watchdog(pkg.tel.SLORules(min_samples=2, cost_regression_frac=0.5,
                                           max_retraces=1), registry=registry)
    fam = registry.counter(pkg.traces_metric, "t", labelnames=("fn",))
    fam.labels(fn="decide").inc()
    wd.observe_round(_rec(cost=1.0))
    assert wd.healthy
    wd.rebase()
    fam.labels(fn="decide").inc()
    wd.observe_round(_rec(cost=100.0))
    assert wd.healthy, wd.active
    fam.labels(fn="decide").inc()
    wd.observe_round(_rec(cost=100.0))
    assert "retrace" in wd.active


def test_rules_validate(pkg):
    with pytest.raises(ValueError):
        pkg.tel.SLORules(window=1).validate()
    with pytest.raises(ValueError):
        pkg.tel.SLORules(latency_p95_s=-1).validate()


def _verdict_stream(pkg, rules, records, feeds):
    """Feed one watchdog ``records`` (and the extra ``feeds`` after each,
    ``(method, arg)``); returns the per-step raised violations and active
    rule sets with the timestamps dropped."""
    wd = pkg.tel.Watchdog(rules(pkg), registry=pkg.tel.MetricsRegistry())
    out = []

    def strip(v):
        return {k: x for k, x in v.items() if k != "since"}

    for rec, extra in zip(records, feeds):
        raised = wd.observe_round(types.SimpleNamespace(**rec))
        for method, arg in extra:
            raised = raised + (getattr(wd, method)(arg) or [])
        out.append(([strip(v) for v in raised],
                    {k: strip(v) for k, v in sorted(wd.active.items())}, wd.healthy))
    return out


def test_watchdogs_give_equal_verdicts_on_the_same_records():
    """The JAX watchdog and the port's, every rule armed, fed the same
    record dicts (latency spikes, a cost regression, a dominant edge, a
    collapsed forecast, a pipeline overlap collapse, reconcile drift, a
    fleet tail rollup, scan trips, serving summaries): the same violations
    raised and active at every step."""
    rng = np.random.default_rng(7)

    def rules(p):
        return p.tel.SLORules(window=6, min_samples=2, latency_p95_s=0.05,
                              cost_regression_frac=0.2, max_retraces=0,
                              attribution_drift_frac=0.5, forecast_min_skill=0.0,
                              pipeline_min_overlap=0.3, reconcile_max_drift_pods=2,
                              fleet_tail_frac=0.25, scan_tripwire=True, serving_p99_ms=20.0)

    records, feeds = [], []
    for i in range(40):
        cost = float(10 + rng.integers(0, 6) + (12 if i in (9, 10, 25) else 0))
        top = float(cost * (0.7 if i % 7 == 3 else 0.3))
        records.append(dict(
            decision_latency_s=float(0.2 if 12 <= i < 17 else 0.01),
            communication_cost=cost,
            attribution={"total": cost, "tail": cost - top,
                         "edges": [{"src_service": "a", "dst_service": "b", "cost": top}]},
            forecast=({"trained": True, "skill": float(-0.3 if i in (20, 21) else 0.4),
                       "mae_model": 1.0, "mae_persistence": 1.0, "mode": "predictive"}
                      if i >= 18 else None),
            pipeline=({"overlap_ratio": float(0.1 if 30 <= i < 38 else 0.8)} if i >= 28 else None),
            reconcile=({"drift_pods": int(3 if i in (5, 6) else 0)} if i % 2 else None),
            degraded=False, round=i,
        ))
        extra = [("observe_fleet_rollup", {"dims": {"cost": {"quantiles": {
            "p99": float(100 + (60 if i in (14, 15) else rng.integers(0, 5)))}}}})]
        if i % 5 == 4:
            extra.append(("observe_scan_block", {"round": i} if i in (9, 24) else None))
        if i % 3 == 0:
            extra.append(("observe_serving", {"count": 50 + i, "p50_ms": 1.0,
                                              "p99_ms": float(40.0 if 21 <= i < 27 else 5.0)}))
        feeds.append(extra)
    j = _verdict_stream(PKGS["jax"], rules, records, feeds)
    t = _verdict_stream(PKGS["torch"], rules, records, feeds)
    assert t == j
    fired = {r["rule"] for step in j for r in step[0]}
    assert {"round_latency_p95", "comm_cost_regression", "attribution_drift",
            "forecast_skill", "pipeline_overlap", "reconcile_divergence",
            "fleet_tail_cost", "scan_tripwire", "serving_p99"} <= fired, fired


# ---------------- flight recorder ----------------


def test_ring_is_bounded_and_dump_self_contained(pkg, tmp_path, registry):
    fr = pkg.tel.FlightRecorder(capacity=3, bundle_dir=tmp_path, registry=registry)
    for r in range(1, 6):
        fr.record_round(round=r, digest=f"d{r}", record={"round": r})
    assert [e["round"] for e in fr.rounds] == [3, 4, 5]
    registry.counter("x_total", "x").inc()
    bundle = json.loads(fr.dump("breaker_open", transition={"to": "open"}).read_text())
    assert bundle["kind"] == "flight_recorder_bundle" and bundle["reason"] == "breaker_open"
    assert len(bundle["rounds"]) == 3
    assert any(m["metric"] == "x_total" for m in bundle["metrics"])
    assert bundle["manifest"]["python"]
    fam = registry.counter("flight_recorder_dumps_total", labelnames=("reason",))
    assert fam.labels(reason="breaker_open").value == 1


def test_dump_is_best_effort_never_raises(pkg, registry):
    logger = pkg.log.StructuredLogger(name="t")
    fr = pkg.tel.FlightRecorder(capacity=2, bundle_dir="/proc/definitely/not/writable",
                                registry=registry, logger=logger)
    fr.record_round(round=1)
    assert fr.dump("crash") is None
    assert any(r["event"] == "flight_dump_failed" for r in logger.records)


def test_no_bundle_dir_means_no_dump(pkg, registry):
    assert pkg.tel.FlightRecorder(capacity=2, registry=registry).dump("crash") is None


def test_sigusr1_dumps_via_ops_plane(pkg, tmp_path, registry):
    ops = pkg.server.OpsPlane.from_config(pkg.obs(flight_recorder_rounds=4), registry=registry,
                                          bundle_dir=str(tmp_path)).start()
    try:
        ops.recorder.record_round(round=1, record={"round": 1})
        os.kill(os.getpid(), signal.SIGUSR1)
        assert len(list(tmp_path.glob("flight_*_sigusr1.json"))) == 1
    finally:
        ops.close()
    assert signal.getsignal(signal.SIGUSR1) is not None


def test_breaker_open_transition_dumps(pkg, tmp_path, registry):
    ops = pkg.server.OpsPlane.from_config(pkg.obs(flight_recorder_rounds=4), registry=registry,
                                          bundle_dir=str(tmp_path))
    breaker = pkg.boundary.CircuitBreaker(max_consecutive_failures=2, registry=registry)
    breaker.on_transition = ops.on_breaker_transition
    breaker.record_failure()
    assert not list(tmp_path.glob("*.json"))
    breaker.record_failure()
    bundles = list(tmp_path.glob("flight_*_breaker_open.json"))
    assert len(bundles) == 1
    assert json.loads(bundles[0].read_text())["transition"]["to"] == "open"


@pytest.mark.parametrize("scenario", ["mubench", "powerlaw"])
def test_state_digest_equals_jax(scenario):
    """The port's digest hashes ``pod_node`` as i32 and ``pod_valid`` as
    bool bytes: the same placement digests alike in both packages."""
    jb, tb = j_make(scenario, 0), t_make(scenario, 0, device="cpu")
    assert tfr.state_digest(tb.monitor()) == jfr.state_digest(jb.monitor())
    tb.inject_imbalance(tb.node_names[0])
    jb.inject_imbalance(jb.node_names[0])
    assert tfr.state_digest(tb.monitor()) == jfr.state_digest(jb.monitor())


def test_config_obs_validation(pkg):
    for kw in ({"serve_port": 70000}, {"explain_top_k": 0}, {"flight_recorder_rounds": 0},
               {"slo_window": 1}, {"attribution_top_k": 0}, {"profile_max_mb": 0}):
        with pytest.raises(ValueError):
            pkg.config(**kw).validate()


# ---------------- acceptance: the LIVE chaos soak ----------------


def _probing_logger(pkg):
    class ProbingLogger(pkg.log.StructuredLogger):
        """Probes the live endpoint as loop events happen: /healthz on every
        skipped round and every breaker re-close, /metrics each round."""

        def __post_init__(self):
            super().__post_init__()
            self.port = None
            self.skip_probes, self.close_probes, self.mid_metrics = [], [], None

        def log(self, level, event, **fields):
            super().log(level, event, **fields)
            if self.port is None:
                return
            if event == "round_skipped":
                status, body = _get(self.port, "/healthz")
                self.skip_probes.append((fields.get("breaker"), status, json.loads(body)))
            elif event == "breaker" and fields.get("to") == "closed":
                status, body = _get(self.port, "/healthz")
                self.close_probes.append((status, json.loads(body)))
            elif event == "round":
                self.mid_metrics = _get(self.port, "/metrics")[1].decode()

    return ProbingLogger(name="live-soak")


def test_live_ops_soak_acceptance(pkg, tmp_path, registry):
    """The seeded ``soak`` under a LIVE plane: /healthz 503 while the
    breaker is open and 200 once it re-closes, /metrics mid-run conformant,
    the final scrape equal to the registry, a breaker-open bundle for each
    opening whose decisions and attributions are consistent."""
    logger = _probing_logger(pkg)
    ops = pkg.server.OpsPlane.from_config(
        pkg.obs(serve_port=0, flight_recorder_rounds=64), registry=registry, logger=logger,
        bundle_dir=str(tmp_path / "fr")).start()
    logger.port = ops.server.port
    try:
        report = pkg.soak(profile="soak", rounds=35, seed=1, chaos_seed=0,
                          max_consecutive_failures=3, breaker_cooldown_rounds=2,
                          failure_budget_per_round=2, logger=logger, registry=registry, ops=ops)
        assert report["records"] + report["skipped_rounds"] == 35
        assert report["breaker_opens"] >= 1 and report["breaker_closes"] >= 1
        open_probes = [p for p in logger.skip_probes if p[0] == "open"]
        assert open_probes
        for _, status, payload in open_probes:
            assert status == 503 and payload["breaker"] == "open"
        assert logger.close_probes
        for status, payload in logger.close_probes:
            assert status == 200 and payload["breaker"] == "closed"
        families, _ = assert_exposition_conformant(logger.mid_metrics)
        for name in ("rounds_total", "chaos_faults_total", "decision_seconds"):
            assert name in families
        assert _get(logger.port, "/metrics")[1].decode() == registry.expose()
        status, body = _get(logger.port, "/healthz")
        payload = json.loads(body)
        assert payload["rounds"] == report["records"]
        assert payload["skipped_rounds"] == report["skipped_rounds"]
        assert status == (503 if ops.health.breaker.state == "open" else 200)
        bundles = sorted((tmp_path / "fr").glob("flight_*_breaker_open.json"))
        assert len(bundles) == report["breaker_opens"]
        bundle = json.loads(bundles[-1].read_text())
        executed = [r for r in bundle["rounds"] if not r.get("skipped")]
        assert executed and all(e["digest"] for e in executed)
        assert all(e["record"]["explanations"] for e in executed)
        checked, bad = pkg.check_decisions(pkg.iter_decisions(bundle["rounds"]))
        assert checked >= len(executed) and bad == []
        a_checked, a_bad = pkg.attr.check_attribution(bundle["rounds"])
        assert a_checked == len(executed) and a_bad == []
        assert bundle["attribution"]["communication"]["round"] >= 1
        assert ops.watchdog.healthy, ops.watchdog.active
    finally:
        ops.close()


def test_live_soak_reports_equal_across_packages(tmp_path):
    """The same soak under each package's live plane: the same report and
    the same /healthz skip and round counts."""
    out = {}
    for name, p in PKGS.items():
        reg = p.tel.MetricsRegistry()
        ops = p.server.OpsPlane.from_config(p.obs(), registry=reg,
                                            bundle_dir=str(tmp_path / name))
        report = p.soak(profile="soak", rounds=20, seed=2, chaos_seed=1,
                        max_consecutive_failures=2, registry=reg, ops=ops)
        out[name] = (report, ops.health.rounds, ops.health.skipped_rounds,
                     len(ops.recorder.dumps))
    assert out["torch"] == out["jax"]


def test_scrape_thread_while_rounds_run(tmp_path):
    """A thread scrapes /metrics and /healthz while the port's loop runs
    with the plane: every scrape answers, and the loop's records equal the
    run without a plane (the scrapes touch no device state)."""
    from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller

    def backend():
        b = t_make("powerlaw", 0, device="cpu")
        b.inject_imbalance(b.node_names[0])
        return b

    cfg = TConfig(max_rounds=6, sleep_after_action_s=0.0, serve_port=0)
    reg = ttel.MetricsRegistry()
    logger = tlog.StructuredLogger(name="scrape")
    ops = tserver.OpsPlane.from_config(cfg, registry=reg, logger=logger,
                                       bundle_dir=str(tmp_path)).start()
    stop, scrapes = threading.Event(), []

    def scrape():
        while not stop.is_set():
            scrapes.append((_get(ops.server.port, "/metrics")[0],
                            _get(ops.server.port, "/healthz")[0]))

    th = threading.Thread(target=scrape, daemon=True)
    th.start()
    try:
        res = run_controller(backend(), cfg, device="cpu", registry=reg, logger=logger,
                             ops=ops)
    finally:
        stop.set()
        th.join(timeout=10)
        ops.close()
    assert not th.is_alive() and scrapes and all(m == 200 and h == 200 for m, h in scrapes)
    plain = run_controller(backend(), cfg, device="cpu", registry=ttel.MetricsRegistry(),
                           logger=tlog.StructuredLogger(name="plain"))
    keys = ("round", "moved", "service", "target", "communication_cost", "load_std",
            "attribution", "explanations")
    assert [{k: getattr(r, k) for k in keys} for r in res.rounds] == \
        [{k: getattr(r, k) for k in keys} for r in plain.rounds]
