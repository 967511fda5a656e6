"""The live ops plane: an in-process, stdlib-only HTTP endpoint plus the
aggregate (:class:`OpsPlane`) that wires it to the control loop — the port
of ``kubernetes_rescheduling_tpu.telemetry.server``.

Endpoints (``--serve PORT`` on ``reschedule``/``bench``):

- ``GET /metrics``  — live Prometheus text exposition straight from the
  process :class:`~.registry.MetricsRegistry` (format 0.0.4), scrapeable
  mid-run — this replaces the old "dump a .prom file and python -m
  http.server it" workaround.
- ``GET /healthz``  — JSON health: circuit-breaker state, last-round
  age, executed/skipped/degraded counts, and the SLO watchdog verdict.
  Returns **503** while unhealthy (breaker open, an active SLO
  violation, or a stale loop), 200 otherwise — a liveness probe or the
  chaos soak can watch the loop degrade and recover in real time.
- ``GET /events``   — the newest structured-log events as JSON
  (``?n=`` tail-limits for cheap polling; default = the full ring,
  which is itself bounded) — the StructuredLogger ring, without
  grepping JSONL files mid-incident.
- ``GET /tenants`` / ``GET /tenants/<name>`` — fleet drill-down from
  the bounded per-tenant summary ring
  (``telemetry.fleet_rollup.TenantSummaryRing``): the per-tenant detail
  the cardinality budget keeps OUT of ``/metrics`` label space (last
  round, breaker, drift, a capped cost window). 404s when no fleet run
  is attached or the tenant is unknown/evicted.
- ``POST /place`` — the serving plane's front (``serving/``): admit one
  pod/deployment spec (``{"service": name, "deadline_ms"?: float}``),
  score it against the device-resident state through the bounded
  batcher, answer with the placement + explain bundle + per-stage
  timings. 400 on bad JSON / unknown service, 200 on
  placed/no_candidate, 503 on shed/timeout (back off) or when no engine
  is attached. Slow scrapes cannot head-of-line-block it: the heavy
  read paths share a lock, /place does not take it.
- ``GET /slo`` — the SLO v2 budget/burn table (``telemetry.slo``): per
  SLO the objective, error-budget remaining, fast/slow burn rates, and
  time-to-exhaustion. 404 when the slo plane is disabled.
- ``GET /query?series=&n=`` — bounded raw readout of one history-plane
  ring (``telemetry.timeseries.SeriesStore``); a bare /query lists the
  retained series names. 404 when disabled or the series is unknown.
- ``GET /devices`` — the mesh/device plane's per-device overview
  (``telemetry.mesh.MeshPlane``): attributed step ms, cumulative transfer
  MB and allocated card memory per device, the rollup event. 404 until a
  dp fleet run binds a mesh plane (``OpsPlane.bind_mesh``).
- ``POST /profile`` — arm one on-demand ``torch.profiler`` capture
  (``{"rounds"?: int}``, default 1) around the next N fleet rounds or
  the next scan block; the artifact lands in the flight-recorder
  bundle dir. 400 on a bad body, 409 while a capture is pending/active
  or the per-run budget is spent, 503 when no profiler is attached.

The server runs daemon threads and binds 127.0.0.1 by default; port 0
picks an ephemeral port (tests). Handlers never write to stdout/stderr —
request accounting goes through ``ops_http_requests_total{endpoint}`` —
and never touch the device: ``/metrics`` and ``/healthz`` read host state
only, and ``POST /place`` only enqueues to the serving engine's batcher,
whose thread owns the device work.

:class:`OpsPlane` bundles the registry, event logger, SLO watchdog,
flight recorder, health state, and server into the single object
``run_controller(ops=...)`` consumes; ``OpsPlane.from_config`` builds it
from a ``RescheduleConfig`` (the port's flat fields carry the JAX
package's ``obs`` block under the same names). SIGUSR1 (when the plane
starts on the main thread) dumps a flight-recorder bundle on demand.
"""

from __future__ import annotations

import json
import signal
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qs, urlsplit

from kubernetes_rescheduling_tpu_torch.telemetry import costmodel
from kubernetes_rescheduling_tpu_torch.telemetry.flight_recorder import (
    FlightRecorder,
    state_digest,
)
from kubernetes_rescheduling_tpu_torch.telemetry.mesh import (
    ProfilerBusy,
    ProfilerExhausted,
    ProfilerGate,
)
from kubernetes_rescheduling_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    get_registry,
)
from kubernetes_rescheduling_tpu_torch.telemetry.slo import RULE_FAST_BURN
from kubernetes_rescheduling_tpu_torch.telemetry.spans import get_tracer
from kubernetes_rescheduling_tpu_torch.telemetry.watchdog import SLORules, Watchdog


class HealthState:
    """Live-readable loop health; the controller updates counts, the
    breaker/watchdog are read at request time so /healthz can go
    unhealthy (and recover) BETWEEN rounds, not only after one."""

    def __init__(self, *, max_round_age_s: float = 0.0) -> None:
        self.max_round_age_s = max_round_age_s
        self.breaker = None
        self.watchdog: Watchdog | None = None
        self.algorithm: str | None = None
        # ages/uptime compute from the MONOTONIC clock — an NTP step must
        # neither force a spurious 503 nor mask genuine staleness; the
        # wall-clock twins exist for display only
        self.started_ts = time.time()
        self._started_mono = time.monotonic()
        self.last_round_ts: float | None = None
        self._last_round_mono: float | None = None
        self.rounds = 0
        self.skipped_rounds = 0
        self.degraded_rounds = 0
        # latest perf-ledger verdict summary (OpsPlane.observe_perf) —
        # unhealthiness itself flows through the watchdog's
        # perf_regression rule; this is the human-readable "what & why"
        self.perf: dict | None = None
        # fleet mode: per-tenant health rows (bench.fleet updates this
        # each round). A single tenant's open breaker is DEGRADED fleet
        # service, not a dead plane — it shows here without flipping the
        # endpoint to 503 (per-tenant isolation extends to the probe).
        self.fleet: dict[str, dict] | None = None
        # scan-plane summary (OpsPlane.observe_scan_block/observe_scan_
        # drain): block size, blocks dispatched, drain breakdown, latest
        # trip — rendered on /healthz when a scanned schedule runs
        self.scan: dict[str, Any] | None = None
        # serving-plane summary (OpsPlane.observe_serving): request rate,
        # rolling p50/p95/p99, batch-size distribution, shed counts —
        # rendered on /healthz when a serving engine is attached; the
        # serving_p99 watchdog rule flips the endpoint itself
        self.serving: dict[str, Any] | None = None
        # mesh & device-plane summary (OpsPlane.observe_device_rollup):
        # device count, rounds observed, the attributed step-time
        # quantiles, and the worst/median imbalance ratio — rendered on
        # /healthz when the device plane runs; the mesh_imbalance
        # watchdog rule flips the endpoint itself
        self.mesh: dict[str, Any] | None = None
        # a dispatched scan block is K rounds of healthy silence:
        # mark_round only fires as the replay flushes, so while a block
        # is in flight the staleness budget scales by its expected
        # rounds instead of spuriously 503ing a healthy loop
        self._inflight_rounds = 0

    def mark_round(self) -> None:
        """Stamp 'a round just finished' on both clocks."""
        self.last_round_ts = time.time()
        self._last_round_mono = time.monotonic()
        self._inflight_rounds = 0

    def mark_block_inflight(self, rounds: int) -> None:
        """A scan block of ``rounds`` rounds just dispatched: scale the
        staleness budget until its replay flushes (any mark_round or
        :meth:`mark_block_done` clears the scaling)."""
        self._inflight_rounds = max(int(rounds), 1)

    def mark_block_done(self) -> None:
        """The block's replay finished (however many rounds committed):
        back to the per-round staleness budget."""
        self._inflight_rounds = 0

    def snapshot(self) -> tuple[dict[str, Any], bool]:
        breaker_state = getattr(self.breaker, "state", None)
        age = (
            time.monotonic() - self._last_round_mono
            if self._last_round_mono is not None
            else None
        )
        age_budget = self.max_round_age_s * max(self._inflight_rounds, 1)
        stale = (
            age_budget > 0
            and age is not None
            and age > age_budget
        )
        slo = self.watchdog.status() if self.watchdog is not None else None
        healthy = (
            breaker_state != "open"
            and not stale
            and (slo is None or slo["healthy"])
        )
        return (
            {
                "status": "ok" if healthy else "unhealthy",
                "algorithm": self.algorithm,
                "breaker": breaker_state,
                "rounds": self.rounds,
                "skipped_rounds": self.skipped_rounds,
                "degraded_rounds": self.degraded_rounds,
                "last_round_age_s": age,
                "last_round_ts": self.last_round_ts,  # wall anchor, display
                "stale": stale,
                "uptime_s": time.monotonic() - self._started_mono,
                "slo": slo,
                "perf": self.perf,
                **({"scan": self.scan} if self.scan is not None else {}),
                **(
                    {"serving": self.serving}
                    if self.serving is not None
                    else {}
                ),
                **({"fleet": self.fleet} if self.fleet is not None else {}),
                **({"mesh": self.mesh} if self.mesh is not None else {}),
            },
            healthy,
        )


class OpsServer:
    """Threaded stdlib HTTP server over (registry, health, events)."""

    def __init__(
        self,
        *,
        port: int = 0,
        host: str = "127.0.0.1",
        registry: MetricsRegistry | None = None,
        health: HealthState | None = None,
        events_source=None,  # zero-arg callable -> list[dict]
        tenants_source=None,  # zero-arg callable -> TenantSummaryRing | None
        serving_source=None,  # zero-arg callable -> ServingEngine | None
        slo_source=None,  # zero-arg callable -> budget/burn table | None
        query_source=None,  # callable(series, n) -> (payload, code)
        devices_source=None,  # zero-arg callable -> device overview | None
        profile_sink=None,  # callable(rounds) -> (payload, code)
    ) -> None:
        self._port = port
        self.host = host
        self.registry = registry
        self.health = health
        self.events_source = events_source
        self.tenants_source = tenants_source
        self.serving_source = serving_source
        self.slo_source = slo_source
        self.query_source = query_source
        self.devices_source = devices_source
        self.profile_sink = profile_sink
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        # serializes the SLOW read paths (full-registry exposition, event/
        # tenant ring walks) against each other so a scrape storm degrades
        # scrapes, not serving: POST /place and /healthz deliberately do
        # NOT take it — each ThreadingHTTPServer request has its own
        # thread, so a multi-ms /metrics render can never head-of-line-
        # block an in-flight placement request
        self._read_lock = threading.Lock()

    @property
    def port(self) -> int:
        return (
            self._httpd.server_address[1]
            if self._httpd is not None
            else self._port
        )

    def _reg(self) -> MetricsRegistry:
        return self.registry if self.registry is not None else get_registry()

    def start(self) -> int:
        if self._httpd is not None:
            return self.port
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((self.host, self._port), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="krt-ops-server",
            daemon=True,
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd = None
        self._thread = None


def _make_handler(ops: OpsServer):
    class Handler(BaseHTTPRequestHandler):
        server_version = "krt-ops/1"
        protocol_version = "HTTP/1.1"

        def log_message(self, format, *args):  # noqa: A002 — stdlib signature
            pass  # request accounting is a metric, not a stderr line

        def _respond(self, code: int, body: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _count(self, endpoint: str) -> None:
            # request accounting must stay cardinality-bounded: the
            # drill-down's tenant name is a PATH, never a label value —
            # and arbitrary 404 paths (favicon probes, port scanners)
            # must not mint one memoized series each. /place joins the
            # allowlist (GET and POST count into the same series: the
            # endpoint IS the cardinality unit, not the method).
            if endpoint.startswith("/tenants/"):
                counted = "/tenants/<name>"
            elif endpoint in ("/", "/metrics", "/healthz", "/events",
                              "/tenants", "/place", "/slo", "/query",
                              "/devices", "/profile"):
                counted = endpoint
            else:
                counted = "<other>"
            ops._reg().counter(
                "ops_http_requests_total",
                "requests served by the live ops endpoint",
                labelnames=("endpoint",),
            ).labels(endpoint=counted).inc()

        def do_GET(self) -> None:  # noqa: N802 — stdlib signature
            url = urlsplit(self.path)
            endpoint = url.path.rstrip("/") or "/"
            self._count(endpoint)
            if endpoint == "/metrics":
                with ops._read_lock:
                    reg = ops._reg()
                    costmodel.republish_book(reg)
                    body = reg.expose().encode()
                self._respond(
                    200, body, "text/plain; version=0.0.4; charset=utf-8"
                )
            elif endpoint == "/healthz":
                if ops.health is None:
                    payload, healthy = {"status": "ok", "detail": "no loop"}, True
                else:
                    payload, healthy = ops.health.snapshot()
                body = json.dumps(payload, default=float).encode()
                self._respond(
                    200 if healthy else 503, body, "application/json"
                )
            elif endpoint == "/events":
                with ops._read_lock:
                    events = (
                        list(ops.events_source() or [])
                        if ops.events_source is not None
                        else []
                    )
                # ?n= tail-limits the response (cheap polling of the last
                # few events); default is the FULL ring — which is itself
                # bounded (StructuredLogger's in-memory view is a ring
                # buffer), so an unqualified GET cannot grow unboundedly
                raw = parse_qs(url.query).get("n")
                try:
                    n = min(max(int(raw[0]), 0), len(events)) if raw else len(events)
                except ValueError:
                    n = len(events)
                body = json.dumps(
                    events[len(events) - n:], default=float
                ).encode()
                self._respond(200, body, "application/json")
            elif endpoint == "/tenants" or endpoint.startswith("/tenants/"):
                with ops._read_lock:
                    ring = (
                        ops.tenants_source()
                        if ops.tenants_source is not None
                        else None
                    )
                    if ring is None:
                        payload, code = {"error": "no fleet run attached"}, 404
                    elif endpoint == "/tenants":
                        payload, code = ring.overview(), 200
                    else:
                        name = endpoint[len("/tenants/"):]
                        detail = ring.detail(name)
                        if detail is None:
                            payload, code = {
                                "error": f"unknown tenant {name!r} "
                                         "(never seen, or evicted from "
                                         "the bounded summary ring)"
                            }, 404
                        else:
                            payload, code = detail, 200
                self._respond(
                    code,
                    json.dumps(payload, default=float).encode(),
                    "application/json",
                )
            elif endpoint == "/slo":
                with ops._read_lock:
                    table = (
                        ops.slo_source()
                        if ops.slo_source is not None
                        else None
                    )
                if table is None:
                    payload, code = {
                        "error": "slo plane disabled (start with --slo / "
                                 "an enabled [slo] block)"
                    }, 404
                else:
                    payload, code = {"slos": table}, 200
                self._respond(
                    code,
                    json.dumps(payload, default=float).encode(),
                    "application/json",
                )
            elif endpoint == "/query":
                if ops.query_source is None:
                    payload, code = {
                        "error": "slo plane disabled (start with --slo / "
                                 "an enabled [slo] block)"
                    }, 404
                else:
                    qs = parse_qs(url.query)
                    series = (qs.get("series") or [None])[0]
                    raw = qs.get("n")
                    try:
                        n = max(int(raw[0]), 0) if raw else None
                    except ValueError:
                        n = None
                    with ops._read_lock:
                        payload, code = ops.query_source(series, n)
                self._respond(
                    code,
                    json.dumps(payload, default=float).encode(),
                    "application/json",
                )
            elif endpoint == "/devices":
                with ops._read_lock:
                    overview = (
                        ops.devices_source()
                        if ops.devices_source is not None
                        else None
                    )
                if overview is None:
                    payload, code = {
                        "error": "no mesh plane attached (device "
                                 "telemetry runs with the dp fleet "
                                 "planes)"
                    }, 404
                else:
                    payload, code = overview, 200
                self._respond(
                    code,
                    json.dumps(payload, default=float).encode(),
                    "application/json",
                )
            elif endpoint == "/place":
                body = json.dumps(
                    {"error": "method not allowed: POST a placement "
                              "request to /place"}
                ).encode()
                self.send_response(405)
                self.send_header("Allow", "POST")
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif endpoint == "/profile":
                body = json.dumps(
                    {"error": "method not allowed: POST a capture "
                              "request to /profile"}
                ).encode()
                self.send_response(405)
                self.send_header("Allow", "POST")
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._respond(
                    404,
                    json.dumps(
                        {"error": "not found",
                         "endpoints": ["/metrics", "/healthz", "/events",
                                       "/tenants", "/tenants/<name>",
                                       "/place", "/slo", "/query",
                                       "/devices", "/profile"]}
                    ).encode(),
                    "application/json",
                )

        def do_POST(self) -> None:  # noqa: N802 — stdlib signature
            url = urlsplit(self.path)
            endpoint = url.path.rstrip("/") or "/"
            self._count(endpoint)
            if endpoint == "/profile":
                self._post_profile()
                return
            if endpoint != "/place":
                self._respond(
                    404,
                    json.dumps(
                        {"error": "not found",
                         "endpoints": ["/place", "/profile"]}
                    ).encode(),
                    "application/json",
                )
                return
            engine = (
                ops.serving_source()
                if ops.serving_source is not None
                else None
            )
            if engine is None:
                self._respond(
                    503,
                    json.dumps(
                        {"error": "no serving engine attached "
                                  "(start with serving enabled)"}
                    ).encode(),
                    "application/json",
                )
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length > 0 else b""
                payload = json.loads(raw.decode() or "{}")
                if not isinstance(payload, dict):
                    raise ValueError("request body must be a JSON object")
                service = payload.get("service")
                if not isinstance(service, str) or not service:
                    raise ValueError(
                        "missing required string field 'service'"
                    )
                deadline_ms = payload.get("deadline_ms")
                if deadline_ms is not None:
                    if isinstance(deadline_ms, bool) or not isinstance(
                        deadline_ms, (int, float)
                    ):
                        raise ValueError(
                            "'deadline_ms' must be a JSON number"
                        )
                    deadline_ms = float(deadline_ms)
            # TypeError joins the tuple as a backstop: the documented
            # contract is 400 on ANY malformed body, never a handler crash
            except (TypeError, ValueError, UnicodeDecodeError) as exc:
                self._respond(
                    400,
                    json.dumps({"error": str(exc)}).encode(),
                    "application/json",
                )
                return
            try:
                result = engine.place(service, deadline_ms=deadline_ms)
            except (ValueError, KeyError) as exc:
                # unknown service: a client error, nothing was submitted
                self._respond(
                    400,
                    json.dumps({"error": str(exc)}).encode(),
                    "application/json",
                )
                return
            # placed and no_candidate are both successful ANSWERS (the
            # latter a true "every valid node is hazardous" verdict);
            # shed/timeout mean the plane could not answer in time — 503
            # so open-loop clients and load balancers back off
            code = 200 if result.outcome in ("placed", "no_candidate") else 503
            self._respond(
                code,
                json.dumps(result.as_dict(), default=float).encode(),
                "application/json",
            )

        def _post_profile(self) -> None:
            if ops.profile_sink is None:
                self._respond(
                    503,
                    json.dumps(
                        {"error": "no profiler attached (profiler "
                                  "capture runs with the ops plane)"}
                    ).encode(),
                    "application/json",
                )
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length > 0 else b""
                payload = json.loads(raw.decode() or "{}")
                if not isinstance(payload, dict):
                    raise ValueError("request body must be a JSON object")
                rounds = payload.get("rounds", 1)
                if isinstance(rounds, bool) or not isinstance(rounds, int):
                    raise ValueError("'rounds' must be a JSON integer")
            # TypeError joins the tuple as a backstop: the documented
            # contract is 400 on ANY malformed body, never a handler crash
            except (TypeError, ValueError, UnicodeDecodeError) as exc:
                self._respond(
                    400,
                    json.dumps({"error": str(exc)}).encode(),
                    "application/json",
                )
                return
            result, code = ops.profile_sink(rounds)
            self._respond(
                code,
                json.dumps(result, default=float).encode(),
                "application/json",
            )

    return Handler


@dataclass
class OpsPlane:
    """Everything the live ops plane needs, in one handle the controller
    consumes: per-round observation fans out to the watchdog, the flight
    recorder, and the health state; breaker-open and crashes trigger
    bundle dumps.

    Feeds arrive from more than one thread once a serving engine is
    bound (the controller's round loop plus request-grain serving
    threads), and :class:`~.watchdog.Watchdog` is not itself
    thread-safe, so ONE plane-level lock serializes every
    ``watchdog.observe_*``/``rebase`` call — round-vs-serving as well as
    serving-vs-serving."""

    registry: MetricsRegistry | None = None
    logger: Any = None
    watchdog: Watchdog | None = None
    recorder: FlightRecorder | None = None
    health: HealthState = field(default_factory=HealthState)
    server: OpsServer | None = None
    # fleet mode: the bounded per-tenant summary store behind /tenants
    # (telemetry.fleet_rollup.TenantSummaryRing) and the latest decoded
    # rollup — breaker-open bundles ship both, scoped to the offender
    tenant_ring: Any = None
    latest_fleet_rollup: Any = field(default=None, repr=False)
    # serving mode: the engine behind POST /place (bind_serving attaches
    # it); its bounded recent-request ring rides breaker-open and
    # serving_p99 flight-recorder bundles
    serving_engine: Any = field(default=None, repr=False)
    # mesh mode: the device plane behind GET /devices (bind_mesh
    # attaches it) and the profiler gate behind POST /profile — the
    # gate is built by from_config whenever a flight-recorder bundle
    # dir exists, so captures always land next to the bundles that
    # reference them
    mesh_plane: Any = field(default=None, repr=False)
    profiler: Any = field(default=None, repr=False)
    # SLO v2: the bounded history plane (telemetry.timeseries.SeriesStore)
    # and the error-budget engine (telemetry.slo.SloEngine) — both None
    # unless [slo] is enabled; every observe_* tick samples the registry
    # host-side into the store and re-evaluates burn under the lock
    series_store: Any = field(default=None, repr=False)
    slo_engine: Any = field(default=None, repr=False)
    _slo_ticks: int = field(default=0, repr=False)
    span_tail: int = 12
    _prev_sigusr1: Any = field(default=None, repr=False)
    _sig_installed: bool = field(default=False, repr=False)
    # serializes every watchdog feed across the threads that issue them
    # (controller round loop, serving request threads, the bench harness)
    _watchdog_lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False
    )

    @classmethod
    def from_config(
        cls,
        obs,
        *,
        slo=None,
        registry: MetricsRegistry | None = None,
        logger=None,
        bundle_dir: str | None = None,
    ) -> "OpsPlane":
        """Build from a ``RescheduleConfig`` (the CLI/harness path): its
        flat fields carry the JAX package's ``obs`` block under the same
        names. ``slo`` optionally passes a ``config.SloConfig`` (default:
        ``obs.slo`` when the object has one) — an enabled one attaches the
        history plane + error-budget engine."""
        if slo is None:
            slo = getattr(obs, "slo", None)
        health = HealthState(max_round_age_s=obs.max_round_age_s)
        watchdog = Watchdog(
            SLORules(
                window=obs.slo_window,
                min_samples=obs.slo_min_samples,
                latency_p95_s=obs.slo_latency_p95_s,
                cost_regression_frac=obs.slo_cost_regression_frac,
                max_retraces=obs.slo_max_retraces,
                attribution_drift_frac=getattr(
                    obs, "attribution_drift_frac", 0.0
                ),
                forecast_min_skill=getattr(
                    obs, "slo_forecast_min_skill", 0.0
                ),
                pipeline_min_overlap=getattr(
                    obs, "slo_pipeline_min_overlap", 0.0
                ),
                reconcile_max_drift_pods=getattr(
                    obs, "slo_reconcile_drift_pods", 0
                ),
                shadow_min_win_rate=obs.slo_shadow_min_win_rate,
                fleet_tail_frac=getattr(obs, "slo_fleet_tail_frac", 0.0),
                scan_tripwire=getattr(obs, "slo_scan_tripwire", True),
                serving_p99_ms=getattr(obs, "slo_serving_p99_ms", 0.0),
                mesh_imbalance_ratio=getattr(
                    obs, "slo_mesh_imbalance_ratio", 0.0
                ),
            ),
            registry=registry,
            logger=logger,
        )
        recorder = FlightRecorder(
            capacity=obs.flight_recorder_rounds,
            bundle_dir=bundle_dir if bundle_dir is not None else obs.bundle_dir,
            registry=registry,
            logger=logger,
        )
        from kubernetes_rescheduling_tpu_torch.telemetry.fleet_rollup import (
            TenantSummaryRing,
        )

        series_store = slo_engine = None
        if slo is not None and getattr(slo, "enabled", False):
            from kubernetes_rescheduling_tpu_torch.telemetry.slo import (
                SloEngine,
                default_specs,
            )
            from kubernetes_rescheduling_tpu_torch.telemetry.timeseries import (
                SeriesStore,
            )

            series_store = SeriesStore(
                capacity=slo.series_capacity,
                max_series=slo.max_series,
                registry=registry,
            )
            slo_engine = SloEngine(
                default_specs(
                    objective=slo.objective,
                    latency_threshold_ms=slo.latency_threshold_ms,
                ),
                series_store,
                registry=registry,
                budget_window=slo.budget_window,
                fast_window=slo.fast_window,
                fast_burn=slo.fast_burn,
                slow_window=slo.slow_window,
                slow_burn=slo.slow_burn,
            )
        plane = cls(
            registry=registry,
            logger=logger,
            watchdog=watchdog,
            recorder=recorder,
            health=health,
            tenant_ring=TenantSummaryRing(),
            series_store=series_store,
            slo_engine=slo_engine,
        )
        # profiler captures land INSIDE the flight-recorder bundle dir:
        # the capture summary rides a bundle dump, and the artifact it
        # names sits next to the bundle that references it
        plane.profiler = ProfilerGate(
            registry,
            artifact_dir=(
                bundle_dir if bundle_dir is not None else obs.bundle_dir
            ),
            max_captures=getattr(obs, "profile_max_captures", 4),
            max_mb=getattr(obs, "profile_max_mb", 256.0),
            recorder=recorder,
            logger=logger,
        )
        profile_rounds = int(getattr(obs, "profile_rounds", 0) or 0)
        if profile_rounds > 0:
            # --profile-rounds N arms one capture before the loop starts
            plane.profiler.request(rounds=profile_rounds)
        if obs.serve_port is not None:
            plane.server = OpsServer(
                port=obs.serve_port,
                registry=registry,
                health=health,
                events_source=plane._events,
                tenants_source=plane._tenants,
                serving_source=plane._serving,
                slo_source=plane._slo_table,
                query_source=plane._series_query,
                devices_source=plane._devices,
                profile_sink=plane._profile,
            )
        return plane

    def _events(self) -> list[dict]:
        return self.logger.records if self.logger is not None else []

    def _serving(self):
        """The POST /place source: the bound serving engine, if any."""
        return self.serving_engine

    def _tenants(self):
        """The /tenants source: the ring once a fleet run has fed it
        (a solo run's empty ring reads as 'no fleet attached')."""
        ring = self.tenant_ring
        return ring if ring is not None and len(ring) else None

    def _devices(self):
        """The /devices source: the bound mesh plane's per-device
        overview (None — mapped to 404 — until a dp fleet run binds
        one)."""
        plane = self.mesh_plane
        return plane.overview() if plane is not None else None

    def _profile(self, rounds):
        """The POST /profile sink: (payload, http code). Arms one
        capture on the gate — 503 with no gate, 400 on a bad round
        count, 409 (with the gate's status) when a capture is already
        pending/active or the per-run budget is spent."""
        gate = self.profiler
        if gate is None:
            return {
                "error": "no profiler attached (profiler capture runs "
                         "with the ops plane)"
            }, 503
        try:
            return gate.request(rounds=rounds), 200
        except ValueError as exc:
            return {"error": str(exc)}, 400
        except (ProfilerBusy, ProfilerExhausted) as exc:
            return {"error": str(exc), "status": gate.status()}, 409

    def _slo_table(self):
        """The /slo source: the engine's last budget/burn evaluation
        (None when the slo plane is off, which the handler maps to 404)."""
        if self.slo_engine is None:
            return None
        with self._watchdog_lock:
            return self.slo_engine.table()

    def _series_query(self, series, n):
        """The /query source: (payload, http code). A bare /query lists
        the retained series names (bounded by max_series); naming one
        returns its last ``n`` ring points. Reads under the watchdog
        lock — the same lock every sampling tick holds — so an HTTP
        walk never races a concurrent eviction."""
        store = self.series_store
        if store is None:
            return {
                "error": "slo plane disabled (start with --slo / an "
                         "enabled [slo] block)"
            }, 404
        with self._watchdog_lock:
            if not series:
                return {"series": store.names()}, 200
            try:
                pts = store.query(series, n)
            except KeyError:
                return {
                    "error": f"unknown series {series!r} (never sampled, "
                             "or evicted by the series budget)"
                }, 404
            return {
                "series": series,
                "points": [[t, v] for t, v in pts],
            }, 200

    def _slo_tick_locked(self) -> list[dict]:
        """One history-plane tick — caller MUST hold ``_watchdog_lock``.
        Samples the registry snapshot (host-side values only: zero
        device transfers by construction) into the store, re-evaluates
        every SLO's budget/burn, and feeds the firing burn rules to the
        watchdog. Returns the newly raised violations so the caller can
        dump page bundles OUTSIDE the lock."""
        if self.slo_engine is None or self.series_store is None:
            return []
        self._slo_ticks += 1
        tick = self._slo_ticks
        reg = (
            self.registry
            if self.registry is not None
            else get_registry()
        )
        self.series_store.sample(reg.snapshot(), tick)
        entries = self.slo_engine.evaluate(tick)
        if self.watchdog is None:
            return []
        return self.watchdog.observe_slo_burn(entries)

    def _dump_burn_pages(self, newly: list[dict]) -> None:
        """Page-level burn entry dumps a flight-recorder bundle — file
        I/O, so called outside the lock with the exactly-once ``newly``
        list (the serving_p99 dump's no-double-dump discipline)."""
        if self.recorder is None:
            return
        for violation in newly:
            if violation.get("rule") == RULE_FAST_BURN:
                self.recorder.dump(
                    "slo_burn_page",
                    slo=dict(violation),
                    table=(
                        self._slo_table() or []
                    ),
                )

    # ---- lifecycle ----

    def start(self) -> "OpsPlane":
        self.health.watchdog = self.watchdog
        if self.server is not None:
            if self.server.health is None:
                self.server.health = self.health
            if self.server.events_source is None:
                self.server.events_source = self._events
            if self.server.tenants_source is None:
                self.server.tenants_source = self._tenants
            if self.server.serving_source is None:
                self.server.serving_source = self._serving
            if self.server.slo_source is None:
                self.server.slo_source = self._slo_table
            if self.server.query_source is None:
                self.server.query_source = self._series_query
            if self.server.devices_source is None:
                self.server.devices_source = self._devices
            if self.server.profile_sink is None:
                self.server.profile_sink = self._profile
            self.server.start()
        if (
            self.recorder is not None
            and threading.current_thread() is threading.main_thread()
            and not self._sig_installed
        ):
            try:
                self._prev_sigusr1 = signal.signal(
                    signal.SIGUSR1,
                    lambda signum, frame: self.recorder.dump("sigusr1"),
                )
                self._sig_installed = True
            except (ValueError, OSError, AttributeError):
                pass  # non-main thread / platform without SIGUSR1
        return self

    def close(self) -> None:
        if self.server is not None:
            self.server.stop()
        if self._sig_installed:
            try:
                signal.signal(signal.SIGUSR1, self._prev_sigusr1 or signal.SIG_DFL)
            except (ValueError, OSError):
                pass
            self._sig_installed = False

    def __enter__(self) -> "OpsPlane":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- controller hooks ----

    def bind(self, *, breaker=None, logger=None, algorithm=None) -> None:
        """Attach the current run's breaker/logger/algorithm (the plane
        can outlive a single run — the bench harness reuses one across
        matrix cells)."""
        if breaker is not None:
            self.health.breaker = breaker
        if logger is not None:
            self.logger = logger
            if self.watchdog is not None:
                self.watchdog.logger = logger
            if self.recorder is not None:
                self.recorder.logger = logger
        if algorithm is not None:
            self.health.algorithm = algorithm
        self.health.watchdog = self.watchdog
        if self.watchdog is not None:
            # a new run binding = a fresh observation window: another
            # cell's cost scale or a new shape's first compile must not
            # read as an SLO violation
            with self._watchdog_lock:
                self.watchdog.rebase()

    def observe_round(self, record, state=None, events=(), tenant=None) -> None:
        self.health.rounds += 1
        self.health.mark_round()
        if record.degraded:
            self.health.degraded_rounds += 1
        newly_burn: list[dict] = []
        with self._watchdog_lock:
            if self.watchdog is not None:
                self.watchdog.observe_round(record, tenant=tenant)
            newly_burn = self._slo_tick_locked()
        self._dump_burn_pages(newly_burn)
        if self.recorder is not None:
            spans = [
                {
                    "name": ev.name,
                    "dur_us": ev.dur_us,
                    "depth": ev.depth,
                    "args": ev.args,
                }
                for ev in get_tracer().tail(self.span_tail)
            ]
            self.recorder.record_round(
                round=record.round,
                digest=state_digest(state) if state is not None else None,
                record=record.as_dict(),
                events=list(events),
                spans=spans,
            )

    def observe_scan_block(
        self, *, rounds: int, trip: dict | None = None
    ) -> None:
        """One scan block's replay finished: update the /healthz scan
        summary, clear the in-flight staleness scaling, and feed the
        watchdog's ``scan_tripwire`` rule (a clean block — ``trip=None``
        — clears it). A tripped block additionally dumps a
        flight-recorder bundle scoped to the partial block: the trip
        dict carries the trip round and decoded rule bitmask, and the
        ring holds exactly the rounds the replay committed."""
        scan = self.health.scan
        if scan is None:
            scan = self.health.scan = {
                "block": int(rounds),
                "blocks": 0,
                "tripped_blocks": 0,
                "last_trip": None,
                "drains": {},
            }
        scan["block"] = int(rounds)
        scan["blocks"] += 1
        self.health.mark_block_done()
        if trip is not None:
            scan["tripped_blocks"] += 1
            scan["last_trip"] = dict(trip)
            if self.recorder is not None:
                self.recorder.dump("scan_tripwire", trip=dict(trip))
        if self.watchdog is not None:
            with self._watchdog_lock:
                self.watchdog.observe_scan_block(trip)

    def observe_scan_drain(self, reason: str) -> None:
        """One round drained from the scanned schedule to the per-round
        path: the /healthz scan summary's reason breakdown (the metric
        twin is ``scan_drains_total{reason}``)."""
        scan = self.health.scan
        if scan is None:
            scan = self.health.scan = {
                "block": None,
                "blocks": 0,
                "tripped_blocks": 0,
                "last_trip": None,
                "drains": {},
            }
        drains = scan["drains"]
        drains[reason] = drains.get(reason, 0) + 1

    def bind_serving(self, engine) -> None:
        """Attach a serving engine: it becomes the POST /place source,
        its summaries flow to /healthz and the ``serving_p99`` watchdog
        rule via :meth:`observe_serving`, and its recent-request ring
        rides breaker-open bundles."""
        self.serving_engine = engine
        engine.ops = self

    def bind_mesh(self, mesh_plane) -> None:
        """Attach the run's device plane (``telemetry.mesh.MeshPlane``):
        it becomes the GET /devices source, and its per-block summaries
        flow to the /healthz ``mesh`` stanza and the ``mesh_imbalance``
        watchdog rule via :meth:`observe_device_rollup`."""
        self.mesh_plane = mesh_plane

    def observe_device_rollup(
        self, summary: dict | None, event: dict | None = None
    ) -> None:
        """Feed one block's device-axis summary (the dp fleet loop calls
        this after every decoded pull): updates the /healthz ``mesh``
        stanza and judges the ``mesh_imbalance`` rule. The named-device
        ``event`` payload stays out of the watchdog (names are event/
        endpoint data, never label or rule state)."""
        newly_burn: list[dict] = []
        with self._watchdog_lock:
            plane = self.mesh_plane
            self.health.mesh = (
                plane.health_block()
                if plane is not None
                else (dict(summary) if summary is not None else None)
            )
            if self.watchdog is not None:
                self.watchdog.observe_mesh(summary)
                newly_burn = self._slo_tick_locked()
        self._dump_burn_pages(newly_burn)

    def bind_tenant_series(self, tseries) -> None:
        """Fleet mode: attach the run's ``TenantSeries`` cardinality
        gate so per-tenant SLO budget gauges publish through it —
        bit-identical at or under the label budget, suppressed and
        counted over it. No-op when the slo plane is off."""
        if self.slo_engine is not None:
            with self._watchdog_lock:
                self.slo_engine.tenant_series = tseries

    def observe_serving(
        self, summary: dict | None, requests: list | None = None
    ) -> None:
        """Feed the serving plane's rolling summary (the engine calls
        this after every dispatched batch and admission-time shed):
        updates the /healthz ``serving`` stanza, judges the
        ``serving_p99`` rule, and — the moment the rule ENTERS violation
        — dumps a flight-recorder bundle carrying the summary plus the
        in-flight request ring (the evidence an operator needs while the
        tail spike is still in memory)."""
        with self._watchdog_lock:
            self.health.serving = (
                dict(summary) if summary is not None else None
            )
            if self.watchdog is None:
                return
            newly = self.watchdog.observe_serving(summary)
            # the history-plane tick rides the SAME lock hold: burn is
            # judged on the state that includes this batch's counters,
            # so a fast burn can page on the very feed that crossed it
            newly += self._slo_tick_locked()
        # the bundle dump (file I/O) happens outside the lock: `newly`
        # reports rule ENTRY exactly once, so concurrent feeders cannot
        # double-dump
        for violation in newly:
            if (
                violation.get("rule") == "serving_p99"
                and self.recorder is not None
            ):
                self.recorder.dump(
                    "serving_p99",
                    serving=dict(summary or {}),
                    requests=list(requests or []),
                )
        self._dump_burn_pages(newly)

    def observe_perf(self, verdicts: dict) -> None:
        """Feed a perf-ledger verdict set (``perf_ledger.detect``): arms/
        clears the watchdog's ``perf_regression`` rule and records the
        latest verdict summary on ``/healthz`` (the bench harness calls
        this after each cell's ledger append)."""
        statuses = sorted(
            (k, v.get("status")) for k, v in (verdicts or {}).items()
        )
        regressed = [k for k, s in statuses if s == "regressed"]
        self.health.perf = {
            "verdict": "regressed" if regressed else "ok",
            "regressed": regressed,
            "series": dict(statuses),
        }
        if self.watchdog is not None:
            with self._watchdog_lock:
                self.watchdog.observe_perf(verdicts)

    def observe_fleet_rollup(self, rollup: dict, event: dict | None = None) -> None:
        """Feed one fleet round's decoded tenant rollup
        (``telemetry.fleet_rollup.decode_rollup``): arms the watchdog's
        ``fleet_tail_cost`` rule and keeps the latest named event
        payload for breaker-open bundles and the over-budget
        ``/healthz`` fleet summary."""
        self.latest_fleet_rollup = event if event is not None else rollup
        newly_burn: list[dict] = []
        with self._watchdog_lock:
            if self.watchdog is not None:
                self.watchdog.observe_fleet_rollup(rollup)
            newly_burn = self._slo_tick_locked()
        self._dump_burn_pages(newly_burn)

    def observe_tenant(
        self,
        tenant: str,
        *,
        record: dict | None = None,
        breaker: str | None = None,
        drift: int | None = None,
        skipped: bool = False,
    ) -> None:
        """Update one tenant's row in the bounded summary ring (the
        /tenants drill-down source). No-op when the plane has no ring
        (a hand-built plane). With the slo plane attached, the round
        also accounts against the tenant's per-tenant error budget
        (published through the TenantSeries cardinality gate)."""
        if self.tenant_ring is not None:
            self.tenant_ring.observe(
                tenant,
                record=record,
                breaker=breaker,
                drift=drift,
                skipped=skipped,
            )
        if self.slo_engine is not None and (record is not None or skipped):
            ok = not skipped and not bool((record or {}).get("degraded"))
            with self._watchdog_lock:
                self.slo_engine.observe_tenant_round(tenant, ok)

    def observe_skip(self, rnd: int, breaker_state: str | None = None) -> None:
        self.health.skipped_rounds += 1
        self.health.mark_round()
        if self.recorder is not None:
            self.recorder.record_skip(rnd, breaker=breaker_state)

    def on_breaker_transition(self, rec: dict) -> None:
        """Wired to ``CircuitBreaker.on_transition``: an OPEN transition
        dumps a bundle — the moment an operator will want the last N
        rounds, captured while they are still in memory. A fleet
        tenant's transition (the fleet loop tags ``rec["tenant"]``)
        ships the latest fleet rollup plus ONLY the offending tenant's
        summary-ring entry — the bounded-bundle discipline: never all T
        tenants' state for one tenant's incident."""
        if rec.get("to") == "open" and self.recorder is not None:
            extra: dict[str, Any] = {}
            tenant = rec.get("tenant")
            if tenant is not None:
                if self.latest_fleet_rollup is not None:
                    extra["fleet_rollup"] = self.latest_fleet_rollup
                if self.tenant_ring is not None:
                    summary = self.tenant_ring.detail(tenant)
                    if summary is not None:
                        extra["tenant_summary"] = summary
            if self.serving_engine is not None:
                # an open breaker starves the serving snapshot too —
                # capture what the plane had in flight at that moment
                extra["serving_requests"] = self.serving_engine.ring()
            self.recorder.dump("breaker_open", transition=rec, **extra)

    def on_crash(self, exc: BaseException) -> None:
        if self.recorder is not None:
            self.recorder.dump("crash", error=repr(exc))
