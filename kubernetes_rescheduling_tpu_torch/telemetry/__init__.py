"""Telemetry of the port — the counterpart of
``kubernetes_rescheduling_tpu.telemetry``:

- :mod:`registry` — labeled ``Counter``/``Gauge``/``Histogram`` series with
  Prometheus text exposition and a JSONL sink;
- :mod:`spans` — nested host-side spans exported as Chrome trace-event
  JSON, with ``torch.profiler`` folded in (``span(..., profile_dir=...)``);
  hot spans on the replay path record only while tracing is on;
- :mod:`phases` — timed phases inside a solve body (event nodes of its
  captured graph on the card), read without a wait;
- :mod:`accounting` — counted device→host transfers (``pull``) and the
  boundary's call timings;
- :mod:`manifest` — per-run provenance (config, torch, CUDA, the card, git
  rev);
- :mod:`explain` and :mod:`attribution` — decision explanations, and the
  per-edge / node-pair decomposition of the cost with its move provenance;
- :mod:`fleet_rollup` — device-side tenant rollups and the tenant-label
  budget;
- :mod:`flight_recorder`, :mod:`watchdog`, :mod:`timeseries`, :mod:`slo`,
  :mod:`mesh` (the mesh plane over the dp fleet planes —
  :class:`MeshPlane`, :class:`DeviceSeries` — and the profiler gate) and
  :mod:`server` — the live ops plane:
  ``/metrics``, ``/healthz``, ``/events``, ``/tenants``, ``POST /place``,
  ``/slo``, ``/query``, ``/devices``, ``POST /profile``, and the :class:`OpsPlane` the
  loops consume.

- :mod:`costmodel` — the compiled-cost book of the captured graphs, the
  roofline and device-memory gauges;
- :mod:`perf_ledger` — the append-only perf ledger and its rolling-window
  regression detector;
- :mod:`report` — the ``telemetry`` command's renderings of a run's
  artifacts.
"""

from kubernetes_rescheduling_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from kubernetes_rescheduling_tpu_torch.telemetry.spans import (
    Tracer,
    get_tracer,
    set_tracer,
    span,
    trace_to,
)
from kubernetes_rescheduling_tpu_torch.telemetry.accounting import (
    count_reconcile,
    publish_round_telemetry,
    pull,
    timed_call,
)
from kubernetes_rescheduling_tpu_torch.telemetry.costmodel import (
    CostBook,
    get_costbook,
    sample_device_memory,
)
from kubernetes_rescheduling_tpu_torch.telemetry.perf_ledger import PerfLedger
from kubernetes_rescheduling_tpu_torch.telemetry.manifest import (
    run_manifest,
    write_manifest,
)
from kubernetes_rescheduling_tpu_torch.telemetry.explain import (
    explanation_consistent,
)
from kubernetes_rescheduling_tpu_torch.telemetry.attribution import (
    AttributionBook,
    PlacementTimeline,
    attribution_consistent,
    get_attribution_book,
)
from kubernetes_rescheduling_tpu_torch.telemetry.fleet_rollup import (
    TenantSeries,
    TenantSummaryRing,
)
from kubernetes_rescheduling_tpu_torch.telemetry.mesh import (
    DeviceSeries,
    MeshPlane,
    ProfilerGate,
)
from kubernetes_rescheduling_tpu_torch.telemetry.flight_recorder import FlightRecorder
from kubernetes_rescheduling_tpu_torch.telemetry.server import (
    HealthState,
    OpsPlane,
    OpsServer,
)
from kubernetes_rescheduling_tpu_torch.telemetry.watchdog import SLORules, Watchdog

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
    "Tracer",
    "get_tracer",
    "set_tracer",
    "span",
    "trace_to",
    "count_reconcile",
    "pull",
    "publish_round_telemetry",
    "timed_call",
    "CostBook",
    "get_costbook",
    "sample_device_memory",
    "PerfLedger",
    "DeviceSeries",
    "MeshPlane",
    "run_manifest",
    "write_manifest",
    "ProfilerGate",
    "TenantSeries",
    "TenantSummaryRing",
    "explanation_consistent",
    "AttributionBook",
    "PlacementTimeline",
    "attribution_consistent",
    "get_attribution_book",
    "FlightRecorder",
    "HealthState",
    "OpsPlane",
    "OpsServer",
    "SLORules",
    "Watchdog",
]
