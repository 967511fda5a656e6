"""The port's registry, spans, manifest and profiler gate: the JAX cases of
tests/test_telemetry.py (registry exposition, series identity, histogram
accuracy, span nesting and export, the logger's ring) and of
tests/test_mesh.py (the ``ProfilerGate`` and the ``/profile`` and
``/devices`` endpoints) run against the port, each the JAX test's own
function re-bound to the port's names (``test_torch_slo.on_port``); plus
the port's own: ``span(profile_dir=...)`` and the gate's real backend
write a ``torch.profiler`` Chrome trace, the manifest reports torch, CUDA
and the card where the JAX one reports jax, and the spans of the loop
carry the JAX package's names.

Left out of the JAX files: ``instrument_jit``, ``publish_round_telemetry``
and ``pull`` of jax arrays (the port's capture counter and ``pull`` are
covered by tests/test_torch_compiled.py), the jax manifest keys, and the
mesh plane (``MeshPlane``, ``DeviceSeries``: tests/test_torch_mesh.py). ``LatencyHistogram``,
the report and the CLI cases are tests/test_torch_report.py's.
"""

import json

import pytest
import test_mesh as jmesh_cases
import test_telemetry as jtel_cases
from test_torch_slo import on_port, run_case

from kubernetes_rescheduling_tpu_torch import config as tconfig
from kubernetes_rescheduling_tpu_torch import telemetry as ttel
from kubernetes_rescheduling_tpu_torch.backends.sim import LoadModel as TLoad
from kubernetes_rescheduling_tpu_torch.backends.sim import SimBackend as TSim
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend as t_make
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.core.workmodel import mubench_workmodel_c
from kubernetes_rescheduling_tpu_torch.telemetry import mesh as tmesh
from kubernetes_rescheduling_tpu_torch.telemetry import registry as tregistry
from kubernetes_rescheduling_tpu_torch.telemetry import server as tserver
from kubernetes_rescheduling_tpu_torch.telemetry import spans as tspans
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger as TLogger

TELEMETRY_NAMES = {
    "MetricsRegistry": ttel.MetricsRegistry, "Tracer": ttel.Tracer,
    "get_registry": ttel.get_registry, "set_registry": ttel.set_registry,
    "set_tracer": ttel.set_tracer, "span": ttel.span, "timed_call": ttel.timed_call,
    "write_manifest": ttel.write_manifest, "run_manifest": ttel.run_manifest,
    "Histogram": tregistry.Histogram, "StructuredLogger": TLogger,
    "SimBackend": lambda **kw: TSim(device="cpu", **kw), "LoadModel": TLoad,
    "mubench_workmodel_c": mubench_workmodel_c,
}
TELEMETRY_CASES = ("test_exposition_format", "test_label_escaping",
                   "test_labeled_series_identity", "test_registry_get_or_create_conflicts",
                   "test_counter_monotone", "test_histogram_percentiles_vs_numpy",
                   "test_span_nesting_and_chrome_roundtrip", "test_tracer_bounded",
                   "test_structured_logger_ring_buffer")
MESH_NAMES = {
    "ObsConfig": tconfig.RescheduleConfig, "OpsPlane": tserver.OpsPlane,
    "OpsServer": tserver.OpsServer, "ProfilerGate": tmesh.ProfilerGate,
    "ProfilerBusy": tmesh.ProfilerBusy, "ProfilerExhausted": tmesh.ProfilerExhausted,
    "StructuredLogger": TLogger, "MetricsRegistry": ttel.MetricsRegistry,
    "get_registry": ttel.get_registry, "set_registry": ttel.set_registry,
}
MESH_CASES = ("test_profiler_gate_lifecycle_and_caps",
              "test_profiler_gate_oversize_artifact_is_deleted",
              "test_profiler_gate_start_failure_counts_error",
              "test_scan_block_rounds_up_capture_span", "test_from_config_arms_profile_rounds",
              "TestMeshEndpoints.test_profile_get_is_405_post_arms",
              "TestMeshEndpoints.test_profile_post_validates_rounds",
              "TestMeshEndpoints.test_profile_503_without_gate")


@pytest.fixture()
def registry():
    prev = ttel.set_registry(ttel.MetricsRegistry())
    try:
        yield ttel.get_registry()
    finally:
        ttel.set_registry(prev)


@pytest.fixture()
def tracer():
    tr = ttel.Tracer()
    prev = ttel.set_tracer(tr)
    try:
        yield tr
    finally:
        ttel.set_tracer(prev)


@pytest.mark.parametrize("case", TELEMETRY_CASES)
def test_telemetry_case_on_port(case, registry, tracer, tmp_path):
    run_case(on_port(jtel_cases, TELEMETRY_NAMES), case,
             {"registry": registry, "tracer": tracer, "tmp_path": tmp_path})


def _mesh_case(name):
    """The JAX mesh case ``name`` (``Class.method`` for a method) on the
    port, and its parameters."""
    import inspect

    cases = on_port(jmesh_cases, MESH_NAMES)
    if "." not in name:
        fn = cases[name]
        return fn, inspect.signature(fn).parameters
    cls_name, meth = name.split(".")
    fn = getattr(cases[cls_name], meth)
    rebound = type(fn)(fn.__code__, cases, fn.__name__, fn.__defaults__, fn.__closure__)
    params = [p for p in inspect.signature(rebound).parameters if p != "self"]
    return (lambda **kw: rebound(None, **kw)), params


@pytest.mark.parametrize("case", MESH_CASES)
def test_profiler_case_on_port(case, registry, tmp_path):
    fn, params = _mesh_case(case)
    fixtures = {"registry": registry, "tmp_path": tmp_path}
    fn(**{p: fixtures[p] for p in params})


def test_devices_answers_404_until_a_mesh_plane_binds(registry):
    """/devices answers 404 until a dp run binds a mesh plane, as in the JAX
    package (tests/test_torch_mesh.py serves one after the bind)."""
    plane = tserver.OpsPlane.from_config(TConfig(serve_port=0), registry=registry,
                                         bundle_dir=None).start()
    try:
        code, body = jmesh_cases._get(plane.server.port, "/devices")
        assert code == 404 and b"no mesh plane" in body
    finally:
        plane.close()


def test_span_profile_dir_writes_a_torch_profiler_trace(registry, tracer, tmp_path):
    """``span(..., profile_dir=...)`` records the span and runs the region
    under ``torch.profiler``: a Chrome trace lands in the directory."""
    import torch

    with tspans.span("outer", profile_dir=str(tmp_path / "prof")):
        torch.ones(8).sum()
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert doc["traceEvents"]
    assert [e.name for e in tracer.events] == ["outer"]


def test_profiler_gate_real_backend_writes_an_artifact(registry, tmp_path):
    gate = tmesh.ProfilerGate(registry, artifact_dir=str(tmp_path), max_captures=1)
    gate.request(rounds=2)
    assert gate.maybe_start(label="scan_block", rounds=2, round=1)
    import torch

    torch.arange(16).float().sum()
    gate.advance(2)
    (cap,) = gate.status()["captures"]
    assert cap["status"] == "ok" and cap["bytes"] > 0
    assert (tmp_path / "profile_000" / "trace.json").is_file()
    assert registry.value("profile_captures_total", status="ok") == 1


def test_manifest_reports_torch(tmp_path):
    m = ttel.write_manifest(tmp_path / "run.manifest.json", {"algo": "global"})
    on_disk = json.loads((tmp_path / "run.manifest.json").read_text())
    assert on_disk["config"] == {"algo": "global"}
    for key in ("timestamp", "argv", "python", "platform", "torch", "numpy", "git",
                "device_costs", "attribution"):
        assert key in on_disk, key
    import torch

    assert m["torch"]["version"] == torch.__version__
    assert m["torch"]["cuda_available"] == torch.cuda.is_available()
    assert len(m["torch"]["devices"]) == (torch.cuda.device_count()
                                          if torch.cuda.is_available() else 0)
    # the compiled-cost book (empty on the CPU, where nothing is captured)
    assert m["device_costs"]["kernels"] == ttel.get_costbook().as_dict()
    assert "jax" not in m


def test_loop_spans_carry_the_jax_names(registry, tracer):
    """A greedy, a global and a scanned run record the JAX package's span
    names at their counterpart sites, each round under
    ``controller/round``."""
    def backend():
        b = t_make("mubench", 0, device="cpu")
        b.inject_imbalance(b.node_names[0])
        return b

    t_run(backend(), TConfig(max_rounds=2, sleep_after_action_s=0.0), device="cpu")
    t_run(backend(), TConfig(algorithm="global", max_rounds=1, sleep_after_action_s=0.0),
          device="cpu")
    t_run(backend(), TConfig(max_rounds=2, scan_block=2, sleep_after_action_s=0.0),
          device="cpu")
    names = [e.name for e in tracer.events]
    for name in ("controller/round", "backend/monitor", "controller/decide",
                 "controller/global_solve", "controller/scan_block"):
        assert name in names, name
    rounds = [e for e in tracer.events if e.name == "controller/round"]
    assert len(rounds) == 3 and all(e.depth == 0 for e in rounds)
    decides = [e for e in tracer.events if e.name == "controller/decide"]
    assert decides and all(e.depth == 1 for e in decides)
    assert registry.histogram("span_seconds", labelnames=("span",)).labels(
        span="controller/round").count == 3
