"""The mesh and device plane in the port (``telemetry/mesh.py``, its wiring
into the ops plane, the watchdog and the dp fleet loop): the cases of
tests/test_mesh.py:87-457 — the device rollup against a numpy twin, the
dispatch attribution, the ``DeviceSeries`` budget, ``MeshPlane``, the
``mesh_imbalance`` rule and ``/devices`` — each the JAX test's own function
re-bound to the port's names (``test_torch_slo.on_port``); the port's
rollup and attribution against the JAX package's on the same inputs
(exactly: both are numpy on the host); and a dp fleet run on the CPU that
serves ``/devices`` and feeds the rule. The profiler-gate cases of the same
JAX file are tests/test_torch_telemetry.py's.
"""

import inspect
import json

import numpy as np
import pytest
import test_mesh as jmesh_cases
from test_torch_fleet import fleets
from test_torch_slo import on_port

from kubernetes_rescheduling_tpu.telemetry import mesh as jmesh
from kubernetes_rescheduling_tpu_torch import config as tconfig
from kubernetes_rescheduling_tpu_torch import telemetry as ttel
from kubernetes_rescheduling_tpu_torch.bench.fleet import run_fleet_controller
from kubernetes_rescheduling_tpu_torch.config import FleetConfig, RescheduleConfig
from kubernetes_rescheduling_tpu_torch.telemetry import mesh as tmesh
from kubernetes_rescheduling_tpu_torch.telemetry import server as tserver
from kubernetes_rescheduling_tpu_torch.telemetry import watchdog as twatchdog
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger as TLogger

NAMES = {
    "ObsConfig": tconfig.RescheduleConfig,
    "DeviceSeries": tmesh.DeviceSeries, "MeshPlane": tmesh.MeshPlane,
    "MetricsRegistry": ttel.MetricsRegistry, "OpsPlane": tserver.OpsPlane,
    "OpsServer": tserver.OpsServer, "ProfilerGate": tmesh.ProfilerGate,
    "SLORules": twatchdog.SLORules, "Watchdog": twatchdog.Watchdog,
    "get_registry": ttel.get_registry, "set_registry": ttel.set_registry,
    "DEVICE_DIMS": tmesh.DEVICE_DIMS, "DEVICE_QUANTS": tmesh.DEVICE_QUANTS,
    "ProfilerBusy": tmesh.ProfilerBusy, "ProfilerExhausted": tmesh.ProfilerExhausted,
    "attribute_dispatch": tmesh.attribute_dispatch,
    "decode_device_rollup": tmesh.decode_device_rollup,
    "device_rollup_event": tmesh.device_rollup_event,
    "device_rollup_matrix": tmesh.device_rollup_matrix,
    "device_rollup_size": tmesh.device_rollup_size,
    "RULE_MESH": twatchdog.RULE_MESH, "StructuredLogger": TLogger,
}
CASES = ("test_device_rollup_matches_numpy_twin", "test_device_rollup_tie_order_is_stable",
         "test_device_rollup_shape_errors", "test_attribute_dispatch_weighted_and_fallbacks",
         "test_device_series_budget_gates_and_counts",
         "test_mesh_plane_publishes_bounded_rollup",
         "test_mesh_plane_health_and_overview_accumulate",
         "test_mesh_plane_over_budget_suppresses_device_series",
         "test_event_payload_is_json_serializable",
         "test_mesh_imbalance_rule_fires_and_recovers",
         "test_mesh_imbalance_rule_ignores_single_device_and_off",
         "test_mesh_imbalance_rule_clears_on_rebase", "test_mesh_imbalance_threshold_validates",
         "TestMeshEndpoints.test_devices_404_until_mesh_bound_then_serves",
         "test_observe_device_rollup_feeds_health_and_watchdog")


@pytest.fixture()
def registry():
    prev = ttel.set_registry(ttel.MetricsRegistry())
    try:
        yield ttel.get_registry()
    finally:
        ttel.set_registry(prev)


def mesh_case(name):
    """The JAX case ``name`` (``Class.method`` for a method) on the port,
    and its parameter names."""
    cases = on_port(jmesh_cases, NAMES)
    if "." not in name:
        fn = cases[name]
        return fn, list(inspect.signature(fn).parameters)
    cls_name, meth = name.split(".")
    fn = getattr(cases[cls_name], meth)
    rebound = type(fn)(fn.__code__, cases, fn.__name__, fn.__defaults__, fn.__closure__)
    params = [p for p in inspect.signature(rebound).parameters if p != "self"]
    return (lambda **kw: rebound(None, **kw)), params


@pytest.mark.parametrize("case", CASES)
def test_mesh_case_on_port(case, registry):
    fn, params = mesh_case(case)
    fn(**{p: {"registry": registry}[p] for p in params})


@pytest.mark.parametrize("n,k", [(1, 1), (4, 2), (8, 3), (13, 5)])
def test_rollup_and_attribution_equal_jax(n, k):
    """The port's rollup vector, its decode and the dispatch attribution
    against the JAX package's on the same seeded inputs, exactly."""
    rng = np.random.default_rng(n)
    m = rng.uniform(0.0, 40.0, (n, len(tmesh.DEVICE_DIMS))).astype(np.float32)
    m[:, 1] = np.round(m[:, 1])  # ties on one dimension
    flat = tmesh.device_rollup_matrix(m, worst_k=k)
    np.testing.assert_array_equal(flat, jmesh.device_rollup_matrix(m, worst_k=k))
    assert tmesh.decode_device_rollup(flat, worst_k=k) == jmesh.decode_device_rollup(flat,
                                                                                    worst_k=k)
    assert tmesh.device_rollup_size(k) == jmesh.device_rollup_size(k)
    w = rng.uniform(0.0, 5.0, 2 * n)
    np.testing.assert_array_equal(tmesh.attribute_dispatch(0.25, w, n=n),
                                  jmesh.attribute_dispatch(0.25, w, n=n))
    names = [f"cuda:{i}" for i in range(n)]
    rollup = tmesh.decode_device_rollup(flat, worst_k=k)
    assert tmesh.device_rollup_event(rollup, names, round=3) == \
        jmesh.device_rollup_event(rollup, names, round=3)


def test_hbm_column_from_the_gather(registry):
    """The HBM column takes the per-device values the dp plane gathered;
    without them (or with memory sampling off) it samples this process's
    cards, none on the CPU."""
    plane = tmesh.MeshPlane(registry, device_names=["cuda:0", "cuda:1"])
    plane.observe_block(dispatch_s=0.01, transfer_bytes=0, hbm_mb=[512.0, 1024.0])
    assert [d["hbm_mb"] for d in plane.overview()["devices"]] == [512.0, 1024.0]
    assert registry.gauge("mesh_hbm_mb_quantile", labelnames=("q",)).labels(
        q="max").value == 1024.0
    plane.observe_block(dispatch_s=0.01, transfer_bytes=0)
    assert [d["hbm_mb"] for d in plane.overview()["devices"]] == [0.0, 0.0]
    off = tmesh.MeshPlane(registry, device_names=["a"], sample_memory=False)
    off.observe_block(dispatch_s=0.01, transfer_bytes=0, hbm_mb=[5.0])
    assert off.overview()["devices"][0]["hbm_mb"] == 0.0
    assert tmesh.rank_hbm_mb("cpu") == 0.0


def test_dp_fleet_run_serves_devices_and_feeds_the_rule(registry, tmp_path):
    """A dp fleet run (one process: a one-device mesh) with the ops plane:
    ``/devices`` serves the device, ``/healthz`` carries the ``mesh``
    stanza, the logger gets one ``device_rollup`` event a round, and the
    ``mesh_imbalance`` rule (on at 1.5) stays quiet on one device."""
    cfg = RescheduleConfig(algorithm="communication", max_rounds=3, sleep_after_action_s=0.0,
                           slo_mesh_imbalance_ratio=1.5, slo_min_samples=1, serve_port=0,
                           fleet=FleetConfig(tenants=2, plane="dp"))
    logger = TLogger()
    ops = tserver.OpsPlane.from_config(cfg.validate(), registry=registry, logger=logger,
                                       bundle_dir=str(tmp_path)).start()
    try:
        _, tf = fleets(2)
        run_fleet_controller(tf, cfg, device="cpu", registry=registry, logger=logger, ops=ops)
        code, body = jmesh_cases._get(ops.server.port, "/devices")
        assert code == 200
        doc = json.loads(body)
        assert [d["device"] for d in doc["devices"]] == ["cpu:0"] and doc["rounds"] == 3
        code, body = jmesh_cases._get(ops.server.port, "/healthz")
        health = json.loads(body)
        assert code == 200 and health["mesh"]["devices"] == 1
        assert health["mesh"]["worst_device"] == "cpu:0"
    finally:
        ops.close()
    events = [r for r in logger.records if r.get("event") == "device_rollup"]
    assert [e["round"] for e in events] == [1, 2, 3]
    assert ops.watchdog.status()["healthy"]
    assert registry.gauge("mesh_devices").value == 1
