"""The port's perf ledger (``telemetry/perf_ledger.py``) and compiled-cost
book (``telemetry/costmodel.py``, ``ops/work.py``) on the CPU.

- Every case of tests/test_perf_ledger.py runs on the port: the JAX test's
  own function re-bound to the port's names (``test_torch_slo.on_port``),
  its imports of the JAX harness, CLI, logger, ops server and reports inside
  its body resolved to the port's (``test_torch_slo.port_modules``; the
  harness and the CLI on the CPU). The assertions are the JAX test's.
- The ledger's renderings and ingestion equal the JAX package's on the same
  records: ``detect`` and ``render_table`` over the checked-in
  ``BENCH_r0*.json`` / ``MULTICHIP_r0*.json`` history and a synthetic
  ledger, ``ingest_bench_file`` record for record.
- The cost book's cases (tests/test_costmodel.py's, on what the port
  records instead of XLA's analyses): a snapshot once per fn, republished
  into a swapped registry, the roofline, the device-memory sample, the
  controller's round hook, the manifest and the flight-recorder bundle; the
  per-launch work formulas against ``chip_smoke.py``'s bounds.
"""

import json
from pathlib import Path

import pytest
import test_perf_ledger as jcases
import torch
from test_torch_slo import on_port, port_modules, run_case

from kubernetes_rescheduling_tpu.telemetry import perf_ledger as jpl
from kubernetes_rescheduling_tpu_torch import config as tconfig
from kubernetes_rescheduling_tpu_torch import telemetry as ttel
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller
from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend
from kubernetes_rescheduling_tpu_torch.ops import work
from kubernetes_rescheduling_tpu_torch.solver import compiled
from kubernetes_rescheduling_tpu_torch.telemetry import costmodel
from kubernetes_rescheduling_tpu_torch.telemetry import perf_ledger as tpl

REPO = Path(__file__).resolve().parent.parent

PORT_NAMES = {
    "PerfConfig": tconfig.PerfConfig,
    "RescheduleConfig": tconfig.RescheduleConfig,
    "MetricsRegistry": ttel.MetricsRegistry,
    "SLORules": ttel.SLORules,
    "Watchdog": ttel.Watchdog,
    "set_registry": ttel.set_registry,
    "pl": tpl,
}
CASES = sorted(n for n, v in vars(jcases).items() if n.startswith("test_") and callable(v))


@pytest.fixture()
def registry():
    prev = ttel.set_registry(ttel.MetricsRegistry())
    try:
        yield ttel.get_registry()
    finally:
        ttel.set_registry(prev)


@pytest.mark.parametrize("case", CASES)
def test_perf_ledger_case_on_port(case, registry, tmp_path, capsys, monkeypatch):
    port_modules(monkeypatch)
    run_case(on_port(jcases, PORT_NAMES), case,
             {"registry": registry, "tmp_path": tmp_path, "capsys": capsys})


def history():
    return sorted(REPO.glob("BENCH_r0*.json")) + sorted(REPO.glob("MULTICHIP_r0*.json"))


@pytest.mark.parametrize("path", history(), ids=lambda p: p.name)
def test_ingest_bench_file_equals_jax(path):
    assert tpl.ingest_bench_file(path) == jpl.ingest_bench_file(path)


def synthetic_entries():
    out = []
    for i, (v, dev) in enumerate([(10.0, "cpu"), (10.4, "cpu"), (9.9, "cpu"), (4.0, "cpu"),
                                  (7.0, "NVIDIA H100 80GB HBM3"), (7.1, "NVIDIA H100 80GB HBM3"),
                                  (7.2, "NVIDIA H100 80GB HBM3")]):
        out.append({"schema": 1, "seq": i, "metric": "decisions_per_sec", "value": v,
                    "unit": "1/s", "scenario": "large/global", "device_kind": dev,
                    "config_digest": f"d-{dev[:3]}", "better": "higher"})
    return out


@pytest.mark.parametrize("baseline", ["median", "best"])
@pytest.mark.parametrize("window,threshold", [(5, 0.2), (2, 0.05)])
def test_detect_and_table_equal_jax(baseline, window, threshold):
    entries = jpl.ingest_history(history()) + synthetic_entries()
    kw = dict(window=window, threshold_frac=threshold, baseline=baseline)
    t, j = tpl.detect(entries, **kw), jpl.detect(entries, **kw)
    assert t == j
    assert tpl.render_table(t) == jpl.render_table(j)
    assert tpl.regressions(t) == jpl.regressions(j)


def test_config_digest_and_series_key_equal_jax():
    cfg = {"b": [1, 2], "a": {"x": 0.5}, "c": None}
    assert tpl.config_digest(cfg) == jpl.config_digest(cfg)
    rec = synthetic_entries()[0]
    assert tpl.series_key(rec) == jpl.series_key(rec)
    bad = {"seq": -1, "value": "x", "better": "up"}
    assert tpl.validate_entry(bad) == jpl.validate_entry(bad)


def test_port_readings_are_keyed_by_device():
    """A port reading's ``device_kind`` is the card's name or ``cpu``, never
    the ingested history's TPU or forced-CPU kinds."""
    assert tpl.device_kind("cpu") == "cpu"
    kinds = {r["device_kind"] for r in jpl.ingest_history(history())}
    assert "cpu" not in kinds
    if torch.cuda.is_available():
        assert tpl.device_kind("cuda") == torch.cuda.get_device_name(0)


# ---------------- the compiled-cost book ----------------


@pytest.fixture()
def book():
    """The process book, emptied for the case and restored after."""
    b = costmodel.get_costbook()
    saved = b.as_dict()
    b.clear()
    try:
        yield b
    finally:
        b.clear()
        for k, v in saved.items():
            b.record(k, v)


def _gauge(reg, name, fn):
    return reg.gauge(name, labelnames=("fn",)).labels(fn=fn).value


def snapshot_of_a_capture():
    inputs = {"pod_node": torch.zeros(100, dtype=torch.int32),
              "plans": torch.zeros((9, 10), dtype=torch.float32)}
    operands = (torch.zeros((64, 64)), None)
    outputs = {"assign": torch.zeros(100, dtype=torch.int32)}
    return costmodel.graph_cost(inputs, operands, outputs, ops=1.5e9, nbytes=3.0e8,
                                temp_bytes=2**20)


def test_capture_is_nonempty_and_exactly_once(registry, book):
    snap = snapshot_of_a_capture()
    assert snap == {"flops": 1.5e9, "bytes_accessed": 3.0e8,
                    "argument_bytes": 100 * 4 + 90 * 4 + 64 * 64 * 4, "output_bytes": 400.0,
                    "temp_bytes": float(2**20)}
    assert costmodel.record_capture("global_assign", snap)
    assert not costmodel.record_capture("global_assign", {**snap, "flops": 1.0})
    assert book.get("global_assign") == snap
    captures = registry.counter("cuda_graph_cost_captures_total", labelnames=("fn",))
    assert captures.labels(fn="global_assign").value == 1
    text = registry.expose()
    for field, gauge, _help in costmodel.COST_GAUGES:
        assert f'{gauge}{{fn="global_assign"}}' in text
        assert _gauge(registry, gauge, "global_assign") == snap[field]


def test_capture_republishes_into_swapped_registry(registry, book):
    costmodel.record_capture("scan_rounds", snapshot_of_a_capture())
    fresh = ttel.MetricsRegistry()
    assert costmodel.republish("scan_rounds", fresh)
    assert 'cuda_graph_flops{fn="scan_rounds"}' in fresh.expose()
    assert "cuda_graph_cost_captures_total" not in fresh.expose()
    assert not costmodel.republish("never_captured", fresh)


def test_roofline_and_device_memory(registry, book):
    costmodel.record_capture("global_assign", snapshot_of_a_capture())
    out = costmodel.publish_roofline(registry, "global_assign", seconds=0.5)
    assert out == {"achieved_flops_per_s": 3.0e9, "achieved_bytes_per_s": 6.0e8,
                   "arithmetic_intensity": 5.0}
    assert _gauge(registry, "cuda_graph_achieved_flops_per_s", "global_assign") == 3.0e9
    assert costmodel.publish_roofline(registry, "nope", 0.5) is None
    assert costmodel.publish_roofline(registry, "global_assign", 0.0) is None
    if not torch.cuda.is_available():
        assert costmodel.sample_device_memory(registry) == []
    # the loop's hook: the first candidate with a snapshot wins
    costmodel.observe_round_device(registry, fn_labels=("global_assign_sparse", "global_assign"),
                                   seconds=0.25)
    assert _gauge(registry, "cuda_graph_achieved_flops_per_s", "global_assign") == 6.0e9


@pytest.mark.parametrize("solver_backend", ["dense", "sparse"])
def test_controller_global_round_publishes_the_roofline(registry, book, solver_backend):
    """The loop's host tail publishes the round's roofline against the
    captured solve's recorded cost (recorded here by hand: the CPU captures
    nothing), dense rounds against ``global_assign``, sparse ones against
    ``global_assign_sparse`` first."""
    label = "global_assign" if solver_backend == "dense" else "global_assign_sparse"
    costmodel.record_capture(label, snapshot_of_a_capture())
    backend = make_backend("mubench", 0, device="cpu")
    result = run_controller(backend, tconfig.RescheduleConfig(
        algorithm="global", max_rounds=2, sleep_after_action_s=0.0,
        solver_backend=solver_backend), device="cpu", registry=registry)
    last = result.rounds[-1].decision_latency_s
    assert _gauge(registry, "cuda_graph_achieved_flops_per_s", label) == pytest.approx(
        1.5e9 / last)
    assert _gauge(registry, "cuda_graph_arithmetic_intensity", label) == 5.0


def test_greedy_round_has_no_roofline(registry, book):
    costmodel.record_capture("global_assign", snapshot_of_a_capture())
    backend = make_backend("mubench", 0, device="cpu")
    backend.inject_imbalance(backend.node_names[0])
    run_controller(backend, tconfig.RescheduleConfig(max_rounds=2, sleep_after_action_s=0.0),
                   device="cpu", registry=registry)
    assert "cuda_graph_achieved_flops_per_s" not in registry.expose()


def test_manifest_and_bundle_carry_device_costs(registry, book, tmp_path):
    costmodel.record_capture("prov_fn", snapshot_of_a_capture())
    m = ttel.run_manifest()
    assert m["device_costs"]["kernels"] == {"prov_fn": snapshot_of_a_capture()}
    assert isinstance(m["device_costs"]["device_memory"], list)
    fr = ttel.FlightRecorder(capacity=2, bundle_dir=tmp_path, registry=registry)
    fr.record_round(round=1, record={"round": 1})
    bundle = json.loads(fr.dump("crash").read_text())
    assert bundle["device_costs"] == {"prov_fn": snapshot_of_a_capture()}


def test_work_formulas_are_the_chip_smoke_bounds():
    """The per-launch work of ``ops/work.py`` at the ``large`` shapes: the
    byte counts of ``chip_smoke.py``'s ``score_bytes`` and
    ``admission_bound`` (at every row wanting and moving), the score's 97 /
    31 instructions a pair (``score_bound``)."""
    C, N, SP = 1024, 1000, 10_240
    assert work.score(C, N, True) == (C * N * 97.0,
                                      float(C * N * 4 + C * 21 + N * 17 + C * 20))
    assert work.score(C, N, False)[0] == C * N * 31.0
    ops, nbytes = work.admission(C, N)
    assert nbytes == C * 33 + C * 5 + N * 8
    assert ops == pytest.approx(2 * C * 10 + 8 * C)  # log2(1024) = 10
    assert work.admission(C, N, 2)[1] == nbytes + C * N * 2
    assert work.mass(C, SP, N, 2) == (2.0 * C * SP, float(C * SP * 2 + SP * 5 + C * N * 4))
    o4, b4 = work.strips(1024, 512, 1024, 2000, 2, 2048)
    o6, b6 = work.mass_score(1024, 512, 2000, 2, 2048, True)
    assert o6 == o4 + work.score(1024, 2000, True)[0]
    # kernel 6 keeps M on chip: neither its write (kernel 4) nor its read (kernel 2)
    assert b6 == b4 - 1024 * 2000 * 4 + 1024 * 4 + work.score(1024, 2000, True)[1] \
        - 1024 * 2000 * 4


def test_wrappers_carry_work_totals():
    """Every kernel wrapper carries its work totals beside its launch
    count, which a capture reads as deltas (``compiled._work``)."""
    from kubernetes_rescheduling_tpu_torch.ops import KERNEL_WRAPPERS

    for fn in KERNEL_WRAPPERS:
        assert isinstance(fn.work_ops, float) and isinstance(fn.work_bytes, float)
    before = compiled._work()
    fn = KERNEL_WRAPPERS[1]
    work.count(fn, 10.0, 20.0)
    try:
        assert compiled._work() == (before[0] + 10.0, before[1] + 20.0)
    finally:
        work.count(fn, -10.0, -20.0)
