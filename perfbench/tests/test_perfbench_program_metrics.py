"""The readers of the program's own record (host spans, solve phases,
capture seconds): None on an empty record, the right mean on planted
spans and counters, and a traced CPU run of each cell that reports them."""

import importlib

import pytest

from kubernetes_rescheduling_tpu_torch.telemetry import spans
from kubernetes_rescheduling_tpu_torch.telemetry.registry import MetricsRegistry, set_registry
from perfbench import harness
from perfbench.tests import small

HOST = ("plans_host_ms", "stage_host_ms")
PHASES = ("update", "setup", "hubs", "sweeps", "swap_sweeps", "ranking", "epilogue")
DEVICE = tuple(f"{p}_device_ms" for p in PHASES)


def reader(quantity):
    return importlib.import_module(f"perfbench.metrics.{quantity}")


@pytest.fixture
def registry():
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        yield reg
    finally:
        set_registry(prev)


@pytest.fixture
def tracer():
    tr = spans.Tracer()
    prev = spans.set_tracer(tr)
    try:
        yield tr
    finally:
        spans.set_tracer(prev)


def plant(tracer, events):
    """Spans ``(index, name, dur_us, parent, args)`` into the tracer's ring."""
    for index, name, dur, parent, args in events:
        tracer._events.append(spans.SpanEvent(name=name, ts_us=0.0, dur_us=dur, tid=1,
                                              depth=0 if parent is None else 1, args=args,
                                              index=index, parent=parent,
                                              call=0 if index < 5 else 5))


@pytest.mark.parametrize("quantity", HOST + DEVICE + ("capture_s",))
def test_reader_returns_none_on_an_empty_record(quantity, registry, tracer):
    assert reader(quantity).read(harness.RunData(rounds=3)) is None


def test_host_readers_take_self_time_a_step(registry, tracer):
    plant(tracer, [
        (0, "replay/call", 10_000.0, None, {"fn": "replay_on_device", "steps": 1}),
        (1, "replay/plans", 1_000.0, 0, {}),
        (2, "replay/stage", 500.0, 0, {}),
        (9, "host/child", 200.0, 2, {}),
        (3, "graph/run", 6_000.0, 0, {"fn": "replay_on_device", "hit": False}),
        (4, "graph/capture", 4_000.0, 3, {}),
        (5, "replay/call", 6_000.0, None, {"fn": "replay_on_device", "steps": 3}),
        (6, "replay/plans", 2_000.0, 5, {}),
        (7, "replay/stage", 700.0, 5, {}),
        (8, "graph/run", 1_000.0, 5, {"fn": "replay_on_device", "hit": True}),
    ])
    run = harness.RunData(rounds=4)
    assert reader("plans_host_ms").read(run) == pytest.approx(3.0 / 4)
    # a child span's time is its own, not its parent's
    assert reader("stage_host_ms").read(run) == pytest.approx(1.0 / 4)


def test_host_readers_need_a_replay_call(registry, tracer):
    plant(tracer, [(1, "replay/plans", 1_000.0, None, {})])
    assert reader("plans_host_ms").read(harness.RunData(rounds=1)) is None


def test_device_readers_take_the_entry_with_most_rounds(registry, tracer):
    secs = registry.counter("solve_phase_device_seconds_total", "s", labelnames=("fn", "phase"))
    rounds = registry.counter("solve_phase_rounds_total", "r", labelnames=("fn",))
    for i, phase in enumerate(PHASES):
        secs.labels(fn="replay_on_device_sparse", phase=phase).inc(0.001 * (i + 1) * 4)
        secs.labels(fn="replay_on_device", phase=phase).inc(1.0)
        secs.labels(fn="global_assign", phase=phase).inc(9.0)
    rounds.labels(fn="replay_on_device_sparse").inc(4)
    rounds.labels(fn="replay_on_device").inc(1)
    rounds.labels(fn="global_assign").inc(40)
    run = harness.RunData(rounds=4)
    for i, q in enumerate(DEVICE):
        assert reader(q).read(run) == pytest.approx(1.0 * (i + 1))


def test_device_reader_is_none_for_a_phase_the_entry_lacks(registry, tracer):
    registry.counter("solve_phase_device_seconds_total", "s", labelnames=("fn", "phase")).labels(
        fn="replay_on_device", phase="setup").inc(0.5)
    registry.counter("solve_phase_rounds_total", "r", labelnames=("fn",)).labels(
        fn="replay_on_device").inc(2)
    run = harness.RunData(rounds=2)
    assert reader("setup_device_ms").read(run) == pytest.approx(250.0)
    assert reader("hubs_device_ms").read(run) is None


def test_capture_reader_sums_every_fn(registry, tracer):
    c = registry.counter("cuda_graph_capture_seconds_total", "s", labelnames=("fn",))
    c.labels(fn="replay_on_device").inc(1.25)
    c.labels(fn="global_assign").inc(0.5)
    assert reader("capture_s").read(harness.RunData(rounds=1)) == pytest.approx(1.75)


@pytest.mark.parametrize("workload", ["dense12k.drift", "sparse60k.drift"])
def test_traced_cpu_run_reports_the_program_metrics(workload, registry, tracer):
    """On the CPU the phases are host times and nothing is captured, so
    every new metric but ``capture_s`` is there."""
    result = small.run(workload, 2**31 + 11, seconds=1.0, trace=True)
    assert result["correct"]
    form = workload.split(".")[0].rstrip("0123456789k")
    bench = harness.benchmark()
    names = {m["name"] for m in harness.metrics_for(bench, "per_layer", workload)
             if harness.quantity(m["name"]) in HOST + DEVICE}
    assert names and all(n.endswith(f".{form}") for n in names)
    assert names <= set(result["metrics"])
    assert all(result["metrics"][n]["value"] >= 0 for n in names)
    assert "capture_s" not in result["metrics"]
