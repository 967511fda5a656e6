"""Tracing on the port's replay path, on the CPU: the switch (off unless a
profiler records or the tracer is enabled), the hot spans of a replay call
(``replay/call`` → ``replay/plans``, ``replay/stage``, ``graph/run``), the
solve's phase marks (``telemetry/phases.py``), their reading without a
wait, the cost gauges that ``/metrics`` republishes, and the union that
``bench/profile.py`` takes the device's busy time from."""

import dataclasses
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu_torch.bench import profile as tprofile
from kubernetes_rescheduling_tpu_torch.bench import trace as ttr
from kubernetes_rescheduling_tpu_torch.core import sparsegraph as tsg
from kubernetes_rescheduling_tpu_torch.core import topology as ttopo
from kubernetes_rescheduling_tpu_torch.solver import compiled
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs
from kubernetes_rescheduling_tpu_torch.solver import sparse_solver as tss
from kubernetes_rescheduling_tpu_torch.telemetry import costmodel, phases, server, spans
from kubernetes_rescheduling_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    get_registry,
    set_registry,
)

CFG = tgs.GlobalSolverConfig(sweeps=3, swap_every=3, chunk_size=512)
HOT = ("replay/call", "replay/plans", "replay/stage", "graph/run")
FN = {"dense": "replay_on_device", "sparse": "replay_on_device_sparse"}
DENSE_PHASES = {"update", "setup", "sweeps", "swap_sweeps", "ranking", "epilogue"}
SPARSE_PHASES = DENSE_PHASES | {"hubs"}


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


def dense_problem():
    scn = ttopo.synthetic_scenario(n_pods=256, n_nodes=32, seed=6, powerlaw=True, device="cpu")
    ii, jj, mults = ttr.drift_multipliers(scn.graph, 2, seed=3)
    return scn.state, scn.graph, ii, jj, mults


def sparse_problem():
    """1536 services: a 300-arm star (a hub block) over a random mean-degree-3
    background, 16 nodes, trace-reordered."""
    S = 1536
    rng = np.random.default_rng(10)
    E = int(S * 3.0 / 2)
    src = np.concatenate([np.zeros(300, np.int64), rng.integers(0, S, size=E)])
    dst = np.concatenate([np.arange(1, 301, dtype=np.int64), rng.integers(0, S, size=E)])
    sgraph = tsg.from_edges(src, dst, np.ones(len(src)), S, bu=128, reg_tiles=8, device="cpu")
    state = ttopo.synthetic_scenario(n_pods=S, n_nodes=16, seed=6, device="cpu").state
    sg2, loc, mults = ttr.drift_multipliers_sparse(sgraph, 2, seed=3)
    return state, sg2, loc, mults


DENSE, SPARSE = dense_problem(), sparse_problem()


def step(kind, k=0, seed=5):
    """One replay step ``k`` of the small problem, plans from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    if kind == "dense":
        state, graph, ii, jj, mults = DENSE
        return ttr.replay_on_device(state, graph, ii, jj, mults[k:k + 1], gen, CFG)
    state, sg, loc, mults = SPARSE
    return ttr.replay_on_device_sparse(state, sg, loc, mults[k:k + 1], gen, CFG)


def series(reg, metric):
    return {tuple(sorted(r["labels"].items())): r["value"] for r in reg.snapshot()
            if r["metric"] == metric}


def phase_seconds(reg, fn):
    return {dict(k)["phase"]: v for k, v in series(reg, "solve_phase_device_seconds_total").items()
            if dict(k)["fn"] == fn}


def self_us(events):
    """Span index → its duration less its children's."""
    child = {}
    for e in events:
        if e.parent is not None:
            child[e.parent] = child.get(e.parent, 0.0) + e.dur_us
    return {e.index: e.dur_us - child.get(e.index, 0.0) for e in events}


# ---------------- the switch ----------------


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_off_a_replay_step_records_nothing(kind, registry, tracer):
    """Tracing off: a step adds nothing to the ring, to ``span_seconds`` or
    to the phase counters."""
    assert not tracer.tracing()
    step(kind)
    assert tracer.events == []
    assert tracer.dropped == 0
    names = {r["metric"] for r in registry.snapshot()}
    assert "span_seconds" not in names
    assert not {n for n in names if n.startswith("solve_phase")}


def test_off_hot_span_is_the_shared_no_op(tracer):
    assert tracer.span("graph/run", hot=True, fn="x") is spans._OFF
    with spans.span("graph/run", hot=True, fn="x") as args:
        assert args is None
    assert tracer.events == []


def test_enable_and_disable_turn_hot_spans_on_and_off(registry, tracer):
    tracer.enable()
    assert tracer.tracing()
    with spans.span("a", hot=True) as args:
        args["k"] = 1
    tracer.disable()
    assert not tracer.tracing()
    with spans.span("b", hot=True):
        pass
    assert [(e.name, e.args) for e in tracer.events] == [("a", {"k": 1})]
    assert registry.histogram("span_seconds", labelnames=("span",)).labels(span="a").count == 1


def test_enable_reanchors_the_wall_clock(tracer):
    tracer._wall_anchor_ns -= 10**9  # a wall clock a second off since the last anchor
    tracer.enable()
    with tracer.span("x", hot=True):
        pass
    assert abs(tracer.events[0].ts_us - time.time_ns() / 1e3) < 5e5


def test_profiler_session_turns_tracing_on(tracer):
    assert not tracer.tracing()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracer.tracing()
    assert not tracer.tracing()


# ---------------- hot spans of one replay call ----------------


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_enabled_step_records_the_call_tree(kind, registry, tracer):
    tracer.enable()
    step(kind)
    evs = tracer.events
    assert sorted(e.name for e in evs) == sorted(HOT)
    by = {e.name: e for e in evs}
    root = by["replay/call"]
    assert root.parent is None and root.call == root.index and root.depth == 0
    assert root.args == {"fn": FN[kind], "steps": 1, "restarts": 1}
    for name in HOT[1:]:
        assert by[name].parent == root.index and by[name].call == root.index
        assert by[name].depth == 1
        assert by[name].ts_us >= root.ts_us - 1.0
        assert by[name].ts_us + by[name].dur_us <= root.ts_us + root.dur_us + 1.0
    assert by["graph/run"].args == {"fn": FN[kind], "hit": False}
    own = self_us(evs)
    assert all(v >= -1.0 for v in own.values())
    assert sum(own.values()) <= root.dur_us + 1.0


def test_chrome_export_carries_parent_and_call(tracer, tmp_path):
    tracer.enable()
    with spans.span("outer", hot=True):
        with spans.span("inner", hot=True):
            pass
    with spans.span("next"):
        pass
    out = tmp_path / "t.json"
    tracer.export_chrome(out)
    evs = {e["name"]: e["args"] for e in json.loads(out.read_text())["traceEvents"]}
    outer = tracer.events[1].index
    assert evs["outer"]["parent"] is None and evs["outer"]["call"] == outer
    assert evs["inner"]["parent"] == outer and evs["inner"]["call"] == outer
    assert evs["next"]["call"] != outer and evs["next"]["parent"] is None


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_hot_spans_land_in_the_profiler_trace_on_one_clock(kind, registry, tracer):
    """Under a CPU profiler session each hot span is also a kineto event of
    the same name, starting within 0.1 ms of the Tracer's start."""
    # warm: the first annotation of a process initializes for a millisecond
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(kind)
    tracer.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(kind)
    kineto = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in HOT:
            kineto.setdefault(e.name(), []).append(e.start_ns() / 1e3)
    ours = {}
    for e in tracer.events:
        ours.setdefault(e.name, []).append(e.ts_us)
    assert sorted(ours) == sorted(HOT)
    for name, starts in ours.items():
        assert len(kineto[name]) == len(starts)
        for a, b in zip(sorted(starts), sorted(kineto[name])):
            assert abs(a - b) < 100.0, (name, a - b)


# ---------------- phases ----------------


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_phases_partition_the_body(kind, registry, tracer, monkeypatch):
    """The phases of a small solve are exactly the named set, each ≥ 0,
    and sum to within 5% of the body's own time."""
    body_ns = []
    run = compiled.GraphCache.run

    def timed_run(self, fn, key, inputs, make_body, operands=()):
        def make():
            body = make_body()

            def timed(t):
                t0 = time.perf_counter_ns()
                out = body(t)
                body_ns.append(time.perf_counter_ns() - t0)
                return out
            return timed
        return run(self, fn, key, inputs, make, operands)

    monkeypatch.setattr(compiled.GraphCache, "run", timed_run)
    tracer.enable()
    step(kind)
    secs = phase_seconds(registry, FN[kind])
    assert set(secs) == (SPARSE_PHASES if kind == "sparse" else DENSE_PHASES)
    assert all(v >= 0 for v in secs.values())
    assert len(body_ns) == 1
    body = body_ns[0] * 1e-9
    assert 0.95 * body <= sum(secs.values()) <= body
    assert series(registry, "solve_phase_rounds_total") == {(("fn", FN[kind]),): 1.0}


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_tracing_leaves_placements_and_objectives_bitwise_equal(kind, registry, tracer):
    off = [step(kind, k) for k in (0, 1)]
    tracer.enable()
    on = [step(kind, k) for k in (0, 1)]
    tracer.disable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = [step(kind, k) for k in (0, 1)]
    for other in (on, profiled):
        for (s0, o0, b0), (s1, o1, b1) in zip(off, other):
            assert torch.equal(s0.pod_node, s1.pod_node)
            assert torch.equal(o0, o1) and torch.equal(b0, b1)
    assert series(registry, "solve_phase_rounds_total") == {(("fn", FN[kind]),): 4.0}


@pytest.mark.parametrize("entry", ["solve", "replay"])
@pytest.mark.parametrize("lowering", ["on", "off"])
def test_sparse_chunk_steps_count_by_path_while_tracing(entry, lowering, registry, tracer):
    """``sparse_chunk_steps_total{fn,path}``: with the tracer enabled a
    sparse solve adds n_chunks x its plain sweeps under ``in_place`` (the
    kernel lowering's two-launch step) and the rest under ``gathered``;
    with tracing off nothing is recorded."""
    state, sgraph, loc, mults = SPARSE
    cfg = dataclasses.replace(CFG, fused_epilogue=lowering)
    fn = "global_assign_sparse" if entry == "solve" else FN["sparse"]

    def run():
        gen = torch.Generator().manual_seed(1)
        if entry == "solve":
            tss.global_assign_sparse(state, sgraph, gen, cfg)
        else:
            ttr.replay_on_device_sparse(state, sgraph, loc, mults, gen, cfg)

    run()
    assert series(registry, "sparse_chunk_steps_total") == {}
    tracer.enable()
    run()
    n = tss.sparse_layout(sgraph, cfg).n_chunks * (1 if entry == "solve" else len(mults))
    assert cfg.sweeps == 3 and cfg.swap_every == 3 and n > 0  # sweep 3 is the swap sweep
    want = {"in_place": 2 * n, "gathered": n} if lowering == "on" else {"gathered": 3 * n}
    assert series(registry, "sparse_chunk_steps_total") == {
        (("fn", fn), ("path", path)): float(v) for path, v in want.items()}


class StubEvent:
    """A device event that has not completed: reading or waiting on it
    fails the test."""

    def __init__(self, done=False, at_ms=0.0):
        self.done, self.at_ms = done, at_ms

    def query(self):
        return self.done

    def elapsed_time(self, other):
        assert self.done and other.done, "an event was read before it completed"
        return other.at_ms - self.at_ms

    def synchronize(self):
        raise AssertionError("the program waited on a phase event")

    wait = synchronize


def stub_marks(fn, names, events):
    marks = phases.Marks(fn, "graph")
    marks.names, marks.stamps = list(names), list(events)
    return marks


def test_incomplete_events_count_unresolved_and_are_never_waited_on(registry):
    marks = stub_marks("f", ["setup", phases.END], [StubEvent(), StubEvent()])
    phases.submit(marks)
    phases.settle("other")
    assert series(registry, "solve_phase_unresolved_total") == {}
    phases.settle("f")
    assert series(registry, "solve_phase_unresolved_total") == {(("fn", "f"),): 1.0}
    assert series(registry, "solve_phase_rounds_total") == {}
    phases.submit(stub_marks("f", ["setup", phases.END], [StubEvent(), StubEvent()]))
    phases.flush()
    phases.flush()
    assert series(registry, "solve_phase_unresolved_total") == {(("fn", "f"),): 2.0}
    assert series(registry, "solve_phase_device_seconds_total") == {}


def test_complete_events_sum_each_phase_between_its_marks(registry):
    names = ["update", "setup", "sweeps", "ranking", "sweeps", "ranking", "epilogue", phases.END,
             "setup", phases.END]
    at = [0.0, 1.0, 3.0, 7.0, 8.0, 12.0, 13.0, 15.0, 40.0, 42.0]
    phases.submit(stub_marks("g", names, [StubEvent(True, t) for t in at]))
    phases.flush()
    got = phase_seconds(registry, "g")
    want = {"update": 1.0, "setup": 2.0 + 2.0, "sweeps": 4.0 + 4.0, "ranking": 1.0 + 1.0,
            "epilogue": 2.0}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v * 1e-3)
    assert series(registry, "solve_phase_rounds_total") == {(("fn", "g"),): 1.0}


def test_a_mark_outside_a_recorded_body_is_nothing():
    phases.phase_mark("setup")
    marks = phases.Marks("h", "host")
    with phases.recording(marks):
        phases.phase_mark("setup")
        with phases.recording(None):
            phases.phase_mark("sweeps")
        phases.phase_mark(phases.END)
    phases.phase_mark("epilogue")
    assert marks.names == ["setup", phases.END]
    assert marks.stamps[0] <= marks.stamps[1]


# ---------------- the capture cache's misses ----------------


def test_capture_seconds_leave_out_the_kernels_first_build(registry, tracer, monkeypatch):
    """A miss whose warm-up builds a kernel library counts the miss, not
    the build; the ``graph/capture`` span carries the capture's pool."""
    from types import SimpleNamespace

    from kubernetes_rescheduling_tpu_torch.ops import _build

    def capture_entry(self, fn, full, inputs, body, operands):
        t = time.perf_counter()
        time.sleep(0.3)  # the build, as ops/_build.py accounts it
        monkeypatch.setattr(_build, "_build_s", _build.build_seconds() + time.perf_counter() - t)
        time.sleep(0.02)
        return {"out": 1}, SimpleNamespace(capture_s=0.005, pool_bytes=4096)

    monkeypatch.setattr(compiled.GraphCache, "_capture_entry", capture_entry)
    tracer.enable()
    try:
        warm = compiled.GraphCache()._capture("f", ("f",), {}, lambda: None, ())
    finally:
        tracer.disable()
    assert warm == {"out": 1}
    (secs,) = series(registry, "cuda_graph_capture_seconds_total").values()
    assert 0.02 <= secs < 0.3
    (ev,) = [e for e in tracer.events if e.name == "graph/capture"]
    assert ev.args["pool_bytes"] == 4096 and ev.args["capture_s"] == 0.005


# ---------------- the cost book on /metrics ----------------


def test_metrics_render_shows_the_cost_gauges_after_a_registry_swap(registry):
    book = costmodel.get_costbook()
    saved = book.as_dict()
    book.clear()
    try:
        captured = MetricsRegistry()
        snap = {"flops": 2.0e9, "bytes_accessed": 3.0e8, "argument_bytes": 1024.0,
                "output_bytes": 64.0, "temp_bytes": 4096.0}
        assert costmodel.record_capture("replay_on_device", snap, registry=captured)
        assert get_registry() is registry
        assert "cuda_graph_flops" not in {r["metric"] for r in registry.snapshot()}
        srv = server.OpsServer(port=0)
        port = srv.start()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
                body = r.read().decode()
        finally:
            srv.stop()
        assert 'cuda_graph_flops{fn="replay_on_device"} 2000000000' in body
        assert 'cuda_graph_temp_bytes{fn="replay_on_device"} 4096' in body
    finally:
        book.clear()
        for label, s in saved.items():
            book.record(label, s)


def test_a_replay_publishes_no_cost_gauges(registry, tracer):
    """The cost book is read where it is rendered, not on every replay."""
    step("dense")
    assert not {r["metric"] for r in registry.snapshot()} & {g for _, g, _ in
                                                             costmodel.COST_GAUGES}


# ---------------- bench/profile.py's busy time ----------------


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),
    ([(0.0, 10.0), (2.0, 3.0), (4.0, 5.0)], 10.0),
    ([(5.0, 6.0), (0.0, 1.0), (1.0, 2.0)], 3.0),
    ([(0.0, 1.0), (0.0, 1.0), (3.0, 4.5)], 2.5),
])
def test_profile_busy_time_is_the_union_of_device_intervals(intervals, want):
    assert tprofile.union_length(intervals) == pytest.approx(want)
    # the summed time counts overlaps twice; the union never exceeds it
    assert tprofile.union_length(intervals) <= sum(b - a for a, b in intervals) + 1e-12


def test_profile_counts_device_work_not_the_spans_mirrored_on_the_card():
    """A hot span's ``record_function`` shows on the card's timeline over
    the kernels it launched: counted, it would double the kernel time and
    cover the graph's idle gaps."""
    from types import SimpleNamespace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, device, dev_us, annotation=False):
        return SimpleNamespace(name=name, device_type=device, device_time_total=dev_us,
                               is_user_annotation=annotation)

    events = [ev("graph/run", cuda, 900.0, annotation=True), ev("kernel_a", cuda, 300.0),
              ev("memset", cuda, 10.0), ev("aten::copy_", cpu, 0.0), ev("graph/run", cpu, 0.0),
              ev("idle", cuda, 0.0)]
    assert [e.name for e in tprofile.device_kernels(events)] == ["kernel_a", "memset"]


def test_profile_union_against_a_fine_grid():
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 900, size=40)
    intervals = [(float(a), float(a + rng.integers(1, 80))) for a in starts]
    covered = np.zeros(1000, dtype=bool)
    for a, b in intervals:
        covered[int(a):int(b)] = True
    assert tprofile.union_length(intervals) == pytest.approx(float(covered.sum()))
