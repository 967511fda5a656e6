"""The trace corpus and its adapters against the JAX package on the CPU.

Every case of tests/test_shadow.py's corpus and adapter section runs on both
packages: the case's own assertions hold in each, and what it observes — the
parsed records, the windows, the quarantine counts and their counters — is
equal between them. Every window of every fixture under
``tests/fixtures/shadow/`` builds the same ``ClusterState`` in both (field by
field, exactly: the same host arithmetic in float64, the same f32 casts), and
every fixture's ``comm_graph()`` the same adjacency.
"""

import json
from pathlib import Path

import numpy as np
import pytest
from test_torch_state import assert_graph_equal, assert_state_equal

from kubernetes_rescheduling_tpu import traces as jtr
from kubernetes_rescheduling_tpu.backends.replay import ReplayBackend as JReplay
from kubernetes_rescheduling_tpu.bench.admission import AdmissionGuard as JGuard
from kubernetes_rescheduling_tpu.config import ReconcileConfig
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu.traces.corpus import ClusterTrace as JTrace
from kubernetes_rescheduling_tpu_torch import traces as ttr
from kubernetes_rescheduling_tpu_torch.backends.replay import ReplayBackend as TReplay
from kubernetes_rescheduling_tpu_torch.bench.admission import AdmissionGuard as TGuard
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry
from kubernetes_rescheduling_tpu_torch.traces.corpus import ClusterTrace as TTrace

FIXTURES = Path(__file__).parent / "fixtures" / "shadow"


def j_metric(reg, name, **labels):
    for rec in reg.snapshot():
        if rec["metric"] == name and (rec.get("labels") or {}) == labels:
            return rec.get("value")
    return None


def t_metric(reg, name, **labels):
    for rec in reg.snapshot():
        if rec["metric"] == name and (rec.get("labels") or {}) == labels:
            return rec.get("value")
    return None


def j_windows(t):
    return [(w.t, w.nodes, w.pods, w.placements) for w in t.windows()]


def both(loader, *args, **kw):
    """Load with the JAX function and its port counterpart (same name) into
    fresh registries; the parsed traces must agree record for record."""
    jreg, treg = JRegistry(), TRegistry()
    j = getattr(jtr, loader)(*args, registry=jreg, **kw)
    t = getattr(ttr, loader)(*args, registry=treg, **kw)
    assert t.records == j.records
    assert t.quarantined == j.quarantined
    assert t.source == j.source
    assert t.node_names == j.node_names and t.service_names == j.service_names
    assert j_windows(t) == j_windows(j)
    assert t.max_window_pods == j.max_window_pods
    for reason in j.quarantined:
        assert t_metric(treg, "trace_rows_quarantined_total", reason=reason) == j_metric(
            jreg, "trace_rows_quarantined_total", reason=reason)
    return j, t, jreg, treg


FIXTURE_LOADS = {
    "mini": ("load_trace_jsonl", (FIXTURES / "mini.trace.jsonl",)),
    "corrupt": ("load_trace_jsonl", (FIXTURES / "corrupt_trace.jsonl",)),
    "alibaba": ("load_alibaba_csv", (FIXTURES / "alibaba_machines.csv",
                                     FIXTURES / "alibaba_containers.csv")),
    "borg": ("load_borg_csv", (FIXTURES / "borg_machine_events.csv",
                               FIXTURES / "borg_task_usage.csv")),
}


@pytest.mark.parametrize("fixture", sorted(FIXTURE_LOADS))
def test_fixture_windows_and_graph_match_jax(fixture):
    """The state carried across: every window's snapshot and the trace's
    graph, on every fixture, equal to the JAX package's arrays."""
    loader, args = FIXTURE_LOADS[fixture]
    j, t, jreg, treg = both(loader, *args)
    for i in range(len(j.windows())):
        assert_state_equal(ttr.window_state(t, i, registry=treg, device="cpu"),
                           jtr.window_state(j, i, registry=jreg))
    assert t_metric(treg, "trace_rows_quarantined_total", reason="unknown_node_ref") == j_metric(
        jreg, "trace_rows_quarantined_total", reason="unknown_node_ref")
    assert_graph_equal(t.comm_graph("cpu"), j.comm_graph())
    # one graph object per device for the trace's life: every window's solve
    # keys the same capture
    assert t.comm_graph("cpu") is t.comm_graph("cpu")


def test_native_trace_roundtrip(tmp_path):
    j, t, _, _ = both("load_trace_jsonl", FIXTURES / "mini.trace.jsonl")
    for tr, pkg in ((j, jtr), (t, ttr)):
        assert not tr.quarantined
        assert len(tr.windows()) == 3
        assert tr.node_names == ("n1", "n2", "n3", "n4")
        assert tr.service_names == ("sa", "sb", "sc", "sd")
        out = pkg.dump_trace_jsonl(tr, tmp_path / f"{pkg.__name__}.jsonl")
        assert pkg.load_trace_jsonl(out).records == tr.records
    # declared edges win over the uniform fallback
    g = t.comm_graph("cpu")
    i, k = g.names.index("sa"), g.names.index("sb")
    assert float(g.adj[i, k]) == 2.0
    # the port's file is the JAX package's, byte for byte
    assert (tmp_path / f"{ttr.__name__}.jsonl").read_text() == (
        tmp_path / f"{jtr.__name__}.jsonl").read_text()


def test_alibaba_adapter_roundtrip(tmp_path):
    j, t, _, _ = both("load_alibaba_csv", FIXTURES / "alibaba_machines.csv",
                      FIXTURES / "alibaba_containers.csv")
    assert not t.quarantined
    assert len(t.windows()) == 5 and len(t.node_names) == 5
    assert t.service_names == tuple(f"app_{s}" for s in "abcdef")
    assert all(len(w.pods) == 24 for w in t.windows())
    assert float(ttr.window_state(t, 0, device="cpu").node_cpu_cap[0]) == 4000.0
    out = ttr.dump_trace_jsonl(t, tmp_path / "a.trace.jsonl")
    assert ttr.load_trace_jsonl(out).records == t.records == j.records


def test_borg_adapter_roundtrip(tmp_path):
    j, t, _, _ = both("load_borg_csv", FIXTURES / "borg_machine_events.csv",
                      FIXTURES / "borg_task_usage.csv")
    assert not t.quarantined
    assert len(t.windows()) == 3 and len(t.node_names) == 4
    assert len(t.service_names) == 5  # one per job
    # normalized capacities scale by the configured units
    assert float(ttr.window_state(t, 0, device="cpu").node_cpu_cap[0]) == 0.5 * 32_000.0
    out = ttr.dump_trace_jsonl(t, tmp_path / "b.trace.jsonl")
    assert ttr.load_trace_jsonl(out).records == t.records == j.records


@pytest.mark.parametrize("path,fmt", [
    (FIXTURES, "auto"),
    (FIXTURES, "alibaba"),
    (FIXTURES, "borg"),
    (FIXTURES / "mini.trace.jsonl", "auto"),
    (FIXTURES / "mini.trace.jsonl", "native"),
    (FIXTURES / "mini.trace.jsonl", "borg"),
    (FIXTURES / "mini.trace.jsonl", "csv"),
    (FIXTURES / "missing", "auto"),
], ids=["dir-auto", "dir-alibaba", "dir-borg", "file-auto", "file-native", "file-borg",
        "file-unknown", "missing"])
def test_load_shadow_trace_detects_formats(path, fmt):
    """A directory holding the alibaba pair auto-detects, a native file
    loads directly, and what the JAX loader refuses the port refuses with
    the same error."""
    try:
        j = jtr.load_shadow_trace(path, fmt=fmt, registry=JRegistry())
    except (ValueError, FileNotFoundError) as e:
        with pytest.raises(type(e), match="^" + __import__("re").escape(str(e)) + "$"):
            ttr.load_shadow_trace(path, fmt=fmt, registry=TRegistry())
        return
    t = ttr.load_shadow_trace(path, fmt=fmt, registry=TRegistry())
    assert t.records == j.records and t.source == j.source
    if path == FIXTURES and fmt == "auto":
        assert t.source.startswith("alibaba:")
    if path.is_file():
        assert len(t.windows()) == 3


def test_corrupt_rows_quarantine_at_corpus_layer():
    j, t, jreg, treg = both("load_trace_jsonl", FIXTURES / "corrupt_trace.jsonl")
    # identity-level breakage is dropped and counted by reason...
    assert t.quarantined == {"bad_json": 1, "unknown_kind": 1, "missing_field": 1,
                             "bad_timestamp": 1}
    for reason in t.quarantined:
        assert t_metric(treg, "trace_rows_quarantined_total", reason=reason) == 1
    # ...while value-level poison flows through to the snapshot
    st = ttr.window_state(t, 0, registry=treg, device="cpu")
    assert bool(np.isnan(st.pod_cpu.numpy()).any())
    # the phantom node reference was repaired to UNASSIGNED and counted
    jtr.window_state(j, 0, registry=jreg)
    for reg, metric in ((treg, t_metric), (jreg, j_metric)):
        assert metric(reg, "trace_rows_quarantined_total", reason="unknown_node_ref") == 1


def test_corrupt_snapshot_rides_the_admission_guard():
    j, t, jreg, treg = both("load_trace_jsonl", FIXTURES / "corrupt_trace.jsonl")
    j_adm = JGuard(ReconcileConfig(), registry=jreg).admit(jtr.window_state(j, 0, registry=jreg))
    t_adm = TGuard(registry=treg).admit(ttr.window_state(t, 0, registry=treg, device="cpu"))
    assert t_adm is not None  # repaired, not rejected
    assert not bool(np.isnan(t_adm.pod_cpu.numpy()).any())
    assert_state_equal(t_adm, j_adm)
    for reason in ("nan", "over_capacity"):
        assert t_metric(treg, "admission_quarantined_total", field="pod_cpu",
                        reason=reason) == 1
        assert j_metric(jreg, "admission_quarantined_total", field="pod_cpu",
                        reason=reason) == 1


def test_rounds_to_trace_converts_our_own_telemetry(tmp_path):
    rounds = tmp_path / "rounds.jsonl"
    with rounds.open("w") as f:
        for i in range(3):
            f.write(json.dumps({
                "round": i + 1,
                "attribution": {"total": 10.0, "ingress": {"n1": 3.0, "n2": 2.0},
                                "egress": {"n1": 2.0, "n2": 3.0}},
                "applied_moves": [["svc-a", "n2"]],
            }) + "\n")
    # a flight-recorder bundle's ring carries records too
    bundle = tmp_path / "bundle.json"
    bundle.write_text(json.dumps({"ring": [{"record": {"round": 7, "applied_moves": [
        ["svc-b", "n1"]]}}, {"event": "x"}]}))
    j = jtr.rounds_to_trace([rounds, bundle], node_cpu_cap_m=100.0)
    t = ttr.rounds_to_trace([rounds, bundle], node_cpu_cap_m=100.0)
    assert t.records == j.records and t.source == j.source
    assert len(t.windows()) == 4
    w = t.windows()[0]
    assert w.nodes["n1"]["cpu_used_m"] == 5.0  # ingress + egress
    # each round's applied move lands as that window's placement event
    assert all([p["pod"] for p in w2.placements] == ["svc-a"] for w2 in t.windows()[:3])
    # a pods-free corpus is schema tooling input, never a replay input
    for Replay, kw in ((JReplay, {}), (TReplay, {"device": "cpu"})):
        with pytest.raises(ValueError, match="carries no pod records"):
            Replay(t if Replay is TReplay else j, **kw)


def test_out_of_order_native_rows_are_resorted_and_counted(tmp_path):
    p = tmp_path / "late.jsonl"
    rows = [
        {"kind": "node", "t": 0.0, "node": "n1", "cpu_cap_m": 1000.0},
        {"kind": "pod", "t": 10.0, "pod": "a", "service": "s", "node": "n1"},
        {"kind": "pod", "t": 5.0, "pod": "b", "service": "s", "node": "n1"},
        {"kind": "pod", "t": 10.0, "pod": "c", "service": "s", "node": "n1"},
    ]
    p.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    _, t, _, treg = both("load_trace_jsonl", p)
    assert t.quarantined.get("out_of_order") == 1
    assert [w.t for w in t.windows()] == [0.0, 5.0, 10.0]
    # stable: the two t=10 pods stay one window, in file order
    assert [r["pod"] for r in t.windows()[2].pods] == ["a", "c"]
    assert t_metric(treg, "trace_rows_quarantined_total", reason="out_of_order") == 1


def test_integer_ids_are_legal_identity(tmp_path):
    """Integer-id corpora (Google clusterdata machine and job ids) use 0
    legitimately: absent or empty quarantines, falsy does not."""
    p = tmp_path / "ints.jsonl"
    rows = [
        {"kind": "node", "t": 0.0, "node": 0, "cpu_cap_m": 1000.0},
        {"kind": "pod", "t": 0.0, "pod": "j0-0", "service": "j0", "node": 0,
         "cpu_m": 100.0, "mem_b": 1e8},
        {"kind": "pod", "t": 0.0, "pod": "", "service": "j0"},  # empty: bad
        "[1, 2]",
    ]
    p.write_text("\n".join(r if isinstance(r, str) else json.dumps(r) for r in rows) + "\n")
    j, t, _, _ = both("load_trace_jsonl", p)
    assert t.quarantined == {"missing_field": 1, "not_object": 1}
    assert t.node_names == (0,)
    st = ttr.window_state(t, 0, device="cpu")
    assert int(st.pod_node[0]) == 0  # node 0 resolved, not UNASSIGNED
    assert_state_equal(st, jtr.window_state(j, 0))


def test_window_carry_forward_and_late_nodes():
    """Node records carry forward; a node declared in a later window is a
    dead zero-capacity slot before it (the static node table); a trace
    without edges gets the uniform complete graph."""
    recs = [
        {"kind": "node", "t": 0.0, "node": "n1", "cpu_cap_m": 8000.0, "mem_cap_b": 8e9,
         "cpu_used_m": 900.0, "mem_used_b": 1e9},
        {"kind": "pod", "t": 0.0, "pod": "a-0", "service": "a", "node": "n1", "cpu_m": 200.0,
         "mem_b": 1e8},
        {"kind": "pod", "t": 0.0, "pod": "b-0", "service": "b", "node": None, "cpu_m": 50.0},
        {"kind": "node", "t": 60.0, "node": "n2", "cpu_cap_m": 4000.0, "alive": False},
        {"kind": "pod", "t": 60.0, "pod": "a-0", "service": "a", "node": "n2",
         "cpu_m": float("nan"), "mem_b": 3e8},
        {"kind": "placement", "t": 60.0, "pod": "a-0", "node": "n2"},
    ]
    j, t = JTrace(records=[dict(r) for r in recs]), TTrace(records=[dict(r) for r in recs])
    assert j_windows(t) == j_windows(j)
    assert t.windows()[1].nodes["n1"]["cpu_cap_m"] == 8000.0
    for i in range(2):
        assert_state_equal(ttr.window_state(t, i, device="cpu", pod_capacity=4),
                           jtr.window_state(j, i, pod_capacity=4))
    assert not bool(ttr.window_state(t, 0, device="cpu").node_valid[1])
    assert_graph_equal(t.comm_graph("cpu"), j.comm_graph())
    assert t.comm_graph("cpu").adj.numpy().tolist() == [[0.0, 1.0], [1.0, 0.0]]
