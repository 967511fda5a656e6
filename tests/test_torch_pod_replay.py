"""The per-pod streaming replay (``bench/trace.py`` ``replay_on_device_pods``)
on the CPU, plain torch: 2,000 three-pod services on 240 nodes (24 pod
blocks, two of them hub blocks) under seeded call weights.

A step equals ``global_assign_pods`` on that step's re-weighted service
graph with the same plans, bit for bit; at one pod a service the replay
equals the service-level sparse replay; the on-device fan-out gives the
pod weights ``pod_level_graph`` builds from the re-weighted graph; and the
replay's phase, span and counter record as tracing says."""

import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu_torch.bench import trace
from kubernetes_rescheduling_tpu_torch.core import topology
from kubernetes_rescheduling_tpu_torch.core.sparsegraph import (
    from_edges,
    reorder_for_trace,
    with_edge_weights,
)
from kubernetes_rescheduling_tpu_torch.solver.global_solver import GlobalSolverConfig
from kubernetes_rescheduling_tpu_torch.solver.pod_mode import (
    call_pairs,
    global_assign_pods,
    pod_level_graph,
    pod_pair_calls,
)
from kubernetes_rescheduling_tpu_torch.solver.sparse_solver import draw_sparse_plans, sparse_layout
from kubernetes_rescheduling_tpu_torch.telemetry import spans
from kubernetes_rescheduling_tpu_torch.telemetry.registry import MetricsRegistry, set_registry

SERVICES, NODES, STEPS = 2000, 240, 2
CFG = GlobalSolverConfig(sweeps=3, swap_every=3, fused_epilogue="on", capacity_frac=0.55)


def instance(replicas: int, seed: int = 1):
    """A power-law call tree's pods on randomly drawn nodes, and its
    service graph under seeded call weights (f32, by call pair)."""
    sc = topology.synthetic_scenario(n_pods=SERVICES * replicas, n_nodes=NODES, powerlaw=True,
                                     replicas=replicas, mean_degree=2.0, seed=seed,
                                     imbalance_frac=0.0, device="cpu")
    ii, jj = call_pairs(sc.graph)
    w = np.random.default_rng(seed).uniform(0.5, 2.0, len(ii)).astype(np.float32)
    return sc.state, from_edges(ii, jj, w, SERVICES, device="cpu"), w


def multipliers(n_calls: int, seed: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).lognormal(-0.125, 0.5, (STEPS, n_calls)).astype(np.float32)


def reweighted(graph, w, m):
    """The service graph with call pair weights ``w·m`` (in f32, as the
    replay multiplies them)."""
    ii, jj = call_pairs(graph)
    return from_edges(ii, jj, (torch.from_numpy(w) * torch.from_numpy(m)).numpy(),
                      graph.num_services, device="cpu")


def step_plans(state, graph, seed=3):
    lay = sparse_layout(trace.pod_view(state, graph).sgraph, CFG)
    gen = torch.Generator().manual_seed(seed)
    return [draw_sparse_plans(gen, CFG.sweeps, lay) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def pods3():
    state, graph, w = instance(3)
    view = trace.pod_view(state, graph)
    assert view.sgraph.num_blocks > 2 and view.sgraph.hub_blocks
    return state, graph, w


def test_call_pairs_are_row_major_and_agree_across_forms(pods3):
    state, graph, _ = pods3
    ii, jj = call_pairs(graph)
    assert len(ii) == SERVICES - 1 and np.all(ii < jj)
    assert np.all(np.diff(ii * SERVICES + jj) > 0)
    dense_ii, dense_jj = call_pairs(graph.to_dense())
    assert np.array_equal(ii, dense_ii) and np.array_equal(jj, dense_jj)


def test_pod_view_is_built_once_a_pod_set(pods3):
    state, graph, _ = pods3
    view = trace.pod_view(state, graph)
    assert trace.pod_view(state.replace(pod_node=state.pod_node.flip(0)), graph) is view
    assert view.loc.num_edges == 9 * (SERVICES - 1)
    assert view.index.dtype == torch.int64
    assert torch.equal(view.pod_service, torch.arange(state.num_pods, dtype=torch.int32))


def test_fanout_weights_equal_pod_level_graph_of_the_reweighted_graph(pods3):
    state, graph, w = pods3
    view = trace.pod_view(state, graph)
    m = multipliers(view.num_calls)[0]
    fanned = with_edge_weights(view.sgraph, view.loc,
                               view.loc.base_w * torch.from_numpy(m)[view.index])
    want, _ = reorder_for_trace(pod_level_graph(state, reweighted(graph, w, m)))
    for name in ("w_local", "edges_w", "edges_src", "edges_dst", "perm", "u_ids"):
        assert torch.equal(getattr(fanned, name), getattr(want, name)), name


def test_pod_pair_calls_name_each_pod_pairs_services(pods3):
    state, graph, _ = pods3
    pg = pod_level_graph(state, graph)
    ii, jj = call_pairs(graph)
    idx = pod_pair_calls(state, pg, ii, jj, SERVICES)
    svc = state.pod_service.numpy()
    perm = pg.perm.numpy()
    a, b = svc[perm[pg.edges_src.numpy()]], svc[perm[pg.edges_dst.numpy()]]
    assert np.array_equal(np.minimum(a, b), ii[idx]) and np.array_equal(np.maximum(a, b), jj[idx])


def test_replay_steps_equal_global_assign_pods(pods3):
    state, graph, w = pods3
    mults = multipliers(SERVICES - 1)
    plans = step_plans(state, graph)
    final, objs, befores = trace.replay_on_device_pods(state, graph, mults, config=CFG,
                                                       plans=plans)
    cur = state
    for k in range(STEPS):
        pod_graph, _ = reorder_for_trace(pod_level_graph(cur, reweighted(graph, w, mults[k])))
        cur, info = global_assign_pods(cur, None, config=CFG, pod_graph=pod_graph,
                                       plan=plans[k])
        assert torch.equal(objs[k], info["objective_after"]), k
        assert torch.equal(befores[k], info["objective_before"]), k
    assert torch.equal(final.pod_node, cur.pod_node)
    assert torch.equal(final.pod_service, state.pod_service)
    assert bool((final.pod_node != state.pod_node).any())


def test_one_pod_a_service_equals_the_sparse_replay():
    state, graph, _ = instance(1, seed=4)
    mults = multipliers(SERVICES - 1, seed=5)
    plans = step_plans(state, graph, seed=6)
    p_state, p_objs, p_bef = trace.replay_on_device_pods(state, graph, mults, config=CFG,
                                                         plans=plans)
    sg, loc = reorder_for_trace(graph)
    ii, jj = call_pairs(graph)
    perm = sg.perm.numpy().astype(np.int64)
    E = loc.num_edges
    a, b = perm[sg.edges_src.numpy()[:E]], perm[sg.edges_dst.numpy()[:E]]
    order = np.searchsorted(ii * SERVICES + jj, np.minimum(a, b) * SERVICES + np.maximum(a, b))
    s_state, s_objs, s_bef = trace.replay_on_device_sparse(state, sg, loc, mults[:, order],
                                                           config=CFG, plans=plans)
    assert torch.equal(p_state.pod_node, s_state.pod_node)
    assert torch.equal(p_objs, s_objs) and torch.equal(p_bef, s_bef)


def test_replay_refuses_multipliers_not_one_a_call_pair(pods3):
    state, graph, _ = pods3
    with pytest.raises(ValueError, match="one a call pair"):
        trace.replay_on_device_pods(state, graph, np.ones((1, 9 * (SERVICES - 1))), config=CFG,
                                    generator=torch.Generator().manual_seed(0))


@pytest.fixture
def record():
    reg, tracer = MetricsRegistry(), spans.Tracer()
    prev_reg, prev_tracer = set_registry(reg), spans.set_tracer(tracer)
    try:
        yield reg, tracer
    finally:
        set_registry(prev_reg)
        spans.set_tracer(prev_tracer)


def series(reg, metric):
    return [r for r in reg.snapshot() if r["metric"] == metric]


@pytest.mark.parametrize("tracing", [True, False])
def test_fanout_phase_span_and_counter(record, tracing):
    reg, tracer = record
    # a fresh pod set, so that its graph is built under this record
    state, graph, _ = instance(3, seed=7)
    if tracing:
        tracer.enable()
    trace.replay_on_device_pods(state, graph, multipliers(SERVICES - 1)[:1], config=CFG,
                                generator=torch.Generator().manual_seed(0))
    phases = {r["labels"]["phase"]: r["value"]
              for r in series(reg, "solve_phase_device_seconds_total")}
    calls = [e for e in tracer.events if e.name == "replay/call"]
    if tracing:
        assert phases["fanout"] > 0 and "update" in phases
        assert {r["labels"]["fn"] for r in series(reg, "solve_phase_device_seconds_total")} \
            == {"replay_on_device_sparse"}
        assert [e.args["fn"] for e in calls] == ["replay_on_device_pods"]
    else:
        assert phases == {} and calls == []
    # the graph's build is set-up, recorded whether or not tracing is on
    build = [e for e in tracer.events if e.name == "pods/graph"]
    assert len(build) == 1
    view = trace.pod_view(state, graph)
    assert build[0].args == {"pods": 3 * SERVICES, "call_pairs": SERVICES - 1,
                             "pod_pairs": 9 * (SERVICES - 1),
                             "hub_blocks": len(view.sgraph.hub_blocks)}
    assert series(reg, "pod_graph_build_seconds_total")[0]["value"] > 0
    assert series(reg, "pod_graph_pairs")[0]["value"] == 9 * (SERVICES - 1)


@pytest.mark.parametrize("kind, marks", [("dense", 22), ("sparse", 31), ("pods", 32)])
def test_replay_bodies_keep_their_phase_marks(monkeypatch, kind, marks):
    """At 9 sweeps a dense replay's body marks 22 phase boundaries and a
    sparse one's 31 (each an event node of the captured graph on the card);
    only the pod replay adds one, ``fanout``."""
    from kubernetes_rescheduling_tpu_torch.solver import compiled
    from kubernetes_rescheduling_tpu_torch.telemetry import phases

    seen = []

    def run(self, fn, key, inputs, make_body, operands=()):
        rec = phases.Marks(fn, "host")
        with phases.recording(rec):
            out = make_body()(inputs)
        seen.append((fn, rec.names))
        return out

    monkeypatch.setattr(compiled.GraphCache, "run", run)
    cfg = GlobalSolverConfig(sweeps=9, fused_epilogue="on", capacity_frac=0.55)
    state, graph, w = instance(3 if kind == "pods" else 1, seed=8)
    gen = torch.Generator().manual_seed(0)
    if kind == "dense":
        ii, jj, mults = trace.drift_multipliers(graph.to_dense(), 1, seed=3)
        trace.replay_on_device(state, graph.to_dense(), ii, jj, mults, gen, cfg)
    elif kind == "sparse":
        sg, loc, mults = trace.drift_multipliers_sparse(graph, 1, seed=3)
        trace.replay_on_device_sparse(state, sg, loc, mults, gen, cfg)
    else:
        trace.replay_on_device_pods(state, graph, multipliers(len(w))[:1], gen, cfg)
    (fn, names), = seen
    assert fn == ("replay_on_device" if kind == "dense" else "replay_on_device_sparse")
    assert len(names) == marks
    assert ("fanout" in names) == (kind == "pods")
    assert names[:2] == (["fanout", "update"] if kind == "pods" else ["update", "setup"])
