"""Trace replay: streaming communication-matrix updates and online
rescheduling — the port of ``kubernetes_rescheduling_tpu.bench.trace``.

The comm graph is data: edge weights stream in over time, the same
captured solve re-runs per step (static shapes, weights as data — one
capture per shape, ``solver/compiled.py``), and the replay records how the
placement tracks the moving objective. Ships a Bookinfo-style topology
(productpage → details/reviews, reviews → ratings, three review versions)
and a canary trace that shifts traffic v1 → v2 → v3.

:func:`replay_on_device`, :func:`replay_on_device_sparse` and
:func:`replay_on_device_pods` run every step on the card with no host read
between steps: each step — the weight update, then the solve on the
previous step's state — is one replay of the graph captured for the step,
its inputs (the step's multipliers, plans and seeds) copied into the
graph's buffers first. With ``restarts`` R > 1 a step is a best-of-R: R
replays of that graph with R plans, the best picked on the device.

:func:`replay` runs each step as ``parallel.solve_with_restarts``, so
``restarts > 1`` is a best-of-N solve there too. :func:`observed_step`
turns the load generator's observed traffic into a step.

While tracing is on (``telemetry/spans.py``), a device replay call is the
hot span ``replay/call``, its plan draw ``replay/plans`` and its uploads
``replay/stage``; its bodies mark the phase ``update`` (the weight
scatter) before the solve's own phases (``telemetry/phases.py``), a pod
replay's the phase ``fanout`` (call-pair weights to pod pairs) before it.
The pod replay's graph build, once a pod set, is the span ``pods/graph``,
its seconds the counter ``pod_graph_build_seconds_total`` and its pod
pairs the gauge ``pod_graph_pairs``.
"""

from __future__ import annotations

import dataclasses
import json
import time
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch.core.sparsegraph import (
    SparseCommGraph,
    TraceLocator,
    reorder_for_trace,
    with_edge_weights,
)
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.core.workmodel import ServiceSpec, Workmodel
from kubernetes_rescheduling_tpu_torch.objectives.metrics import communication_cost, load_std
from kubernetes_rescheduling_tpu_torch.solver.compiled import CACHE, to_device
from kubernetes_rescheduling_tpu_torch.solver.global_solver import (
    COMPOSITION_BLOCK,
    GlobalSolverConfig,
    check_weight_budget,
    dense_layout,
    dense_plan_inputs,
    dense_solve,
    draw_plans,
    state_from_inputs,
    state_inputs,
)
from kubernetes_rescheduling_tpu_torch.solver.pod_mode import (
    call_pairs,
    pod_level_graph,
    pod_pair_calls,
)
from kubernetes_rescheduling_tpu_torch.solver.sparse_solver import (
    SPARSE_OPERANDS,
    count_chunk_steps,
    draw_sparse_plans,
    sparse_layout,
    sparse_plan_inputs,
    sparse_solve,
    sparse_static,
    sparse_tables,
)
from kubernetes_rescheduling_tpu_torch.telemetry.phases import phase_mark
from kubernetes_rescheduling_tpu_torch.telemetry.registry import get_registry
from kubernetes_rescheduling_tpu_torch.telemetry.spans import span
from kubernetes_rescheduling_tpu_torch.utils.logging import get_logger


@dataclass(frozen=True)
class TraceStep:
    """One streaming update: new weights for a set of service pairs."""

    t: float
    weights: dict[tuple[str, str], float] = field(default_factory=dict)


def with_weights(
    graph: CommGraph,
    updates: dict[tuple[str, str], float],
    *,
    registry=None,
    logger=None,
) -> CommGraph:
    """A new CommGraph with the given symmetric edge weights applied.

    Updates naming a service the graph does not know are dropped, never
    silently: each is counted (``trace_unknown_refs_total``) and the batch
    logs one structured ``swallowed_ref`` event."""
    adj = graph.adj.cpu().numpy().copy()
    index = {n: i for i, n in enumerate(graph.names)}
    swallowed: list[tuple[str, str]] = []
    for (a, b), w in updates.items():
        if a not in index or b not in index:
            swallowed.append((a, b))
            continue
        i, j = index[a], index[b]
        adj[i, j] = w
        adj[j, i] = w
    if swallowed:
        reg = registry if registry is not None else get_registry()
        reg.counter(
            "trace_unknown_refs_total",
            "streaming-trace weight updates dropped because a service "
            "name is not in the comm graph (a malformed trace stays "
            "visible, never a silent no-op)",
        ).inc(len(swallowed))
        (logger if logger is not None else get_logger("trace")).warn(
            "swallowed_ref",
            dropped=len(swallowed),
            refs=[f"{a}~{b}" for a, b in swallowed[:8]],
        )
    return dataclasses.replace(graph, adj=torch.as_tensor(adj, device=graph.device))


def bookinfo_workmodel(replicas: int = 1) -> Workmodel:
    """Istio Bookinfo: productpage → details + reviews-v{1,2,3};
    reviews-v{2,3} → ratings."""
    return Workmodel(
        services=(
            ServiceSpec(
                name="productpage",
                callees=("details", "reviews-v1", "reviews-v2", "reviews-v3"),
                replicas=replicas,
            ),
            ServiceSpec(name="details", replicas=replicas),
            ServiceSpec(name="reviews-v1", replicas=replicas),
            ServiceSpec(name="reviews-v2", callees=("ratings",), replicas=replicas),
            ServiceSpec(name="reviews-v3", callees=("ratings",), replicas=replicas),
            ServiceSpec(name="ratings", replicas=replicas),
        ),
        source="builtin:bookinfo",
    )


def canary_trace(steps: int = 12) -> list[TraceStep]:
    """Traffic shifting v1 → v2 → v3: the productpage→reviews edge weights
    move in thirds over the trace, and each reviews→ratings edge carries its
    version's share."""
    out: list[TraceStep] = []
    for k in range(steps):
        frac = k / max(steps - 1, 1)
        v1 = max(0.0, 1.0 - 2 * frac)
        v3 = max(0.0, 2 * frac - 1.0)
        v2 = 1.0 - v1 - v3
        out.append(TraceStep(t=float(k), weights={
            ("productpage", "reviews-v1"): v1,
            ("productpage", "reviews-v2"): v2,
            ("productpage", "reviews-v3"): v3,
            ("reviews-v2", "ratings"): v2,
            ("reviews-v3", "ratings"): v3,
        }))
    return out


def load_trace(path: str | Path) -> list[TraceStep]:
    """Parse an external trace stream: JSONL, one step per line::

        {"t": 1.0, "weights": [["productpage", "reviews-v2", 0.9], ...]}

    ``weights`` entries are ``[service_a, service_b, weight]`` (symmetric
    pairs). A missing ``t`` defaults to the line index."""
    steps: list[TraceStep] = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        d = json.loads(line)
        steps.append(TraceStep(
            t=float(d.get("t", len(steps))),
            weights={(str(a), str(b)): float(w) for a, b, w in d.get("weights", [])},
        ))
    return steps


def observed_step(t: float, loadgen, samples) -> TraceStep:
    """A :class:`TraceStep` whose weights are the load generator's OBSERVED
    per-pair traffic (``LoadGenerator.observed_weights``): measured traffic
    streamed into :func:`replay` instead of a hand-written weight schedule
    (reference README.md:47)."""
    return TraceStep(t=t, weights=loadgen.observed_weights(samples.edge_counts, samples.sent))


@dataclass
class ReplayRecord:
    t: float
    cost_before_solve: float  # under the NEW weights, old placement
    cost_after_solve: float
    load_std_before: float
    load_std_after: float
    moves: int


def replay(
    state: ClusterState,
    graph: CommGraph,
    trace: list[TraceStep],
    *,
    generator: torch.Generator | None = None,
    config: GlobalSolverConfig = GlobalSolverConfig(sweeps=4),
    restarts: int = 1,
    plans: list | None = None,
) -> tuple[ClusterState, list[ReplayRecord]]:
    """Online rescheduling over a streaming trace, one host-side step at a
    time (each step's record is read back).

    Every step's solve reuses one captured graph: the weights are written
    into one adjacency buffer that the graph reads, so a new weight set is
    data, not a new shape. Each step is ``parallel.solve_with_restarts``:
    ``restarts > 1`` makes it a best-of-N solve (in sequence on one
    device). ``generator`` draws each step's plans unless ``plans`` (one
    per step; with restarts, one list of plan lists a step) gives them."""
    from kubernetes_rescheduling_tpu_torch.parallel.sharded import solve_with_restarts

    known = set(graph.names)
    unknown = sorted({n for step in trace for pair in step.weights for n in pair} - known)
    if unknown:
        warnings.warn(
            f"trace weights reference services not in the workmodel "
            f"(ignored): {unknown[:10]}{'…' if len(unknown) > 10 else ''}",
            stacklevel=2,
        )
    adj = graph.adj.clone()
    records: list[ReplayRecord] = []
    for k, step in enumerate(trace):
        adj.copy_(with_weights(graph, step.weights).adj)
        graph = dataclasses.replace(graph, adj=adj)
        before = float(communication_cost(state, graph))
        step_plans = None
        if plans is not None:
            step_plans = plans[k] if restarts > 1 else [plans[k]]
        with span("trace/step", t=step.t):
            new_state, _ = solve_with_restarts(state, graph, generator, n_restarts=restarts,
                                               config=config, plans=step_plans)
        moves = int((state.pod_valid & (state.pod_node != new_state.pod_node)).sum())
        records.append(ReplayRecord(
            t=step.t,
            cost_before_solve=before,
            cost_after_solve=float(communication_cost(new_state, graph)),
            load_std_before=float(load_std(state)),
            load_std_after=float(load_std(new_state)),
            moves=moves,
        ))
        state = new_state
    return state, records


def drift_multipliers(graph: CommGraph, steps: int, *, sigma: float = 0.5, seed: int = 0):
    """Synthetic traffic drift at scale: per-step lognormal multipliers for
    every declared pair. Returns ``(ii, jj, mults[steps, E])`` (numpy) for
    :func:`replay_on_device`. Mean-one multipliers keep total traffic
    stationary while individual edges heat and cool."""
    adj = graph.adj.cpu().numpy()
    ii, jj = np.nonzero(np.triu(adj, k=1))
    rng = np.random.default_rng(seed)
    mults = np.exp(
        rng.normal(-0.5 * sigma * sigma, sigma, size=(steps, len(ii)))
    ).astype(np.float32)
    return ii.astype(np.int32), jj.astype(np.int32), mults


def drift_multipliers_sparse(sgraph: SparseCommGraph, steps: int, *, sigma: float = 0.5,
                             seed: int = 0):
    """Sparse twin of :func:`drift_multipliers`: per-step mean-one lognormal
    multipliers for every undirected edge, with the trace-reordered graph
    and its canonical :class:`TraceLocator`. Returns ``(sgraph_reordered,
    locator, mults)``; replay with the reordered graph."""
    sg2, loc = reorder_for_trace(sgraph)
    rng = np.random.default_rng(seed)
    mults = np.exp(
        rng.normal(-0.5 * sigma * sigma, sigma, size=(steps, loc.num_edges))
    ).astype(np.float32)
    return sg2, loc, mults


def _replay_steps(fn, key, state, step_inputs, make_body, operands):
    """Run the steps: each one replay (or, eagerly, one body) on the
    previous step's state, or with several restarts (a list of inputs a
    step) one replay each and the best ``objective_after + move_penalty``
    (the first on ties) picked on the device. Returns ``(final_state,
    objs, befores)``."""
    objs, befores = [], []
    for t in step_inputs:
        outs = [CACHE.run(fn, key, {**state_inputs(state), **r}, make_body, operands)
                for r in (t if isinstance(t, list) else [t])]
        pick = outs[0]
        if len(outs) > 1:
            best = torch.argmin(torch.stack([o["objective_after"] + o["move_penalty"]
                                             for o in outs])).reshape(1)
            pick = {k: torch.stack([o[k] for o in outs]).index_select(0, best)[0]
                    for k in ("pod_node", "objective_after", "objective_before")}
        state = state.replace(pod_node=pick["pod_node"])
        objs.append(pick["objective_after"])
        befores.append(pick["objective_before"])
    return state, torch.stack(objs), torch.stack(befores)


def _restart_plans(plans, steps: int, restarts: int, draw):
    """Per step, one plan list a restart: ``plans`` as given (a plan list a
    step, or with restarts a list of them), else drawn by ``draw()``."""
    if plans is None:
        return [[draw() for _ in range(restarts)] for _ in range(steps)]
    return [p if restarts > 1 else [p] for p in plans]


def _mults_on(mults, dev) -> torch.Tensor:
    return to_device(torch.as_tensor(np.asarray(mults, dtype=np.float32)), dev)


def replay_on_device(
    state: ClusterState,
    graph: CommGraph,
    ii,
    jj,
    mults,
    generator: torch.Generator | None = None,
    config: GlobalSolverConfig = GlobalSolverConfig(),
    *,
    plans: list | None = None,
    restarts: int = 1,
):
    """The streaming-trace path: per step, the edge weights are updated by
    that step's multipliers (a scatter into the base adjacency) and the
    same captured solve consumes the previous step's placement; no host
    read between steps. ``restarts`` R > 1 makes each step a best-of-R over
    the same captured graph. ``plans`` (one list of sweep plans per step;
    with restarts, R of them a step) or ``generator`` gives each step's
    random decisions. Returns ``(final_state, objs[steps],
    costs_before[steps])``: each step's objective under its new weights
    after and before its solve."""
    with span("replay/call", hot=True, fn="replay_on_device", steps=len(mults),
              restarts=restarts):
        return _replay_dense(state, graph, ii, jj, mults, generator, config, plans, restarts)


def _replay_dense(state, graph, ii, jj, mults, generator, config, plans, restarts):
    dev = state.device
    lay = dense_layout(graph.num_services, state.num_nodes, config, dev)
    check_weight_budget(lay.sp, config)
    block = COMPOSITION_BLOCK if lay.inline_mass else 1
    with span("replay/plans", hot=True):
        plans = _restart_plans(plans, len(mults), restarts, lambda: draw_plans(
            generator, config.sweeps, lay.sp, lay.chunk, lay.n_chunks, block))
    with span("replay/stage", hot=True):
        m = _mults_on(mults, dev)
        base = {"service_valid": graph.service_valid,
                "ii": to_device(torch.as_tensor(np.asarray(ii, dtype=np.int64)), dev),
                "jj": to_device(torch.as_tensor(np.asarray(jj, dtype=np.int64)), dev)}
        step_inputs = [[dict(base, mult=m[k], **dense_plan_inputs(p, lay, config, dev,
                                                                   generator))
                        for p in step] for k, step in enumerate(plans)]
    base_adj = graph.adj

    def make_body():
        def step(t):
            phase_mark("update")
            w = base_adj[t["ii"], t["jj"]] * t["mult"]
            adj_t = base_adj.index_put((t["ii"], t["jj"]), w).index_put((t["jj"], t["ii"]), w)
            g = CommGraph(adj=adj_t, service_valid=t["service_valid"])
            return dense_solve(state_from_inputs(t), g, config, lay, t)
        return step

    return _replay_steps("replay_on_device", (config, lay), state, step_inputs, make_body,
                         (base_adj,))


def replay_on_device_sparse(
    state: ClusterState,
    sgraph: SparseCommGraph,
    loc: TraceLocator,
    mults,
    generator: torch.Generator | None = None,
    config: GlobalSolverConfig = GlobalSolverConfig(),
    *,
    plans: list | None = None,
    restarts: int = 1,
):
    """Sparse-solver streaming replay: per step the undirected-edge weights
    are scattered into the block-local strips and the COO list through the
    static :class:`TraceLocator` (:func:`with_edge_weights`), and the same
    captured sparse solve consumes the previous step's placement; no host
    read between steps (``restarts`` and ``plans`` as in
    :func:`replay_on_device`). Requires a multi-block graph (the
    single-block case belongs to the dense replay). Returns
    ``(final_state, objs[steps], costs_before[steps])``."""
    if sgraph.num_blocks <= 1:
        raise ValueError(
            "single-block sparse graphs delegate to the dense solver — "
            "use replay_on_device with the dense graph instead"
        )
    with span("replay/call", hot=True, fn="replay_on_device_sparse", steps=len(mults),
              restarts=restarts):
        return _replay_sparse(state, sgraph, loc, mults, generator, config, plans, restarts)


def _replay_sparse(state, sgraph, loc, mults, generator, config, plans, restarts,
                   fanout=None):
    """The sparse replay's steps; ``fanout`` (i64[E], a pod replay's) takes
    each edge's weight from ``mult[fanout]``, ``mult`` one a call pair."""
    dev = state.device
    lay = sparse_layout(sgraph, config)
    with span("replay/plans", hot=True):
        plans = _restart_plans(plans, len(mults), restarts,
                               lambda: draw_sparse_plans(generator, config.sweeps, lay))
    with span("replay/stage", hot=True):
        m = _mults_on(mults, dev)
        step_inputs = [[dict(mult=m[k], **sparse_plan_inputs(p, lay, config, state.num_nodes,
                                                             dev, generator))
                        for p in step] for k, step in enumerate(plans)]

    def make_body():
        tables = sparse_tables(sgraph, lay, dev)

        def step(t):
            mult = t["mult"]
            if fanout is not None:
                phase_mark("fanout")
                mult = mult[fanout]
            phase_mark("update")
            sg_t = with_edge_weights(sgraph, loc, loc.base_w * mult)
            return sparse_solve(state_from_inputs(t), sg_t, config, lay, tables, t)
        return step

    operands = [getattr(sgraph, k) for k in SPARSE_OPERANDS] + [
        loc.coo, loc.w_rows, loc.w_cols, loc.base_w] + ([] if fanout is None else [fanout])
    out = _replay_steps("replay_on_device_sparse",
                        (config, lay, sparse_static(sgraph), loc.canonical), state,
                        step_inputs, make_body, operands)
    count_chunk_steps("replay_on_device_sparse", lay, config, dev,
                      sum(len(step) for step in step_inputs))
    return out


@dataclass(frozen=True)
class PodView:
    """A pod set's side of the per-pod replay: the pod-level graph in
    trace order with its locator, each locator edge's call pair
    (``index``, i64[pod pairs], into :func:`pod_mode.call_pairs` of the
    service graph), and the pods as their own services
    (``pod_service`` = ``arange(P)``, as ``global_assign_pods`` views
    them)."""

    sgraph: SparseCommGraph
    loc: TraceLocator
    index: torch.Tensor
    pod_service: torch.Tensor
    num_calls: int


# pod views kept: each holds its keys (so an id cannot be reused while it
# is here) and a pod-level graph on the device
_POD_VIEWS: OrderedDict[tuple, tuple] = OrderedDict()
_MAX_POD_VIEWS = 2


def pod_view(state: ClusterState, graph: CommGraph | SparseCommGraph) -> PodView:
    """The :class:`PodView` of ``state``'s pods under ``graph``, built once
    for each pod set (the same ``graph``, ``pod_service`` and
    ``pod_valid`` objects; a placement is not part of it)."""
    keyed = (graph, state.pod_service, state.pod_valid)
    key = tuple(id(x) for x in keyed)
    hit = _POD_VIEWS.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], keyed)):
        _POD_VIEWS.move_to_end(key)
        return hit[1]
    t0 = time.perf_counter()
    with span("pods/graph", pods=state.num_pods) as args:
        ii, jj = call_pairs(graph)
        sg, loc = reorder_for_trace(pod_level_graph(state, graph))
        # canonical locator: edge e is the COO list's slot e
        index = pod_pair_calls(state, sg, ii, jj, graph.num_services)[:loc.num_edges]
        view = PodView(sg, loc, torch.as_tensor(index, device=state.device),
                       torch.arange(state.num_pods, dtype=torch.int32, device=state.device),
                       len(ii))
        args.update(call_pairs=len(ii), pod_pairs=loc.num_edges, hub_blocks=len(sg.hub_blocks))
    reg = get_registry()
    reg.counter("pod_graph_build_seconds_total",
                "seconds spent building pod replays' pod-level graphs, trace order and "
                "call-pair index (once a pod set)").inc(time.perf_counter() - t0)
    reg.gauge("pod_graph_pairs", "undirected pod pairs of the last pod-level graph "
              "built for a pod replay").set(loc.num_edges)
    _POD_VIEWS[key] = (keyed, view)
    while len(_POD_VIEWS) > _MAX_POD_VIEWS:
        _POD_VIEWS.popitem(last=False)
    return view


def replay_on_device_pods(
    state: ClusterState,
    graph: CommGraph | SparseCommGraph,
    mults,
    generator: torch.Generator | None = None,
    config: GlobalSolverConfig = GlobalSolverConfig(),
    *,
    plans: list | None = None,
    restarts: int = 1,
):
    """Per-pod streaming replay: every pod is placed on its own, and a step
    re-weights call pairs, as a controller sees them. ``state`` holds the
    pods (a service's pods share its ``pod_service``), ``graph`` is the
    service-level graph and ``mults`` [steps, call pairs] one multiplier a
    call pair a step, the call pairs ``(i, j)``, ``i < j`` in service ids,
    row-major (:func:`pod_mode.call_pairs`). A step multiplies every pod
    pair of a call pair by its multiplier (one gather inside the captured
    body), then runs :func:`replay_on_device_sparse`'s step on the
    pod-level graph (:func:`pod_view`, built once a pod set), whose
    capture and phases it shares. ``plans`` (drawn at the pod-level
    layout), ``generator`` and ``restarts`` as there. Returns
    ``(final_state, objs[steps], costs_before[steps])``, the pods'
    placements on ``state`` and the pod-level objectives."""
    view = pod_view(state, graph)
    if view.sgraph.num_blocks <= 1:
        raise ValueError(
            "a pod set of one block delegates to the dense solver — "
            "use replay_on_device with a dense pod-level graph instead"
        )
    if np.shape(mults)[1:] != (view.num_calls,):
        raise ValueError(f"mults must be [steps, {view.num_calls}] (one a call pair), "
                         f"got {np.shape(mults)}")
    pods = state.replace(pod_service=view.pod_service)
    with span("replay/call", hot=True, fn="replay_on_device_pods", steps=len(mults),
              restarts=restarts):
        final, objs, befores = _replay_sparse(pods, view.sgraph, view.loc, mults, generator,
                                              config, plans, restarts, fanout=view.index)
    return state.replace(pod_node=final.pod_node), objs, befores
