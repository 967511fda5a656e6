"""Device-resident round scan: K controller rounds per dispatch — the solo
half of ``kubernetes_rescheduling_tpu.bench.scan``.

For the steady-state round (no churn, no breaker event, no checkpoint due,
a noise-free simulator) nothing in a round needs the host: the decision,
the simulator's round update (``backends/sim_device.py``) and the
round-end metrics are tensor math. :func:`scan_rounds` runs K of them back
to back and returns the whole block's diagnostics as ONE flat f32 tensor,
read by :func:`pull_block` — the module's one counted transfer
(``device_transfers_total{site="round_end"}``) per K rounds.

On the card a block is one replay of a CUDA graph captured per key (the
capture cache of ``solver/compiled.py``): the K round bodies unrolled into
one graph, with the state, the graphs' validity masks, the ``random``
policy's K noise rows and the tripwire thresholds as inputs and the
adjacencies and edge list as operands. The key is the bucket shapes, K,
``explain_k``, tripwire on or off, the policy and the threshold; the
captures count as ``cuda_graph_captures_total{fn="scan_rounds"}``, one a
key in steady state (the JAX package's ``jax_traces_total{fn=
"scan_rounds"} == 1``). On the CPU, and under ``compiled.eager()``, the
same body runs op by op. The body reads nothing back to the host.

The noise: the JAX package derives round r's key inside the trace; the
port draws round r's row on the host from the generator of ``(seed, r)``
(or the controller's ``gumbel_rows`` seam) before the block and uploads
the ``[K, N]`` rows through pinned memory without a wait.

The host half (:func:`decode_block`) slices the bundle back into per-round
views the controller replays into ordinary ``RoundRecord``s. With
attribution on (``attr_k`` > 0) each round's metrics carry its attribution
bundle after the ``[cost, load_std]`` head (``bench/round_end.py``), so
scanned records equal sequential ones attribution included; the S×S work
runs inside the captured graph, its temporaries freed into the graph's
private pool round by round.

The fleet half (:func:`fleet_scan_rounds`, :func:`decode_fleet_block`)
advances every tenant K rounds in one block: the solo round body per
tenant, in tenant order, with each tenant's rows, the per-round fleet
rollups (``telemetry/fleet_rollup.py``) and the per-tenant tripwire lanes
in one bundle, one capture a key (``fn="fleet_scan_rounds"``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch.backends.sim_device import apply_decision
from kubernetes_rescheduling_tpu_torch.bench.round_end import (
    METRIC_COST,
    METRIC_LOAD_STD,
    ROUND_END_SITE,
    round_end_metrics,
)
from kubernetes_rescheduling_tpu_torch.core.state import CommGraph
from kubernetes_rescheduling_tpu_torch.solver.compiled import CACHE
from kubernetes_rescheduling_tpu_torch.solver.fleet import prefixed, tenant_inputs
from kubernetes_rescheduling_tpu_torch.solver.global_solver import state_from_inputs, state_inputs
from kubernetes_rescheduling_tpu_torch.solver.round_loop import decide, decide_explain
from kubernetes_rescheduling_tpu_torch.telemetry.accounting import pull
from kubernetes_rescheduling_tpu_torch.telemetry.fleet_rollup import rollup_matrix, rollup_size
from kubernetes_rescheduling_tpu_torch.telemetry.tripwire import (
    fleet_tripwire_step,
    tripwire_init,
    tripwire_step,
)

# columns of the per-round decision row inside the block bundle
DEC_MOST, DEC_VICTIM, DEC_SERVICE, DEC_TARGET, DEC_LANDED = range(5)
DEC_COLS = 5
# the metrics head of a round ([cost, load_std]); the attribution bundle
# follows it when attr_k > 0
METRIC_HEAD = 2


def scan_body(t: dict, dec_adj: torch.Tensor, metric_adj: torch.Tensor, edges, *,
              policy_id: int, threshold: float, rounds: int, pinned: bool, explain_k: int,
              tripwire: bool, attr_k: int = 0) -> dict[str, torch.Tensor]:
    """K rounds of decide (or ``decide_explain``) → ``apply_decision`` →
    ``round_end_metrics`` → optional tripwire, as a function of device
    tensors that reads nothing back. ``t`` holds the state's arrays, the
    graphs' ``dec_valid`` / ``metric_valid`` masks, ``gumbel`` [K, N] for
    the ``random`` policy and ``trip_cfg`` with the tripwire on.

    Returns ``{"flat": f32[...]}``: the decision rows [K, 5], the hazard
    masks [K, N], the explain bundles [K, 6, k] (``explain_k`` > 0), the
    metrics [K, 2] (with ``attr_k`` > 0 [K, 2 + the attribution bundle's
    size]), each rounds-leading and raveled in that order; with the
    tripwire, then the bits [K] and the final ``(trip round, trip mask)``.
    A latched round's decision is masked to the ``-1`` no-op with
    ``torch.where``, so the rest of the block is identity rounds."""
    st = state_from_inputs(t)
    dec_graph = CommGraph(adj=dec_adj, service_valid=t["dec_valid"])
    metric_graph = CommGraph(adj=metric_adj, service_valid=t["metric_valid"])
    gumbel = t.get("gumbel")
    trip = None
    if tripwire:
        # block-start baselines
        base = round_end_metrics(st, metric_graph, edges=edges)
        trip = tripwire_init(base[METRIC_COST], base[METRIC_LOAD_STD])
    rows, hazards, bundles, metrics, bits = [], [], [], [], []
    for r in range(rounds):
        g = gumbel[r] if gumbel is not None else None
        if explain_k > 0:
            most, hazard, victim, svc, target, bundle = decide_explain(
                st, dec_graph, policy_id, threshold, g, top_k=explain_k)
            bundles.append(bundle)
        else:
            most, hazard, victim, svc, target = decide(st, dec_graph, policy_id, threshold, g)
        if tripwire:
            # latched: an identity round (-1 is the apply's no-op)
            latched = trip[0]
            most = torch.where(latched, -1, most)
            victim = torch.where(latched, -1, victim)
            target = torch.where(latched, -1, target)
            hazard = torch.where(latched, False, hazard)
        st, landed, _moved = apply_decision(st, victim, svc, target, hazard, pinned=pinned)
        m = round_end_metrics(st, metric_graph, top_k=attr_k, edges=edges)
        rows.append(torch.stack([x.float() for x in (most, victim, svc, target, landed)]))
        hazards.append(hazard.float())
        metrics.append(m)
        if tripwire:
            trip, b = tripwire_step(trip, st, m[METRIC_COST], m[METRIC_LOAD_STD], most,
                                    t["trip_cfg"])
            bits.append(b.float())
    pieces = [torch.stack(rows), torch.stack(hazards)]
    if explain_k > 0:
        pieces.append(torch.stack(bundles))
    pieces.append(torch.stack(metrics))
    if tripwire:
        pieces += [torch.stack(bits), torch.stack([trip[1], trip[2]]).float()]
    return {"flat": torch.cat([p.reshape(-1) for p in pieces])}


def scan_rounds(state, dec_graph, metric_graph, policy_id: int, threshold: float,
                gumbel: torch.Tensor | None = None, edges=None, trip_cfg=None, *,
                rounds: int, pinned: bool, explain_k: int, tripwire: bool = False,
                attr_k: int = 0) -> torch.Tensor:
    """One block of ``rounds`` rounds from ``state`` (:func:`scan_body`):
    the flat f32 bundle on the state's device. ``gumbel`` is the ``random``
    policy's ``[rounds, N]`` noise rows (None for the other policies),
    ``edges`` the metric graph's edge list (``objectives.metrics.
    comm_edge_list``; None with ``attr_k`` > 0, whose cost is the dense
    form), ``trip_cfg`` the tripwire thresholds
    (``telemetry.tripwire.trip_config_array``) when ``tripwire``, ``attr_k``
    the attribution's top-k (0 = off).

    On the card: a replay of the graph captured for this key, one capture a
    key; a capture or replay that fails raises."""
    if tripwire and trip_cfg is None:
        raise ValueError("scan_rounds(tripwire=True) needs trip_cfg")
    dev = state.device
    inputs = {**state_inputs(state), "dec_valid": dec_graph.service_valid,
              "metric_valid": metric_graph.service_valid}
    if gumbel is not None:
        if tuple(gumbel.shape) != (rounds, state.num_nodes):
            raise ValueError(f"gumbel rows {tuple(gumbel.shape)} != {(rounds, state.num_nodes)}")
        inputs["gumbel"] = gumbel
    if tripwire:
        inputs["trip_cfg"] = trip_cfg.to(dev)
    dec_adj, metric_adj = dec_graph.adj, metric_graph.adj
    static = dict(policy_id=int(policy_id), threshold=float(threshold), rounds=int(rounds),
                  pinned=bool(pinned), explain_k=int(explain_k), tripwire=bool(tripwire),
                  attr_k=int(attr_k))

    def make_body():
        return lambda t: scan_body(t, dec_adj, metric_adj, edges, **static)

    key = (tuple(sorted(static.items())), edges is None)
    out = CACHE.run("scan_rounds", key, inputs, make_body,
                    operands=(dec_adj, metric_adj, *(edges or ())))
    return out["flat"]


def fleet_scan_body(t: dict, adjs, edges, *, policy_id: int, threshold: float, rounds: int,
                    pinned: bool, tenants: int, rollup_k: int, tripwire: bool
                    ) -> dict[str, torch.Tensor]:
    """K fleet rounds as a function of device tensors that reads nothing
    back: per round, each tenant's ``decide`` → ``apply_decision`` →
    ``round_end_metrics`` (and tripwire lane), in tenant order. ``t`` holds
    each tenant's state arrays and ``service_valid`` under ``"<i>:"``,
    ``gumbel`` [K, T, N] for the ``random`` policy, ``drift`` [T] (the
    block-start reconcile drift, for the rollups) and ``trip_cfg``.

    Returns ``{"flat": f32[...]}``: decisions [K, T, 4] (``ROW_*`` of
    ``solver.fleet``), hazard [K, T, N], landings [K, T], metrics
    [K, T, 2], with ``rollup_k`` > 0 the rollups [K, rollup_size], each
    rounds-leading and raveled in that order; with the tripwire, then the
    bits [K, T] and the final per-tenant trip round [T] and mask [T]. A
    latched tenant runs identity rounds (its row masked to -1)."""
    T = tenants
    sts = [state_from_inputs(tenant_inputs(t, i)) for i in range(T)]
    graphs = [CommGraph(adj=adjs[i], service_valid=t[f"{i}:service_valid"]) for i in range(T)]
    gumbel = t.get("gumbel")

    def metrics_of(states):
        return torch.stack([round_end_metrics(s, g, edges=e)
                            for s, g, e in zip(states, graphs, edges)])

    trip = None
    if tripwire:
        base = metrics_of(sts)
        trip = tripwire_init(base[:, METRIC_COST], base[:, METRIC_LOAD_STD])
    outs: list[list[torch.Tensor]] = [[], [], [], [], [], []]
    for r in range(rounds):
        rows, hazards, landings = [], [], []
        for i in range(T):
            g = gumbel[r, i] if gumbel is not None else None
            most, hazard, victim, svc, target = decide(sts[i], graphs[i], policy_id, threshold, g)
            if tripwire:
                latched = trip[0][i]
                most, victim, svc, target = (torch.where(latched, -1, x)
                                             for x in (most, victim, svc, target))
                hazard = torch.where(latched, False, hazard)
            sts[i], landed, _moved = apply_decision(sts[i], victim, svc, target, hazard,
                                                    pinned=pinned)
            rows.append(torch.stack([x.float() for x in (most, victim, svc, target)]))
            hazards.append(hazard.float())
            landings.append(landed.float())
        metrics = metrics_of(sts)
        outs[0].append(torch.stack(rows))
        outs[1].append(torch.stack(hazards))
        outs[2].append(torch.stack(landings))
        outs[3].append(metrics)
        if rollup_k > 0:
            flags = torch.zeros((T, 3), dtype=torch.float32, device=metrics.device)
            flags[:, 2] = t["drift"]
            outs[4].append(rollup_matrix(torch.cat([metrics, flags], dim=1), top_k=rollup_k))
        if tripwire:
            most_row = torch.stack(rows)[:, 0].to(torch.int32)
            trip, bits = fleet_tripwire_step(trip, sts, metrics, most_row, t["trip_cfg"])
            outs[5].append(bits.float())
    pieces = [torch.stack(o).reshape(-1) for o in outs if o]
    if tripwire:
        pieces += [trip[1].float(), trip[2].float()]
    return {"flat": torch.cat(pieces)}


def fleet_scan_rounds(states, graphs, edges, policy_id: int, threshold: float,
                      gumbel: torch.Tensor | None = None, drift: torch.Tensor | None = None,
                      trip_cfg: torch.Tensor | None = None, *, rounds: int, pinned: bool,
                      rollup_k: int = 0, tripwire: bool = False) -> torch.Tensor:
    """One fleet block of ``rounds`` rounds (:func:`fleet_scan_body`) from
    the per-tenant ``states`` over ``graphs`` (each tenant's edge list in
    ``edges``): the flat f32 bundle on the states' device. ``gumbel`` is the
    ``random`` policy's ``[rounds, T, N]`` rows, ``drift`` the per-tenant
    reconcile drift at block start (needed when ``rollup_k`` > 0).

    On the card: a replay of the graph captured for this key, one capture a
    key (``fn="fleet_scan_rounds"``)."""
    T = len(states)
    if tripwire and trip_cfg is None:
        raise ValueError("fleet_scan_rounds(tripwire=True) needs trip_cfg")
    dev = states[0].device
    inputs = {}
    for i, (st, g) in enumerate(zip(states, graphs)):
        inputs.update(prefixed(i, {**state_inputs(st), "service_valid": g.service_valid}))
    if gumbel is not None:
        if tuple(gumbel.shape) != (rounds, T, states[0].num_nodes):
            raise ValueError(
                f"gumbel rows {tuple(gumbel.shape)} != {(rounds, T, states[0].num_nodes)}")
        inputs["gumbel"] = gumbel
    if rollup_k > 0:
        inputs["drift"] = (drift if drift is not None
                           else torch.zeros(T)).to(dev, torch.float32)
    if tripwire:
        inputs["trip_cfg"] = trip_cfg.to(dev)
    adjs = tuple(g.adj for g in graphs)
    edges = tuple(edges)
    static = dict(policy_id=int(policy_id), threshold=float(threshold), rounds=int(rounds),
                  pinned=bool(pinned), tenants=T, rollup_k=int(rollup_k),
                  tripwire=bool(tripwire))

    def make_body():
        return lambda t: fleet_scan_body(t, adjs, edges, **static)

    out = CACHE.run("fleet_scan_rounds", tuple(sorted(static.items())), inputs, make_body,
                    operands=(*adjs, *(x for e in edges for x in e)))
    return out["flat"]


def decode_fleet_block(flat: np.ndarray, *, rounds: int, tenants: int, num_nodes: int,
                       rollup_k: int = 0):
    """Unpack one fleet block bundle (its tripwire trail stripped):
    ``(decisions i64[K, T, 4], hazard bool[K, T, N], landed i64[K, T],
    metrics f32[K, T, 2])``, plus ``f32[K, rollup_size(rollup_k)]`` rollups
    when ``rollup_k`` > 0."""
    flat = np.asarray(flat, dtype=np.float32)
    k, t, n = rounds, tenants, num_nodes
    roll = rollup_size(rollup_k) if rollup_k > 0 else 0
    sizes = (k * t * 4, k * t * n, k * t, k * t * 2, k * roll)
    if flat.size != sum(sizes):
        raise ValueError(
            f"fleet scan bundle of {flat.size} values does not decode at rounds={k}, "
            f"tenants={t}, num_nodes={n}, rollup_k={rollup_k}"
        )
    o1, o2, o3, o4 = np.cumsum(sizes)[:4]
    decisions = flat[:o1].reshape(k, t, 4).astype(np.int64)
    hazard = flat[o1:o2].reshape(k, t, n) > 0.5
    landed = flat[o2:o3].reshape(k, t).astype(np.int64)
    metrics = flat[o3:o4].reshape(k, t, 2)
    if rollup_k <= 0:
        return decisions, hazard, landed, metrics
    return decisions, hazard, landed, metrics, flat[o4:].reshape(k, roll)


def pull_block(flat_dev: torch.Tensor, registry=None) -> np.ndarray:
    """THE scan module's device→host transfer: one counted ``round_end``
    pull per block."""
    return pull(flat_dev, site=ROUND_END_SITE, registry=registry)


@dataclass(frozen=True)
class RoundView:
    """One scanned round, decoded: the sequential loop's per-round
    quantities as host scalars and arrays."""

    most: int
    victim: int
    service: int
    target: int
    landed: int
    hazard: np.ndarray            # bool[N]
    cost: float
    load_std: float
    attr_flat: np.ndarray | None  # the flat attribution bundle (attr_k > 0)
    explain: np.ndarray | None    # f32[6, k] (explain_k > 0)

    @property
    def moved(self) -> bool:
        return self.landed >= 0


def decode_block(flat: np.ndarray, *, rounds: int, num_nodes: int, explain_k: int,
                 attr_k: int = 0) -> list[RoundView]:
    """Unpack one pulled block bundle into per-round views. The metrics'
    width is the residual length a round (the attribution bundle's size
    depends on top_k and the topology)."""
    flat = np.asarray(flat, dtype=np.float32)
    # decide_explain clamps its bundle to min(top_k, num_nodes) columns
    explain_k = min(explain_k, num_nodes)
    n_dec, n_hz, n_ex = rounds * DEC_COLS, rounds * num_nodes, rounds * 6 * explain_k
    n_metrics = flat.size - n_dec - n_hz - n_ex
    if (n_metrics < rounds * METRIC_HEAD or n_metrics % rounds
            or (attr_k <= 0 and n_metrics != rounds * METRIC_HEAD)):
        raise ValueError(
            f"scan block bundle of {flat.size} values does not decode at rounds={rounds}, "
            f"num_nodes={num_nodes}, explain_k={explain_k}, attr_k={attr_k}"
        )
    dec = flat[:n_dec].reshape(rounds, DEC_COLS).astype(np.int64)
    hazard = flat[n_dec:n_dec + n_hz].reshape(rounds, num_nodes) > 0.5
    off = n_dec + n_hz
    explain = flat[off:off + n_ex].reshape(rounds, 6, explain_k) if explain_k > 0 else None
    metrics = flat[off + n_ex:].reshape(rounds, n_metrics // rounds)
    return [
        RoundView(
            most=int(dec[r, DEC_MOST]), victim=int(dec[r, DEC_VICTIM]),
            service=int(dec[r, DEC_SERVICE]), target=int(dec[r, DEC_TARGET]),
            landed=int(dec[r, DEC_LANDED]), hazard=hazard[r],
            cost=float(metrics[r, METRIC_COST]), load_std=float(metrics[r, METRIC_LOAD_STD]),
            attr_flat=metrics[r, METRIC_HEAD:] if attr_k > 0 else None,
            explain=explain[r] if explain is not None else None,
        )
        for r in range(rounds)
    ]


# ---- scan-plane accounting ----


def count_scan_block(registry, rounds: int) -> None:
    """One scan dispatch landed: count the block and publish how many rounds
    it advanced."""
    registry.counter(
        "scan_blocks_total",
        "device-resident scan blocks dispatched (each advances scan_rounds_per_dispatch "
        "rounds in one captured program)",
    ).inc()
    registry.gauge("scan_rounds_per_dispatch",
                   "rounds advanced by the most recent scan-block dispatch").set(rounds)


def count_scan_drain(registry, reason: str) -> None:
    """A round ran on the per-round path while the scanned schedule was
    configured."""
    registry.counter(
        "scan_drains_total",
        "rounds drained from the scanned schedule to the per-round path, by reason",
        labelnames=("reason",),
    ).labels(reason=reason).inc()
