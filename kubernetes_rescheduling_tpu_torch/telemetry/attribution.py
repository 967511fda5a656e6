"""Communication-cost attribution & topology plane: the host half.

The controller's telemetry historically reported the objective only as an
opaque scalar — an operator could see *that* ``communication_cost``
changed but never *which* service edges or node pairs carry it, or
*which* moves paid for an improvement. This module turns the one-transfer
device bundle (``objectives.metrics.communication_cost_attribution``,
pulled with ``site="attribution"``) into:

- an **attribution record** per round — top-k service-edge rows
  (src/dst service, dominant src/dst node, cost), the node-pair cost
  matrix, per-node ingress/egress totals, and the tail (cost outside the
  top-k) — riding on ``RoundRecord.attribution`` → ``rounds.jsonl`` →
  flight-recorder bundles;
- **cardinality-bounded Prometheus gauges** — fixed top-k label sets:
  ``comm_cost_node_pair{src,dst}`` (unordered pairs, ≤ N·(N−1)/2
  children over a run), ``comm_cost_node_ingress|egress{node}`` (≤ N),
  and the rank-labeled ``comm_cost_edge_topk{rank}`` (≤ k);
- a **placement timeline / move-provenance tracker**
  (:class:`PlacementTimeline`): service→node residency over rounds, each
  applied move linked to its per-edge cost delta, deltas telescoping to
  the round's objective delta.

The audit invariant, in the spirit of
``telemetry.explain.explanation_consistent``
(:func:`attribution_consistent` / :func:`check_attribution`): per-edge
contributions (top-k + the explicitly-carried tail) must sum to the
recorded ``communication_cost`` scalar (f32 tolerance), ingress and
egress totals must each sum to it too, and every move's per-edge deltas
must sum to its recorded ``cost_delta`` with the round's move deltas
summing to the recorded ``objective_delta``. An attribution that cannot
re-derive its own totals is a bug, not a rendering problem.

The port of ``kubernetes_rescheduling_tpu.telemetry.attribution``: the
device bundle arrives as a plain ndarray in the round's one ``round_end``
transfer; the timeline's initial residency is collapsed host-side once at
bind time.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Iterable

import numpy as np

from kubernetes_rescheduling_tpu_torch.telemetry.registry import MetricsRegistry

ATTRIBUTION_SITE = "attribution"

# f32 tolerance for the sum checks: the device reduces in a different
# association order than the host re-derivation
_RTOL = 1e-4
_ATOL = 1e-2


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _name(names: tuple[str, ...] | list[str], i: int, prefix: str) -> str:
    return names[i] if 0 <= i < len(names) else f"{prefix}{i}"


def decode_attribution(
    bundle: np.ndarray,
    *,
    node_names: tuple[str, ...],
    service_names: tuple[str, ...],
    top_k: int,
    num_nodes: int,
    num_services: int,
) -> dict[str, Any]:
    """Flat device bundle → the JSONL-safe attribution record.

    ``num_nodes``/``num_services`` are the PADDED capacities the kernel
    ran with (array shapes); the name tuples carry only real entries —
    padded indices (which can only appear with zero cost) fall back to
    synthetic names. Ingress/egress are the half-weighted row/column sums
    of the node-pair matrix, so each totals to the cost scalar.
    """
    flat = np.asarray(bundle, dtype=np.float64).reshape(-1)
    k = max(1, min(int(top_k), num_services * num_services))
    expect = 2 + 5 * k + num_nodes * num_nodes
    if flat.size != expect:
        raise ValueError(
            f"attribution bundle has {flat.size} values, expected {expect} "
            f"(top_k={top_k}, num_nodes={num_nodes})"
        )
    total = float(flat[0])
    tail = float(flat[1])
    rows = flat[2 : 2 + 5 * k].reshape(k, 5)
    m = flat[2 + 5 * k :].reshape(num_nodes, num_nodes)

    edges = []
    for r in rows:
        si, di, a, b = (int(v) for v in r[:4])
        if si < 0 or di < 0:
            continue
        edges.append(
            {
                "src_service": _name(service_names, si, "svc"),
                "dst_service": _name(service_names, di, "svc"),
                "src_node": _name(node_names, a, "node") if a >= 0 else None,
                "dst_node": _name(node_names, b, "node") if b >= 0 else None,
                "cost": float(r[4]),
            }
        )

    nodes = [_name(node_names, i, "node") for i in range(num_nodes)]
    # the positive entries in row-major order (np.nonzero's), as the JAX
    # package's double loop lists them
    pa, pb = np.nonzero(m > 0)
    node_pairs = [
        [nodes[a], nodes[b], float(v)]
        for a, b, v in zip(pa.tolist(), pb.tolist(), m[pa, pb].tolist())
    ]
    ingress = {nodes[i]: float(0.5 * m[:, i].sum()) for i in range(num_nodes)}
    egress = {nodes[i]: float(0.5 * m[i, :].sum()) for i in range(num_nodes)}
    # real nodes only in the per-node maps once padding contributes nothing
    real = set(node_names)
    if real:
        ingress = {n: v for n, v in ingress.items() if n in real or v > 0}
        egress = {n: v for n, v in egress.items() if n in real or v > 0}
    return {
        "total": total,
        "tail": tail,
        "edges": edges,
        "node_pairs": node_pairs,
        "ingress": ingress,
        "egress": egress,
    }


def _close(a: float, b: float, scale: float) -> bool:
    return abs(a - b) <= _ATOL + _RTOL * max(1.0, abs(scale))


def attribution_consistent(
    attr: dict[str, Any],
    *,
    communication_cost: float | None = None,
) -> bool:
    """Re-derive the attribution's own totals — the audit invariant.

    - Σ(top-k edge costs) + tail == total;
    - Σ ingress == total == Σ egress (the node-pair collapse preserves
      the scalar);
    - total == the recorded ``communication_cost`` scalar when given;
    - per move: Σ(edge deltas) == cost_delta; per round:
      Σ(move cost_deltas) == objective_delta (skipped for pod-level
      rounds, which record moves without service-collapsed deltas).
    """
    if not isinstance(attr, dict):
        return False
    total = attr.get("total")
    if total is None or not math.isfinite(total):
        return False
    scale = total
    edge_sum = sum(e.get("cost", 0.0) for e in attr.get("edges") or ())
    if not _close(edge_sum + attr.get("tail", 0.0), total, scale):
        return False
    for key in ("ingress", "egress"):
        side = attr.get(key)
        if side is not None and not _close(sum(side.values()), total, scale):
            return False
    if communication_cost is not None and not _close(
        total, communication_cost, scale
    ):
        return False
    moves = attr.get("moves")
    if moves:
        delta_sum = 0.0
        for mv in moves:
            d = mv.get("cost_delta")
            if d is None:
                continue  # pod-level move: no service-collapsed delta
            per_edge = sum(e.get("delta", 0.0) for e in mv.get("edges") or ())
            if not _close(per_edge, d, scale):
                return False
            delta_sum += d
        obj_delta = attr.get("objective_delta")
        if obj_delta is not None and not _close(delta_sum, obj_delta, scale):
            return False
    return True


def iter_attributions(
    records: Iterable[dict[str, Any]],
) -> list[tuple[dict[str, Any], float | None]]:
    """(attribution, recorded cost scalar) pairs from a mixed record
    stream: ``rounds.jsonl`` round dicts, flight-recorder ring entries
    (``record`` nested), or bare attribution dicts."""
    out = []
    for r in records:
        if not isinstance(r, dict):
            continue
        rec = r.get("record") if isinstance(r.get("record"), dict) else r
        attr = rec.get("attribution")
        if isinstance(attr, dict):
            out.append((attr, rec.get("communication_cost")))
        elif "total" in r and ("edges" in r or "node_pairs" in r):
            out.append((r, None))
    return out


def check_attribution(
    records: Iterable[dict[str, Any]],
) -> tuple[int, list[dict[str, Any]]]:
    """(checked, inconsistent) over a record stream — the bundle
    summarizer's and the acceptance test's shared verdict."""
    checked = 0
    bad = []
    for attr, cost in iter_attributions(records):
        checked += 1
        if not attribution_consistent(attr, communication_cost=cost):
            bad.append(attr)
    return checked, bad


# ---------------- Prometheus gauges (cardinality-bounded) ----------------


def _zero_family(fam) -> None:
    """Stale children keep their last value forever otherwise — a node
    pair that leaves the top-k must read 0, not its old cost."""
    for _labels, leaf in fam._series():
        if leaf is not fam:
            leaf.set(0.0)


def publish_attribution(
    registry: MetricsRegistry, attr: dict[str, Any], *, top_k: int
) -> None:
    """One gauge sample set per round. Label cardinality is bounded by
    construction: node pairs draw from the run's fixed node set (≤
    N·(N−1) children ever), per-node totals from the node set (≤ N), and
    the edge top-k is RANK-labeled (≤ k) — service names never become
    label values, so a large service graph cannot explode the registry.
    """
    pair_fam = registry.gauge(
        "comm_cost_node_pair",
        "communication cost carried between an unordered node pair "
        "(top-k pairs by cost; pairs outside the top-k read 0)",
        labelnames=("src", "dst"),
    )
    _zero_family(pair_fam)
    # UNORDERED pairs (the matrix is symmetric — publishing both
    # directions would double-count and waste half the top-k budget);
    # each pair carries its full cost, so an untruncated family sums to
    # the scalar — with more than top_k active pairs the tail is dropped,
    # which the HELP text says out loud
    seen: set[frozenset] = set()
    pairs = []
    for src, dst, cost in sorted(
        attr.get("node_pairs") or (), key=lambda p: p[2], reverse=True
    ):
        key = frozenset((src, dst))
        if key in seen:
            continue
        seen.add(key)
        pairs.append((src, dst, cost))
    for src, dst, cost in pairs[: max(int(top_k), 1)]:
        pair_fam.labels(src=src, dst=dst).set(cost)

    ing_fam = registry.gauge(
        "comm_cost_node_ingress",
        "per-node ingress share of communication cost (sums to the scalar)",
        labelnames=("node",),
    )
    eg_fam = registry.gauge(
        "comm_cost_node_egress",
        "per-node egress share of communication cost (sums to the scalar)",
        labelnames=("node",),
    )
    for node, v in (attr.get("ingress") or {}).items():
        ing_fam.labels(node=node).set(v)
    for node, v in (attr.get("egress") or {}).items():
        eg_fam.labels(node=node).set(v)

    edge_fam = registry.gauge(
        "comm_cost_edge_topk",
        "cost of the rank-th service edge (rank-labeled: fixed cardinality)",
        labelnames=("rank",),
    )
    # zero first: a later run with a SMALLER top_k must not leave the
    # higher ranks exposing a previous run's costs forever
    _zero_family(edge_fam)
    edges = attr.get("edges") or ()
    for rank in range(max(int(top_k), 1)):
        cost = edges[rank]["cost"] if rank < len(edges) else 0.0
        edge_fam.labels(rank=str(rank)).set(cost)


# ---------------- placement timeline / move provenance ----------------


class PlacementTimeline:
    """Service→node residency over rounds, with per-move cost provenance.

    Maintains a host-side occupancy model (replica counts per
    service×node, collapsed once from the initial snapshot at
    :meth:`bind`) and applies each LANDED move to it: a service-unit move
    re-homes every replica to the landed node — exactly what the backends
    do. Each move's **per-edge cost delta** is the change of
    ``adj[s,j]·cross_pairs(s,j)`` over the move's peers at the move's
    sequential working state, so the deltas telescope: their sum IS the
    round's objective delta under the model (the re-derivable invariant
    :func:`attribution_consistent` checks). Pod-level rounds record
    residency-free moves with ``cost_delta: null`` — a single replica's
    hop has no service-collapsed delta.

    The model is provenance, not ground truth: under chaos a snapshot can
    drift from it (a killed node's pods re-homed outside any move). The
    per-round ``model_total`` is recorded so drift is visible; internal
    consistency holds regardless.
    """

    def __init__(self) -> None:
        self._occ: np.ndarray | None = None
        self._tot: np.ndarray | None = None
        self._adj: np.ndarray | None = None
        self._adj_nz: tuple[np.ndarray, np.ndarray] | None = None
        self._svc_names: tuple[str, ...] = ()
        self._node_names: tuple[str, ...] = ()
        self.residency: dict[str, list[tuple[int, str]]] = {}

    def bind(self, state, graph) -> None:
        """Collapse the initial snapshot host-side (once per run; a host
        read of the snapshot's pod arrays and of the S×S adjacency)."""
        num_s = graph.num_services
        n = state.num_nodes
        svc = _host(state.pod_service)
        node = _host(state.pod_node)
        valid = _host(state.pod_valid)
        occ = np.zeros((num_s, n))
        sel = valid & (svc >= 0) & (svc < num_s) & (node >= 0) & (node < n)
        np.add.at(occ, (svc[sel], node[sel]), 1.0)
        sv = _host(graph.service_valid)
        adj = _host(graph.adj) * sv[:, None] * sv[None, :]
        self._occ = occ
        # replicas a service: a move re-homes them all, so the row sums
        # never change (integer counts, exact)
        self._tot = occ.sum(axis=1)
        self._adj = adj
        self._adj_nz = np.nonzero(adj)
        self._svc_names = tuple(graph.names)
        self._node_names = tuple(state.node_names)
        for s in range(min(num_s, len(self._svc_names))):
            if occ[s].sum() > 0:
                home = int(np.argmax(occ[s]))
                self.residency[self._svc_names[s]] = [
                    (0, _name(self._node_names, home, "node"))
                ]

    @property
    def bound(self) -> bool:
        return self._occ is not None

    def _model_total(self) -> float:
        """``0.5 · Σ adj ⊙ cross`` over the working state. The cross-pair
        counts are formed only at the adjacency's nonzeros and summed in an
        S × S array that is 0.0 elsewhere — the JAX package's ``adj *
        cross`` entry for entry (``0 · count`` there), so the same
        ``np.sum`` gives its value bit for bit without its S × N × S f64
        product."""
        occ, (ii, jj) = self._occ, self._adj_nz
        cross = self._tot[ii] * self._tot[jj] - np.einsum("ij,ij->i", occ[ii], occ[jj])
        prod = np.zeros(self._adj.shape, dtype=np.result_type(self._adj, occ))
        prod[ii, jj] = self._adj[ii, jj] * cross
        return float(0.5 * np.sum(prod))

    def _move_delta(self, s: int, t: int) -> tuple[float, list[dict]]:
        """Per-edge deltas of re-homing every replica of service ``s`` to
        node ``t`` at the CURRENT working state (then applied to it).

        Only the peers of ``s`` (the nonzeros of its adjacency row) are
        computed: everywhere else the JAX package's dense form gives
        ``0 · (a non-negative count) = 0.0``, so the delta vector — and its
        sum — are the JAX package's bit for bit (the counts' products are
        exact integers in f64), at the cost of one row instead of a pass
        over the whole S × N occupancy a move."""
        occ, adj, tot = self._occ, self._adj, self._tot
        w = adj[s]
        peers = np.flatnonzero(w)
        rows = occ[peers]
        deltas = np.zeros(occ.shape[0], dtype=np.result_type(w, occ))
        before = w[peers] * (tot[s] * tot[peers] - rows @ occ[s])
        after = w[peers] * (tot[s] * tot[peers] - rows[:, t] * tot[s])
        deltas[peers] = after - before
        deltas[s] = 0.0
        occ[s] = 0.0
        occ[s, t] = tot[s]
        edges = [
            {"peer": _name(self._svc_names, int(j), "svc"), "delta": float(deltas[j])}
            for j in np.flatnonzero(np.abs(deltas) > 0)
        ]
        return float(deltas.sum()), edges

    def observe_round(
        self,
        rnd: int,
        applied_moves: Iterable[tuple[str, str]],
        *,
        pod_level: bool = False,
    ) -> dict[str, Any]:
        """Fold one round's landed moves into the model; returns the
        provenance block the controller merges into the round's
        attribution record."""
        moves_out: list[dict[str, Any]] = []
        obj_delta = 0.0  # sum over moves with a computable delta
        for service, landed in applied_moves:
            s = (
                self._svc_names.index(service)
                if service in self._svc_names
                else -1
            )
            t = (
                self._node_names.index(landed)
                if landed in self._node_names
                else -1
            )
            prev = self.residency.get(service)
            entry: dict[str, Any] = {
                "service": service,
                "from": prev[-1][1] if prev else None,
                "to": landed,
                "cost_delta": None,
                "edges": [],
            }
            if not pod_level and s >= 0 and t >= 0 and self.bound:
                delta, edges = self._move_delta(s, t)
                entry["cost_delta"] = delta
                entry["edges"] = edges
                obj_delta += delta
            self.residency.setdefault(service, []).append((rnd, landed))
            moves_out.append(entry)
        return {
            "moves": moves_out,
            "objective_delta": None if pod_level else obj_delta,
            "model_total": self._model_total() if self.bound else None,
            "pod_level": bool(pod_level),
        }

    def render_residency(self) -> list[str]:
        return render_residency(self.residency)


def residency_from_rounds(
    records: Iterable[dict[str, Any]],
) -> dict[str, list[tuple[int | str, str]]]:
    """Rebuild the service→node residency map from a recorded round
    stream (the ``moves`` provenance in each round's attribution) — the
    post-hoc twin of :attr:`PlacementTimeline.residency`, so
    ``telemetry topo`` can render residency from rounds.jsonl alone."""
    residency: dict[str, list[tuple[int | str, str]]] = {}
    for attr, _cost in iter_attributions(records):
        rnd = attr.get("round", "?")
        for mv in attr.get("moves") or ():
            hops = residency.setdefault(mv["service"], [])
            if not hops and mv.get("from") is not None:
                hops.append((0, mv["from"]))
            hops.append((rnd, mv["to"]))
    return residency


def render_residency(
    residency: dict[str, list[tuple[int | str, str]]],
) -> list[str]:
    """Human-readable pod→node residency over rounds."""
    if not residency:
        return ["  no residency recorded"]
    lines = []
    for service in sorted(residency):
        hops = residency[service]
        path = " -> ".join(
            f"{node}@r{rnd}" if rnd else node for rnd, node in hops
        )
        lines.append(f"  {service}: {path}")
    return lines


# ---------------- process-global book (manifests/bundles) ----------------


class AttributionBook:
    """Latest attribution summary per algorithm — the manifest/bundle
    rider, so a diagnostics artifact carries *where the cost sits* even
    if nobody scraped /metrics before the process died."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._latest: dict[str, dict[str, Any]] = {}

    def update(self, algorithm: str, rnd: int, attr: dict[str, Any]) -> None:
        edges = attr.get("edges") or ()
        with self._lock:
            self._latest[algorithm] = {
                "round": rnd,
                "total": attr.get("total"),
                "tail": attr.get("tail"),
                "top_edge": dict(edges[0]) if edges else None,
                "edges_recorded": len(edges),
                "moves_tracked": len(attr.get("moves") or ()),
            }

    def as_dict(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._latest.items()}

    def clear(self) -> None:
        with self._lock:
            self._latest.clear()


_book = AttributionBook()


def get_attribution_book() -> AttributionBook:
    return _book


# ---------------- rendering (telemetry topo) ----------------


def render_edges(attr: dict[str, Any]) -> list[str]:
    edges = attr.get("edges") or ()
    if not edges:
        return ["  no edge attribution recorded"]
    total = attr.get("total") or 0.0
    lines = [
        "  edge attribution (top-k by cost):",
        "    src_service -> dst_service        src_node -> dst_node      cost    share",
    ]
    for e in edges:
        share = e["cost"] / total if total else 0.0
        lines.append(
            f"    {e['src_service']} -> {e['dst_service']}".ljust(38)
            + f"{e.get('src_node')} -> {e.get('dst_node')}".ljust(26)
            + f"{e['cost']:<8.4g}{share:6.1%}"
        )
    tail = attr.get("tail")
    if tail:
        lines.append(f"    (+ tail outside top-k: {tail:.4g})")
    return lines


def render_heatmap(attr: dict[str, Any]) -> list[str]:
    """The node-pair cost matrix as a text heatmap."""
    pairs = attr.get("node_pairs") or ()
    nodes = sorted({p[0] for p in pairs} | {p[1] for p in pairs})
    if not nodes:
        return ["  no cross-node cost (everything co-located)"]
    idx = {n: i for i, n in enumerate(nodes)}
    m = np.zeros((len(nodes), len(nodes)))
    for src, dst, cost in pairs:
        m[idx[src], idx[dst]] = cost
    peak = m.max() or 1.0
    shades = " .:-=+*#%@"
    width = max(len(n) for n in nodes)
    col = max(6, min(10, width))
    lines = ["  node-pair heatmap (row=src, col=dst):"]
    header = " " * (width + 4) + " ".join(n[:col].rjust(col) for n in nodes)
    lines.append("  " + header.rstrip())
    for i, n in enumerate(nodes):
        cells = []
        for j in range(len(nodes)):
            v = m[i, j]
            shade = shades[min(int(v / peak * (len(shades) - 1)), len(shades) - 1)]
            cells.append(
                f"{shade}{v:{col - 1}.0f}" if v else f"{'·':>{col}}"
            )
        lines.append(f"    {n.rjust(width)}  " + " ".join(cells))
    return lines


def render_provenance(rounds: Iterable[dict[str, Any]]) -> list[str]:
    """Move provenance over a round stream: each applied move with its
    cost delta, plus the per-round objective delta."""
    lines: list[str] = []
    for attr, _cost in iter_attributions(rounds):
        moves = attr.get("moves") or ()
        if not moves:
            continue
        rnd = attr.get("round", "?")
        od = attr.get("objective_delta")
        head = f"  r{rnd}: {len(moves)} move(s)"
        if od is not None:
            head += f", objective delta {od:+.4g}"
        lines.append(head)
        for mv in moves:
            d = mv.get("cost_delta")
            lines.append(
                f"    {mv['service']}: {mv.get('from')} -> {mv.get('to')}"
                + (f"  Δcost {d:+.4g}" if d is not None else "  (pod-level)")
            )
    return lines or ["  no moves recorded"]
