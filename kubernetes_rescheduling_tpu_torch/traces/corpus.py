"""The ``ClusterTrace`` JSONL schema, its loader and its snapshot windows —
the port of ``kubernetes_rescheduling_tpu.traces.corpus``.

One record per line, four kinds, grouped into **windows** by timestamp
(records sharing a ``t`` form one snapshot window; timestamps must be
monotone non-decreasing):

``{"kind": "node", "t": 0.0, "node": "m1", "cpu_cap_m": 4000.0,
"mem_cap_b": 8.0e9, "cpu_used_m": 900.0, "mem_used_b": 1.0e9,
"alive": true}``
    Node capacity and measured usage. Node records CARRY FORWARD: a node
    described once keeps its latest capacity and alive status in every
    later window until a new record updates it (real traces emit machine
    events sparsely). ``cpu_used_m`` / ``mem_used_b`` are the node's total
    measured usage; the window's base (untracked) load is
    ``max(used − Σ tracked pod usage, 0)``, the k8s adapter's rule.

``{"kind": "pod", "t": 0.0, "pod": "svc-a-0", "service": "svc-a",
"node": "m1", "cpu_m": 250.0, "mem_b": 2.0e8}``
    One tracked pod in this window. Pods are restated per window (a
    window's pod set IS its snapshot); ``node: null`` means unscheduled.

``{"kind": "edge", "t": 0.0, "a": "svc-a", "b": "svc-b", "w": 1.0}``
    Optional service↔service communication weight (symmetric; the latest
    record per unordered pair wins). A trace with no edge records gets the
    uniform complete graph over its services, so the cost objective
    rewards consolidation rather than reading zero.

``{"kind": "placement", "t": 30.0, "pod": "svc-a-0", "node": "m2"}``
    Informational: a placement the recorded scheduler made between windows
    (the next window's pod records already reflect it).

Malformed rows — broken JSON, unknown kinds, missing identity fields,
non-finite timestamps, pod references to nodes the trace never declares,
out-of-order timestamps (repaired by a stable re-sort) — are quarantined
and counted (``trace_rows_quarantined_total{reason}``), never a crash.
Value-level poison (NaN, Inf, negative or over-capacity readings) is kept
in the built snapshots: the admission guard (``bench/admission.py``)
quarantines it, one discipline for live and replayed data alike.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch.core.state import UNASSIGNED, ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.telemetry.registry import get_registry

KIND_NODE = "node"
KIND_POD = "pod"
KIND_EDGE = "edge"
KIND_PLACEMENT = "placement"
KINDS = (KIND_NODE, KIND_POD, KIND_EDGE, KIND_PLACEMENT)

# identity fields a record cannot be used without (value fields may be
# absent or poisoned: admission handles values, these handle identity)
REQUIRED_FIELDS = {
    KIND_NODE: ("node",),
    KIND_POD: ("pod", "service"),
    KIND_EDGE: ("a", "b"),
    KIND_PLACEMENT: ("pod", "node"),
}

REASON_BAD_JSON = "bad_json"
REASON_NOT_OBJECT = "not_object"
REASON_UNKNOWN_KIND = "unknown_kind"
REASON_MISSING_FIELD = "missing_field"
REASON_BAD_TIMESTAMP = "bad_timestamp"
REASON_UNKNOWN_NODE_REF = "unknown_node_ref"
REASON_OUT_OF_ORDER = "out_of_order"


def count_quarantine(registry, reason: str, n: int = 1) -> None:
    """THE ``trace_rows_quarantined_total`` declaration, shared by the
    corpus, the adapters and the replay backend."""
    if n <= 0:
        return
    reg = registry if registry is not None else get_registry()
    reg.counter(
        "trace_rows_quarantined_total",
        "trace rows dropped or repaired by the corpus layer while "
        "loading a recorded cluster trace (broken JSON, unknown kinds, "
        "missing identity fields, phantom node references) — dirty "
        "real-world data is counted, never a crash",
        labelnames=("reason",),
    ).labels(reason=reason).inc(n)


def parse_records(lines: Iterable[str], *, registry=None, logger=None
                  ) -> tuple[list[dict], dict[str, int]]:
    """JSONL lines → (clean records, quarantine counts by reason).

    Identity-level breakage quarantines the row; value-level poison passes
    through for the admission guard (module docstring)."""
    records: list[dict] = []
    quarantined: dict[str, int] = {}

    def bad(reason: str, line_no: int) -> None:
        quarantined[reason] = quarantined.get(reason, 0) + 1
        count_quarantine(registry, reason)
        if logger is not None:
            logger.warn("trace_row_quarantined", reason=reason, line=line_no)

    for i, line in enumerate(lines, start=1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            bad(REASON_BAD_JSON, i)
            continue
        if not isinstance(rec, dict):
            bad(REASON_NOT_OBJECT, i)
            continue
        kind = rec.get("kind")
        if kind not in KINDS:
            bad(REASON_UNKNOWN_KIND, i)
            continue
        # absent or empty, NOT falsy: integer-id corpora use 0 as a machine
        # or job id; a pod's node may be null (unscheduled), a placement's
        # node is identity
        if any(rec.get(f) is None or rec.get(f) == "" for f in REQUIRED_FIELDS[kind]):
            bad(REASON_MISSING_FIELD, i)
            continue
        try:
            t = float(rec.get("t", 0.0))
        except (TypeError, ValueError):
            bad(REASON_BAD_TIMESTAMP, i)
            continue
        if not math.isfinite(t):
            bad(REASON_BAD_TIMESTAMP, i)
            continue
        rec["t"] = t
        records.append(rec)
    # out-of-order rows are REPAIRED by a stable re-sort, and counted:
    # windows() groups consecutive equal-t runs, so a late row would
    # fragment its window and replay time backwards
    disorder = sum(1 for prev, rec in zip(records, records[1:]) if rec["t"] < prev["t"])
    if disorder:
        quarantined[REASON_OUT_OF_ORDER] = disorder
        count_quarantine(registry, REASON_OUT_OF_ORDER, disorder)
        if logger is not None:
            logger.warn("trace_rows_reordered", rows=disorder)
        records.sort(key=lambda r: r["t"])  # stable: intra-t order kept
    return records, quarantined


@dataclass
class TraceWindow:
    """One snapshot window: the records sharing a timestamp, with node
    state carried forward from every earlier window."""

    t: float
    # node name -> latest node record (carry-forward view at this t)
    nodes: dict[str, dict]
    # this window's pod records, in file order (restated per window)
    pods: list[dict]
    # placement events recorded at this t (informational)
    placements: list[dict] = field(default_factory=list)


@dataclass
class ClusterTrace:
    """A parsed trace: ordered records plus derived, trace-wide tables.

    The derived tables are fixed across the whole trace — node order (first
    appearance), the service set (first appearance in pod and edge
    records) and the largest window's pod count — so every window builds a
    ``ClusterState`` of ONE shape and the solve captures once for the whole
    replay."""

    records: list[dict]
    quarantined: dict[str, int] = field(default_factory=dict)
    source: str = "?"

    def __post_init__(self) -> None:
        self._windows: list[TraceWindow] | None = None
        self._graphs: dict[torch.device, CommGraph] = {}
        node_names: dict = {}
        service_names: dict = {}
        for rec in self.records:
            kind = rec["kind"]
            if kind == KIND_NODE:
                node_names.setdefault(rec["node"])
            elif kind == KIND_POD:
                service_names.setdefault(rec["service"])
            elif kind == KIND_EDGE:
                service_names.setdefault(rec["a"])
                service_names.setdefault(rec["b"])
        self.node_names: tuple = tuple(node_names)
        self.service_names: tuple = tuple(service_names)

    def windows(self) -> list[TraceWindow]:
        """Snapshot windows in timestamp order (consecutive runs of one
        ``t``), node state carried forward between them."""
        if self._windows is not None:
            return self._windows
        windows: list[TraceWindow] = []
        node_state: dict[str, dict] = {}
        cur: TraceWindow | None = None
        for rec in self.records:
            t = rec["t"]
            if cur is None or t != cur.t:
                if cur is not None:
                    cur.nodes = dict(node_state)
                cur = TraceWindow(t=t, nodes={}, pods=[])
                windows.append(cur)
            kind = rec["kind"]
            if kind == KIND_NODE:
                node_state[rec["node"]] = {**node_state.get(rec["node"], {}), **rec}
            elif kind == KIND_POD:
                cur.pods.append(rec)
            elif kind == KIND_PLACEMENT:
                cur.placements.append(rec)
        if cur is not None:
            # windows see the carry-forward node view as of their close
            cur.nodes = dict(node_state)
        self._windows = windows
        return windows

    @property
    def max_window_pods(self) -> int:
        return max((len(w.pods) for w in self.windows()), default=0)

    def comm_graph(self, device: str | torch.device | None = DEFAULT_DEVICE) -> CommGraph:
        """The trace's service communication graph on ``device``: the edge
        records (the latest per unordered pair wins), or with none the
        uniform complete graph over the trace's services (weight 1.0, honest
        about carrying no recorded call graph). ONE object per device for
        the trace's lifetime, so every window's solve keys the same capture
        (the cache keys on operand identity)."""
        dev = resolve_device(device)
        graph = self._graphs.get(dev)
        if graph is None:
            s = len(self.service_names)
            index = {n: i for i, n in enumerate(self.service_names)}
            adj = np.zeros((s, s), dtype=np.float32)
            declared = False
            for rec in self.records:
                if rec["kind"] != KIND_EDGE:
                    continue
                declared = True
                i, j = index[rec["a"]], index[rec["b"]]
                if i != j:
                    w = float(rec.get("w", 1.0))
                    adj[i, j] = w
                    adj[j, i] = w
            if not declared and s > 1:
                adj[:] = 1.0
                np.fill_diagonal(adj, 0.0)
            graph = CommGraph(
                adj=torch.as_tensor(adj, device=dev),
                service_valid=torch.ones((adj.shape[0],), dtype=torch.bool, device=dev),
                names=self.service_names,
            )
            self._graphs[dev] = graph
        return graph


def window_state(trace: ClusterTrace, index: int, *, pod_capacity: int | None = None,
                 registry=None, count_refs: bool = True,
                 device: str | torch.device | None = DEFAULT_DEVICE) -> ClusterState:
    """The ``ClusterState`` snapshot of one window on ``device``.

    Node order, capacities and padding are trace-wide (static shapes, see
    :class:`ClusterTrace`); a pod referencing a node the trace never
    declares is placed ``UNASSIGNED`` and counted
    (``trace_rows_quarantined_total{reason="unknown_node_ref"}``).
    ``count_refs=False`` suppresses that count for a caller that rebuilds
    windows repeatedly and counts once up front (the replay backend: the
    metric counts rows at load, so a re-served tail window must not
    re-inflate it). Value-level poison passes through untouched for the
    admission guard."""
    w = trace.windows()[index]
    node_names = trace.node_names
    node_index = {n: i for i, n in enumerate(node_names)}
    svc_index = {n: i for i, n in enumerate(trace.service_names)}

    cap_cpu, cap_mem, used_cpu, used_mem, alive = [], [], [], [], []
    for name in node_names:
        rec = w.nodes.get(name)
        if rec is None:
            # declared later in the trace: not part of this window's pool
            cap_cpu.append(0.0)
            cap_mem.append(0.0)
            used_cpu.append(0.0)
            used_mem.append(0.0)
            alive.append(False)
            continue
        cap_cpu.append(float(rec.get("cpu_cap_m", 0.0)))
        cap_mem.append(float(rec.get("mem_cap_b", 0.0)))
        used_cpu.append(float(rec.get("cpu_used_m", 0.0)))
        used_mem.append(float(rec.get("mem_used_b", 0.0)))
        alive.append(bool(rec.get("alive", True)))

    services, pod_nodes, pod_cpu, pod_mem, pod_names = [], [], [], [], []
    tracked_cpu = [0.0] * len(node_names)
    tracked_mem = [0.0] * len(node_names)
    unknown_refs = 0
    for rec in w.pods:
        node = rec.get("node")
        ni = node_index.get(node) if node is not None else None
        if node is not None and ni is None:
            unknown_refs += 1
        cpu = float(rec.get("cpu_m", 0.0))
        mem = float(rec.get("mem_b", 0.0))
        services.append(svc_index[rec["service"]])
        pod_nodes.append(ni if ni is not None else UNASSIGNED)
        pod_cpu.append(cpu)
        pod_mem.append(mem)
        pod_names.append(rec["pod"])
        if ni is not None:
            # independent finite guards: a NaN cpu reading must not
            # suppress the pod's FINITE mem contribution (the base load
            # would inflate by a plausible wrong amount the admission
            # guard cannot catch), and vice versa
            if math.isfinite(cpu):
                tracked_cpu[ni] += cpu
            if math.isfinite(mem):
                tracked_mem[ni] += mem
    if unknown_refs and count_refs:
        count_quarantine(registry, REASON_UNKNOWN_NODE_REF, unknown_refs)

    # base load = measured node usage minus tracked pod usage (the k8s
    # adapter's derivation: system daemons and untracked tenants)
    base_cpu = [max(u - t, 0.0) for u, t in zip(used_cpu, tracked_cpu)]
    base_mem = [max(u - t, 0.0) for u, t in zip(used_mem, tracked_mem)]

    return ClusterState.build(
        node_names=node_names,
        node_cpu_cap=cap_cpu,
        node_mem_cap=cap_mem,
        node_alive=alive,
        node_base_cpu=base_cpu,
        node_base_mem=base_mem,
        pod_services=services,
        pod_nodes=pod_nodes,
        pod_cpu=pod_cpu,
        pod_mem=pod_mem,
        pod_names=pod_names,
        pod_capacity=pod_capacity or trace.max_window_pods,
        device=device,
    )


def load_trace_jsonl(path: str | Path, *, registry=None, logger=None) -> ClusterTrace:
    """Load a native-format trace file (see the module docstring)."""
    p = Path(path)
    records, quarantined = parse_records(p.read_text().splitlines(), registry=registry,
                                         logger=logger)
    return ClusterTrace(records=records, quarantined=quarantined, source=str(p))


def dump_trace_jsonl(trace: ClusterTrace, path: str | Path) -> Path:
    """Write a trace in the native JSONL form (the adapters' round-trip
    target: ``load(dump(x)).records == x.records``)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("w") as f:
        for rec in trace.records:
            f.write(json.dumps(rec, default=float) + "\n")
    return p
