"""Array-world cluster state as dataclasses of tensors — the port of
``kubernetes_rescheduling_tpu.core.state``.

Same fields, padding and validity-mask semantics as the JAX package: every
array is padded to a fixed capacity (``N`` nodes, ``P`` pods, ``S``
services) with a boolean validity mask, and node usage is derived from the
pod table rather than stored.

Per-node and per-service sums are sorted segment sums (:func:`segment_sum`):
no float atomics, so a sum on the card does not depend on the order in which
threads happen to land, and two runs give the same bits.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device

UNASSIGNED = -1  # pod_node value for a pod not placed on any node


def segment_sum(values: torch.Tensor, index: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[s] = Σ values[i] for index[i] == s`` over ``s < num_segments``;
    entries whose index is outside ``[0, num_segments)`` are dropped.

    A stable sort groups each segment's entries in their original order and
    ``segment_reduce`` adds them without atomics, so the result is the same
    from run to run on the card (and equal to a sequential scatter-add in
    index order on the CPU)."""
    idx = index.long()
    idx = torch.where((idx >= 0) & (idx < num_segments), idx, num_segments)
    order = torch.argsort(idx, stable=True)
    lengths = _count(idx, num_segments + 1)
    # lengths sum to len(values) by construction: ``unsafe`` skips the check
    # that would read that sum back to the host
    out = torch.segment_reduce(values[order], "sum", lengths=lengths, initial=0.0, unsafe=True)
    return out[:num_segments]


def on_device(have: torch.device, device: str | torch.device) -> bool:
    """Whether tensors on ``have`` already sit on ``device``; ``"cuda"``
    without an index names the current card. ``to`` returns the object
    itself then, so identity-keyed logic (the intent ledger's re-served
    snapshot, the admission guard's handover) holds on the card as on the
    CPU."""
    want = torch.device(device)
    if want.type != have.type:
        return False
    if want.index is None:
        return have.type != "cuda" or have.index == torch.cuda.current_device()
    return want.index == have.index


def _count(index: torch.Tensor, size: int) -> torch.Tensor:
    """i64[size] occurrences of each value of ``index`` (all in
    ``[0, size)``): an integer scatter-add, exact in any order and — unlike
    ``torch.bincount``, which reads the largest index back to size its
    output — free of host synchronization on the card."""
    out = torch.zeros((size,), dtype=torch.int64, device=index.device)
    return out.scatter_add_(0, index, torch.ones_like(index))


@dataclass(frozen=True)
class CommGraph:
    """Service↔service communication graph.

    Attributes:
      adj: f32[S, S] symmetric weights; adj[i, j] > 0 iff services i and j
        communicate. Diagonal is zero.
      service_valid: bool[S] — padding mask.
      names: tuple of service names, index-aligned with ``adj``.
    """

    adj: torch.Tensor
    service_valid: torch.Tensor
    names: tuple[str, ...] = ()

    @property
    def num_services(self) -> int:
        return int(self.adj.shape[0])

    @property
    def device(self) -> torch.device:
        return self.adj.device

    def to(self, device: str | torch.device) -> "CommGraph":
        """The same graph with its tensors on ``device`` (itself when they
        are there already)."""
        if on_device(self.adj.device, device):
            return self
        return dataclasses.replace(
            self, adj=self.adj.to(device), service_valid=self.service_valid.to(device)
        )

    def service_index(self, name: str) -> int:
        return self.names.index(name)

    @classmethod
    def from_relation(
        cls,
        relation: Mapping[str, Sequence[str]],
        *,
        capacity: int | None = None,
        names: Sequence[str] | None = None,
        device: str | torch.device | None = DEFAULT_DEVICE,
    ) -> "CommGraph":
        """Build from a ``{service: [related services]}`` dict: symmetrized
        (undirected closure) and padded to ``capacity``."""
        dev = resolve_device(device)
        if names is None:
            seen: dict[str, None] = {}
            for k, vs in relation.items():
                seen.setdefault(k)
                for v in vs:
                    seen.setdefault(v)
            names = list(seen)
        n = len(names)
        cap = capacity or n
        if cap < n:
            raise ValueError(f"capacity {cap} < number of services {n}")
        index = {name: i for i, name in enumerate(names)}
        adj = np.zeros((cap, cap), dtype=np.float32)
        for src, dsts in relation.items():
            if src not in index:
                raise ValueError(
                    f"relation source {src!r} not in service names {names[:8]}..."
                )
            i = index[src]
            for dst in dsts:
                if dst not in index:
                    # callee with no service of its own (external endpoint):
                    # not placeable, so it cannot contribute to placement cost
                    continue
                j = index[dst]
                if i != j:
                    adj[i, j] = 1.0
                    adj[j, i] = 1.0
        valid = np.zeros((cap,), dtype=bool)
        valid[:n] = True
        return cls(
            adj=torch.as_tensor(adj, device=dev),
            service_valid=torch.as_tensor(valid, device=dev),
            names=tuple(names),
        )

    def to_relation(self) -> dict[str, list[str]]:
        """Back to the reference's ``{service: [related services]}`` dict
        (for oracles and live adapters)."""
        adj = self.adj.cpu().numpy()
        valid = self.service_valid.cpu().numpy()
        out: dict[str, list[str]] = {}
        for i, name in enumerate(self.names):
            if not valid[i]:
                continue
            out[name] = [
                self.names[j] for j in range(len(self.names)) if valid[j] and adj[i, j] > 0
            ]
        return out


@dataclass(frozen=True)
class ClusterState:
    """Padded tensor snapshot of a cluster (CPU in millicores, memory in
    bytes), field for field the JAX package's ``ClusterState``.

    Attributes:
      node_cpu_cap, node_mem_cap: f32[N] capacities.
      node_base_cpu, node_base_mem: f32[N] background usage not attributable
        to tracked pods.
      node_valid: bool[N].
      node_lex_rank: i32[N] rank of the node's name in sorted order.
      pod_node: i32[P] node index or UNASSIGNED.
      pod_service: i32[P] service index into a CommGraph.
      pod_cpu, pod_mem: f32[P].
      pod_valid: bool[P].
      node_names / pod_names: name tuples (host-side bookkeeping only).
    """

    node_cpu_cap: torch.Tensor
    node_mem_cap: torch.Tensor
    node_base_cpu: torch.Tensor
    node_base_mem: torch.Tensor
    node_valid: torch.Tensor
    node_lex_rank: torch.Tensor
    pod_node: torch.Tensor
    pod_service: torch.Tensor
    pod_cpu: torch.Tensor
    pod_mem: torch.Tensor
    pod_valid: torch.Tensor
    node_names: tuple[str, ...] = ()
    pod_names: tuple[str, ...] = ()

    @property
    def num_nodes(self) -> int:
        return int(self.node_cpu_cap.shape[0])

    @property
    def num_pods(self) -> int:
        return int(self.pod_node.shape[0])

    @property
    def device(self) -> torch.device:
        return self.pod_node.device

    def replace(self, **changes) -> "ClusterState":
        return dataclasses.replace(self, **changes)

    def to(self, device: str | torch.device) -> "ClusterState":
        """The same state with its tensors on ``device`` (itself when they
        are there already)."""
        if on_device(self.device, device):
            return self
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })

    # ---- derived quantities ----

    def _pod_slot(self) -> torch.Tensor:
        """Per-pod node slot for the per-node sums: invalid and unplaced
        pods land in the dropped slot ``N``."""
        n = self.num_nodes
        return torch.where(self.pod_valid, self.pod_node, n)

    def pod_on_node(self) -> torch.Tensor:
        """f32[P, N] — one-hot of the assignment, masked by pod validity
        (an unplaced pod's row is zero)."""
        cols = torch.arange(self.num_nodes, device=self.device)
        return ((self.pod_node[:, None] == cols[None, :]) & self.pod_valid[:, None]).float()

    def node_pod_count(self) -> torch.Tensor:
        """f32[N] — number of valid pods per node (the length of the
        reference's per-node pod list, reference rescheduling.py:95)."""
        n = self.num_nodes
        slot = self._pod_slot().long()
        slot = torch.where((slot >= 0) & (slot < n), slot, n)
        return _count(slot, n + 1)[:n].float()

    def node_cpu_used(self) -> torch.Tensor:
        """f32[N] millicores — base + sum of tracked pod CPU."""
        used = segment_sum(
            torch.where(self.pod_valid, self.pod_cpu, 0.0), self._pod_slot(), self.num_nodes
        )
        return self.node_base_cpu + used

    def node_mem_used(self) -> torch.Tensor:
        used = segment_sum(
            torch.where(self.pod_valid, self.pod_mem, 0.0), self._pod_slot(), self.num_nodes
        )
        return self.node_base_mem + used

    def node_cpu_pct(self) -> torch.Tensor:
        """f32[N] — CPU usage percent, 0 for invalid/zero-cap nodes."""
        cap = torch.where(self.node_cpu_cap > 0, self.node_cpu_cap, 1.0)
        pct = self.node_cpu_used() / cap * 100.0
        return torch.where(self.node_valid & (self.node_cpu_cap > 0), pct, 0.0)

    def node_mem_pct(self) -> torch.Tensor:
        cap = torch.where(self.node_mem_cap > 0, self.node_mem_cap, 1.0)
        pct = self.node_mem_used() / cap * 100.0
        return torch.where(self.node_valid & (self.node_mem_cap > 0), pct, 0.0)

    def node_cpu_free(self) -> torch.Tensor:
        """f32[N] millicores remaining — the CAR tie-break quantity
        (reference rescheduling.py:206-208)."""
        return self.node_cpu_cap - self.node_cpu_used()

    def service_node_counts(self, num_services: int) -> torch.Tensor:
        """f32[S, N] — occupancy matrix: pods of service s on node n (an
        integer count, exact in any order)."""
        n = self.num_nodes
        svc = torch.where(self.pod_valid, self.pod_service, num_services).long()
        svc = torch.where((svc >= 0) & (svc < num_services), svc, num_services)
        node = torch.where(self.pod_valid, self.pod_node, n).long()
        node = torch.where((node >= 0) & (node < n), node, n)
        flat = svc * (n + 1) + node
        occ = _count(flat, (num_services + 1) * (n + 1))
        return occ.view(num_services + 1, n + 1)[:num_services, :n].float()

    # ---- host-side constructors ----

    @classmethod
    def build(
        cls,
        *,
        node_names: Sequence[str],
        node_cpu_cap: Sequence[float],
        node_mem_cap: Sequence[float],
        pod_services: Sequence[int],
        pod_nodes: Sequence[int],
        pod_cpu: Sequence[float],
        pod_mem: Sequence[float],
        pod_names: Sequence[str] | None = None,
        node_base_cpu: Sequence[float] | None = None,
        node_base_mem: Sequence[float] | None = None,
        node_alive: Sequence[bool] | None = None,
        node_capacity: int | None = None,
        pod_capacity: int | None = None,
        device: str | torch.device | None = DEFAULT_DEVICE,
    ) -> "ClusterState":
        """Build a padded state from host lists."""
        dev = resolve_device(device)
        n_real = len(node_names)
        p_real = len(pod_services)
        n_cap = node_capacity or n_real
        p_cap = pod_capacity or p_real
        if n_cap < n_real or p_cap < p_real:
            raise ValueError("capacity smaller than real counts")

        def pad(x, cap, fill=0.0, dtype=np.float32):
            a = np.full((cap,), fill, dtype=dtype)
            a[: len(x)] = np.asarray(x, dtype=dtype)
            return torch.as_tensor(a, device=dev)

        order = np.argsort(np.asarray(node_names, dtype=object))
        lex_rank = np.zeros((n_cap,), dtype=np.int32)
        lex_rank[order] = np.arange(n_real, dtype=np.int32)

        node_valid = np.zeros((n_cap,), dtype=bool)
        # a known-but-dead node (failed/cordoned) is not a placement candidate
        node_valid[:n_real] = (
            np.asarray(node_alive, dtype=bool) if node_alive is not None else True
        )
        pod_valid = np.zeros((p_cap,), dtype=bool)
        pod_valid[:p_real] = True

        return cls(
            node_cpu_cap=pad(node_cpu_cap, n_cap),
            node_mem_cap=pad(node_mem_cap, n_cap),
            node_base_cpu=pad(
                node_base_cpu if node_base_cpu is not None else [0.0] * n_real, n_cap
            ),
            node_base_mem=pad(
                node_base_mem if node_base_mem is not None else [0.0] * n_real, n_cap
            ),
            node_valid=torch.as_tensor(node_valid, device=dev),
            node_lex_rank=torch.as_tensor(lex_rank, device=dev),
            pod_node=pad(pod_nodes, p_cap, fill=UNASSIGNED, dtype=np.int32),
            pod_service=pad(pod_services, p_cap, fill=0, dtype=np.int32),
            pod_cpu=pad(pod_cpu, p_cap),
            pod_mem=pad(pod_mem, p_cap),
            pod_valid=torch.as_tensor(pod_valid, device=dev),
            node_names=tuple(node_names),
            pod_names=(
                tuple(pod_names)
                if pod_names is not None
                else tuple(f"pod{i}" for i in range(p_real))
            ),
        )
