"""Shape buckets — the port of ``kubernetes_rescheduling_tpu.elastic.buckets``.

Every kernel and body of the port is mask-native: states and graphs carry
``pod_valid`` / ``node_valid`` / ``service_valid``, and padded slots never
move or cost anything. What churn threatens is the capture cache
(``solver/compiled.py``), which keys a captured graph by its inputs'
shapes. Live S×N×P counts are therefore padded up to power-of-two buckets
(:func:`bucket_capacity`, :class:`ShapeBuckets`), so churn within a bucket
keeps every shape, and only a bucket **promotion** changes them — counted
(``bucket_promotions_total``): a steady churned run captures once per
solve shape plus once per promotion.

:func:`device_view` / :func:`device_graph` strip the name tuples, the host
bookkeeping no tensor code reads (in the JAX package they are static jit
metadata; here they are never part of a capture key, and the views keep
the two packages' call sites alike).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph


def bucket_capacity(n: int, *, floor: int = 8) -> int:
    """The next power of two at or above ``n``, never below ``floor``."""
    if n < 0:
        raise ValueError(f"live count must be >= 0, got {n}")
    cap = max(int(floor), 1)
    while cap < n:
        cap *= 2
    return cap


@dataclass
class ShapeBuckets:
    """Current capacity bucket per axis, with promotion accounting.

    ``fit`` grows whichever axes the live counts have outgrown and reports
    whether anything grew. Buckets never shrink."""

    floor: int = 8
    services: int = 0
    nodes: int = 0
    pods: int = 0
    # promoting fit() calls (one fit that grows two axes is one new shape set)
    promotions: int = 0
    history: list[dict] = field(default_factory=list)

    def fit(self, *, services: int, nodes: int, pods: int) -> bool:
        """Grow buckets to cover the live counts; True iff promoted."""
        new = {
            "services": max(self.services, bucket_capacity(services, floor=self.floor)),
            "nodes": max(self.nodes, bucket_capacity(nodes, floor=self.floor)),
            "pods": max(self.pods, bucket_capacity(pods, floor=self.floor)),
        }
        promoted = (new["services"] > self.services or new["nodes"] > self.nodes
                    or new["pods"] > self.pods)
        first = self.services == 0 and self.nodes == 0 and self.pods == 0
        self.services, self.nodes, self.pods = new["services"], new["nodes"], new["pods"]
        if first:
            return False  # the initial sizing is a capture, not a promotion
        if promoted:
            self.promotions += 1
            self.history.append(dict(new))
        return promoted

    def as_dict(self) -> dict:
        return {"services": self.services, "nodes": self.nodes, "pods": self.pods,
                "promotions": self.promotions}


def device_view(state: ClusterState) -> ClusterState:
    """The same tensors with the name tuples stripped."""
    if not state.node_names and not state.pod_names:
        return state
    return state.replace(node_names=(), pod_names=())


def device_graph(graph: CommGraph) -> CommGraph:
    """The same adjacency with the service-name tuple stripped."""
    if not graph.names:
        return graph
    return replace(graph, names=())
