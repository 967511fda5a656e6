"""Backend protocol: the host-side boundary of the control loop — the port
of ``kubernetes_rescheduling_tpu.backends.base``, plus the policy → pinning
mechanism table the JAX package keeps in ``backends/k8s.py``.

The protocol mirrors the reference's control-loop surface: snapshot
(podmonitor.py:7-125), deployment teardown (delete_replaced_pod.py:144-185)
and pinned re-creation (rescheduling.py:57-73).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol

import torch

from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph


@dataclass(frozen=True)
class MoveRequest:
    """Move one service's Deployment — or, with ``pod`` set, a single
    replica — to a target node."""

    service: str
    target_node: str
    hazard_nodes: tuple[str, ...] = ()
    mechanism: str = "nodeName"  # nodeName | nodeSelector | affinityOnly
    pod: str | None = None  # move only this named replica


class Backend(Protocol):
    """What a cluster must provide to the controller."""

    def monitor(self) -> ClusterState:
        """Fresh padded snapshot of the cluster."""
        ...

    def comm_graph(self) -> CommGraph:
        """The service communication graph."""
        ...

    def apply_move(self, move: MoveRequest) -> str | None:
        """Tear down the service's Deployment and re-create it pinned or
        steered to the target node. Returns the node it landed on (under
        ``affinityOnly`` the scheduler chooses), or None if the move failed
        (the round is then a skip, reference main.py:103-107)."""
        ...

    def advance(self, seconds: float) -> None:
        """Let time pass (pacing between rounds, reference main.py:27,100)."""
        ...


# policy name -> how the reference pins the re-created Deployment
PlacementMechanism: dict[str, str] = {
    "spread": "nodeSelector",
    "binpack": "nodeSelector",
    "random": "nodeName",
    "communication": "nodeName",
    "kubescheduling": "affinityOnly",
    "global": "nodeName",
}


def device_kind(n_devices: int | None = None) -> str:
    """The accelerator identity a measured record is keyed by:
    ``"<name>x<count>"`` with the CUDA device's name (for example
    ``"NVIDIA H100 80GB HBM3x1"``), or ``"cpux1"`` without a card — so a
    card's records never share a series with another device's."""
    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0)
        n = torch.cuda.device_count()
    else:
        kind, n = "cpu", 1
    return f"{kind}x{int(n_devices) if n_devices is not None else n}"
