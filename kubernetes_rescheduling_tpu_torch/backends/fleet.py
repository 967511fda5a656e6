"""Fleet backend — the port of ``kubernetes_rescheduling_tpu.backends.fleet``:
N per-tenant cluster backends behind one handle.

Fleet mode multiplexes ONE device plane over MANY clusters; on the host
each tenant keeps its own backend (its own pod table, clock, events).
:class:`FleetBackend` is deliberately not a ``Backend``: the multiplexed
loop (``bench/fleet.py``) talks to every tenant through that tenant's own
boundary (retry and breaker per tenant), so an aggregate ``monitor()``
would couple the tenants' failure domains. The aggregate owns
construction, naming and fleet-wide conveniences (imbalance injection,
event collection).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE
from kubernetes_rescheduling_tpu_torch.backends.base import Backend


@dataclass
class FleetBackend:
    """N tenant backends, index-aligned with ``tenant_names``."""

    backends: list[Backend]
    tenant_names: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.backends:
            raise ValueError("a fleet needs at least one tenant backend")
        if not self.tenant_names:
            self.tenant_names = [f"tenant{i}" for i in range(len(self.backends))]
        self.tenant_names = list(self.tenant_names)
        if len(self.tenant_names) != len(self.backends):
            raise ValueError(
                f"{len(self.tenant_names)} tenant names for {len(self.backends)} backends"
            )
        if len(set(self.tenant_names)) != len(self.tenant_names):
            raise ValueError("tenant names must be unique")

    @property
    def num_tenants(self) -> int:
        return len(self.backends)

    def __iter__(self):
        return iter(zip(self.tenant_names, self.backends))

    def inject_imbalance(self) -> None:
        """The cordon trick, per tenant, each onto its own first node."""
        for b in self.backends:
            inject = getattr(b, "inject_imbalance", None)
            if inject is not None:
                inject(b.node_names[0])

    def events(self) -> dict[str, list[dict]]:
        """Per-tenant backend event logs (simulator backends only)."""
        return {name: list(getattr(b, "events", ())) for name, b in self}


def make_fleet(scenario: str, tenants: int, *, seed: int = 0,
               workmodel_path: str | None = None,
               device: str | torch.device | None = DEFAULT_DEVICE) -> FleetBackend:
    """An N-tenant fleet of simulators of one scenario: tenant ``t`` is
    ``make_backend(scenario, seed*1000 + t)``, so the tenants share array
    shapes while their topologies, placements and load noise differ."""
    from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend

    if tenants < 1:
        raise ValueError(f"tenants must be >= 1, got {tenants}")
    return FleetBackend(backends=[
        make_backend(scenario, seed * 1000 + t, device=device, workmodel_path=workmodel_path)
        for t in range(tenants)
    ])
