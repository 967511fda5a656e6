"""Host-side reference twins the tests hold the device code to — the port
of ``kubernetes_rescheduling_tpu.oracle``:

- :mod:`oracle.reference_oracle` — the reference's decision semantics in a
  dict world (hazard detection, victim, the five placement policies, the
  communication cost and the node std);
- :mod:`oracle.optimum` — the true optimum of small instances, by brute
  force and by a MILP on scipy's HiGHS;
- :mod:`oracle.forecast` — the forecaster's numpy twin.

Plain numpy (and scipy for the MILP); each reads the tensor state back to
the host. The package exports the JAX package's 11 names and the
forecast twin; the optimum oracles are imported from their module.
"""

from kubernetes_rescheduling_tpu_torch.oracle import forecast
from kubernetes_rescheduling_tpu_torch.oracle.reference_oracle import (
    Snapshot,
    choose_binpack,
    choose_communication,
    choose_kubescheduling,
    choose_random,
    choose_spread,
    communication_cost,
    detection,
    node_std,
    pick_max_pod,
    to_snapshot,
)

__all__ = [
    "Snapshot",
    "to_snapshot",
    "detection",
    "pick_max_pod",
    "choose_spread",
    "choose_binpack",
    "choose_random",
    "choose_kubescheduling",
    "choose_communication",
    "communication_cost",
    "node_std",
    "forecast",
]
