"""Elastic topologies: churn, autoscaling and node-pool events — the port of
``kubernetes_rescheduling_tpu.elastic``.

- :mod:`elastic.events` — typed churn events and the four seeded profiles;
- :mod:`elastic.buckets` — quantized shape buckets and the name-stripped
  device views;
- :mod:`elastic.engine` — the :class:`ChurnEngine` that applies a
  profile's events to a backend between controller rounds;
- :mod:`elastic.rates` — the per-service request-rate series the
  ``diurnal-autoscale`` profile follows.
"""

from kubernetes_rescheduling_tpu_torch.elastic.buckets import (
    ShapeBuckets,
    bucket_capacity,
    device_graph,
    device_view,
)
from kubernetes_rescheduling_tpu_torch.elastic.engine import ChurnEngine, make_fleet_churn
from kubernetes_rescheduling_tpu_torch.elastic.events import (
    GRAPH_EVENTS,
    NodeAdd,
    NodeDrain,
    ReplicaScale,
    ServiceDeploy,
    ServiceTeardown,
    SpotPreemption,
    WorkloadView,
    make_profile,
)

__all__ = [
    "ShapeBuckets",
    "bucket_capacity",
    "device_graph",
    "device_view",
    "ChurnEngine",
    "make_fleet_churn",
    "GRAPH_EVENTS",
    "NodeAdd",
    "NodeDrain",
    "ReplicaScale",
    "ServiceDeploy",
    "ServiceTeardown",
    "SpotPreemption",
    "WorkloadView",
    "make_profile",
]
