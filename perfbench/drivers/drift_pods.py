"""Per-pod drift cells: ``drift_sparse``'s rounds with every pod placed on
its own, through the port's per-pod streaming entry,
``bench.trace.replay_on_device_pods``.

A service runs the configuration's ``replicas`` pods (a Deployment),
pods grouped by service. The call graph is ``cluster.build``'s, on the
configuration at one replica, and the pool's columns are its call pairs
(``ii < jj``, row-major): a controller sees call rates per service pair,
and the port fans each one out to the pairs of their pods on the device.
Every check is at pod level, where each pod pair carries its call pair's
whole weight: the harness works the pod pairs out again
(``reference/pods.py``) and the reference re-solves them with
``reference/sparse_solve.py``, as ``drift_sparse`` does for services.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# the entry this driver drives: a program without it fails here, at once
from kubernetes_rescheduling_tpu_torch.bench.trace import replay_on_device_pods
from kubernetes_rescheduling_tpu_torch.core.sparsegraph import from_workmodel
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState
from perfbench import cluster
from perfbench.drivers import drift, drift_sparse
from perfbench.reference import dense_solve, pods, sparse_solve


class Driver(drift_sparse.Driver):
    def __init__(self, cell: dict, config: dict, seed: int, device, hooks):
        super().__init__(cell, dict(config, replicas=1), seed, device, hooks)
        self.config = config
        calls = self.dep
        svc = pods.pod_services(calls.services, int(config["replicas"]))
        P = len(svc)
        pa, pb, _ = pods.expand(calls.ii, calls.jj, svc)
        # the deployment at pod level: its pods as the services, their pairs
        self.dep = dep = dataclasses.replace(calls, services=P, ii=pa, jj=pb)
        sparse = config["sparse"]
        chunk = dense_solve.layout(P, dep.nodes, int(config["solver"]["chunk_size"])).chunk
        self.structure = st = sparse_solve.structure(
            P, dep.nodes, pa, pb, chunk, int(sparse["bu"]) * int(sparse["reg_tiles"]))
        self.edges = (st.ea, st.eb)
        self.edge_call = pods.call_index(calls.ii, calls.jj, calls.services, svc[st.ea],
                                         svc[st.eb])
        self.placement0 = cluster.stream(seed, 1).integers(0, dep.nodes, size=P)
        self.state = ClusterState.build(
            node_names=drift.node_names(dep), node_cpu_cap=[dep.node_cpu_m] * dep.nodes,
            node_mem_cap=[dep.node_mem_bytes] * dep.nodes, pod_services=svc.tolist(),
            pod_nodes=self.placement0.tolist(), pod_cpu=[dep.pod_cpu_m] * P,
            pod_mem=[dep.pod_mem_bytes] * P, device=device)

    def _graph(self, dep):
        """The port's service-level graph; the pool's columns are its call
        pairs in the order the entry takes them."""
        sparse = self.config["sparse"]
        self.edges = (dep.ii, dep.jj)
        self.sgraph = from_workmodel(drift.workmodel(dep), bu=int(sparse["bu"]),
                                     reg_tiles=int(sparse["reg_tiles"]), device=self.device)
        return None

    def entry(self, k: int):
        return replay_on_device_pods(self.state, self.sgraph, self.pool[k:k + 1],
                                     self.generator, self.solver)

    def _weights(self, r: int) -> np.ndarray:
        """f32[pod pairs]: round ``r``'s weight of each pod pair, in the
        reference's edge order: its call pair's."""
        return self.pool[r % self.pool.shape[0]][self.edge_call]
