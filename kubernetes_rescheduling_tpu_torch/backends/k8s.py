"""Live-Kubernetes adapter — the port of
``kubernetes_rescheduling_tpu.backends.k8s``, the host-side shell around the
device core.

The reference's cluster I/O semantics (SURVEY.md §5.3, §2):

- snapshot: the node list (control plane excluded), node capacity and usage
  from ``metrics.k8s.io/v1beta1``, per-pod usage with containers summed, and
  the Pod→ReplicaSet→Deployment owner-chain walk (reference
  podmonitor.py:7-125, get_resource_usage.py:5-68,
  delete_replaced_pod.py:25-38);
- teardown: foreground cascade delete, then poll for the 404 up to 180 s at
  1.5 s (reference delete_replaced_pod.py:8-22, 173-177);
- re-create: a minimal re-deployable spec (kept container keys, forced
  ``imagePullPolicy: IfNotPresent``, ``schedulerName: default-scheduler`` —
  reference delete_replaced_pod.py:64-142), patched with a NodeAffinity
  ``NotIn <hazard nodes>`` rule (reference rescheduling.py:42-55) and pinned
  per the policy's mechanism: ``nodeSelector`` for spread / binpack,
  ``nodeName`` for random / CAR / global, affinity only for kubescheduling
  (reference rescheduling.py:103-216).

The adapter works against any object exposing the small slice of the
Kubernetes client API it touches, so tests and ``chip_smoke.py`` run it
over fakes and production over the real ``kubernetes`` package, imported
only when no client objects are given (the package is optional). Snapshots
are parsed on the host and uploaded to ``device`` (the card unless the
caller asks for the CPU).
"""

from __future__ import annotations

import copy
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch.backends.base import MoveRequest, PlacementMechanism
from kubernetes_rescheduling_tpu_torch.backends.sim import _upload
from kubernetes_rescheduling_tpu_torch.core.quantities import cpu_to_millicores, mem_to_bytes
from kubernetes_rescheduling_tpu_torch.core.state import UNASSIGNED, ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.core.workmodel import Workmodel
from kubernetes_rescheduling_tpu_torch.telemetry.accounting import count_reconcile, timed_call
from kubernetes_rescheduling_tpu_torch.telemetry.registry import get_registry
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger, get_logger
from kubernetes_rescheduling_tpu_torch.utils.retry import (
    RetryPolicy,
    call_with_retry,
    is_transient,
)

__all__ = [
    "K8sBackend",
    "PlacementMechanism",
    "exclude_hazard_affinity",
    "extract_redeployable_spec",
    "merge_affinity",
]

logger = logging.getLogger(__name__)

HOSTNAME_KEY = "kubernetes.io/hostname"


def _is_api_error(e: BaseException) -> bool:
    """What the adapter may swallow: transport-level failures plus anything
    carrying an HTTP ``status`` (the real client's ``ApiException`` and the
    fakes' stand-in). ``RuntimeError`` is included because the client
    surfaces some config and transport failures as plain ``RuntimeError``;
    its interpreter-level subclasses (``RecursionError``,
    ``NotImplementedError``) are coding bugs and stay fatal, as do
    ``TypeError``, ``KeyError`` and the like."""
    if isinstance(e, (RecursionError, NotImplementedError)):
        return False
    return isinstance(e, (ConnectionError, TimeoutError, OSError, RuntimeError)) or hasattr(
        e, "status")


def _get(obj: Any, *names: str, default=None):
    """Attribute-or-key access tolerant of client models and plain dicts."""
    for name in names:
        if obj is None:
            return default
        if isinstance(obj, dict):
            if name in obj:
                obj = obj[name]
                continue
            return default
        if hasattr(obj, name):
            obj = getattr(obj, name)
            continue
        return default
    return obj if obj is not None else default


def exclude_hazard_affinity(hazard_nodes: list[str]) -> dict:
    """NodeAffinity NotIn rule (reference rescheduling.py:42-55)."""
    return {
        "nodeAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": {
                "nodeSelectorTerms": [
                    {
                        "matchExpressions": [
                            {"key": HOSTNAME_KEY, "operator": "NotIn",
                             "values": list(hazard_nodes)}
                        ]
                    }
                ]
            }
        }
    }


def merge_affinity(orig: dict | None, patch: dict) -> dict:
    """Merge an affinity patch into an existing affinity dict, one rule at
    every depth: two dicts merge key-wise, two lists concatenate (extra
    ``nodeSelectorTerms`` / ``matchExpressions`` accumulate instead of
    clobbering what the Deployment had), any other collision takes the
    patch value. For the hazard patch's shape this agrees with reference
    rescheduling.py:21-40."""

    def merge(a, b):
        if isinstance(a, dict) and isinstance(b, dict):
            out = dict(a)
            for k, v in b.items():
                out[k] = merge(a[k], v) if k in a else v
            return out
        if isinstance(a, list) and isinstance(b, list):
            return [*a, *b]
        return b

    return merge(copy.deepcopy(orig) if orig else {}, copy.deepcopy(patch))


def _strip_placement(tmpl_spec: dict) -> None:
    """Remove placement state a PREVIOUS move wrote into the pod template:
    the hostname nodeSelector key and hostname-keyed matchExpressions in the
    required nodeAffinity (the hazard NotIn rules). Constraints on other
    keys (``disktype: ssd``) stay."""
    selector = dict(tmpl_spec.get("nodeSelector") or {})
    selector.pop(HOSTNAME_KEY, None)
    tmpl_spec["nodeSelector"] = selector or None
    affinity = tmpl_spec.get("affinity")
    node_aff = (affinity or {}).get("nodeAffinity") or {}
    req = node_aff.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    terms = req.get("nodeSelectorTerms") or []
    new_terms = []
    for term in terms:
        exprs = [e for e in (term.get("matchExpressions") or []) if e.get("key") != HOSTNAME_KEY]
        if exprs or term.get("matchFields"):
            new_terms.append({**term, "matchExpressions": exprs})
    if terms and not new_terms:
        node_aff.pop("requiredDuringSchedulingIgnoredDuringExecution", None)
    elif new_terms:
        req["nodeSelectorTerms"] = new_terms
    if affinity and not node_aff:
        affinity.pop("nodeAffinity", None)
    if affinity is not None and not affinity:
        tmpl_spec["affinity"] = None


_KEPT_CONTAINER_KEYS = ("name", "image", "imagePullPolicy", "ports", "env", "resources",
                        "volumeMounts")


def extract_redeployable_spec(dep: dict) -> dict:
    """Minimal dict body that re-creates a Deployment (reference
    delete_replaced_pod.py:64-142). The input is dict-shaped (the real
    client's ``sanitize_for_serialization`` output)."""
    meta = dep.get("metadata", {}) or {}
    spec = dep.get("spec", {}) or {}
    tmpl = spec.get("template", {}) or {}
    tmpl_meta = tmpl.get("metadata", {}) or {}
    tmpl_spec = tmpl.get("spec", {}) or {}
    containers = []
    for c in tmpl_spec.get("containers", []) or []:
        kept = {k: v for k, v in c.items() if k in _KEPT_CONTAINER_KEYS}
        kept["imagePullPolicy"] = "IfNotPresent"
        containers.append(kept)
    return {
        "apiVersion": dep.get("apiVersion", "apps/v1"),
        "kind": dep.get("kind", "Deployment"),
        "metadata": {
            "name": meta.get("name"),
            "namespace": meta.get("namespace", "default"),
            "labels": dict(meta.get("labels") or {}),
        },
        "spec": {
            "replicas": spec.get("replicas", 1),
            "selector": spec.get("selector"),
            "strategy": spec.get("strategy"),
            "template": {
                "metadata": {
                    "labels": dict(tmpl_meta.get("labels") or {}),
                    "annotations": dict(tmpl_meta.get("annotations") or {}),
                },
                "spec": {
                    "containers": containers,
                    "volumes": tmpl_spec.get("volumes") or None,
                    "restartPolicy": "Always",
                    "terminationGracePeriodSeconds": tmpl_spec.get(
                        "terminationGracePeriodSeconds"),
                    "dnsPolicy": "ClusterFirst",
                    "nodeSelector": tmpl_spec.get("nodeSelector") or None,
                    "affinity": tmpl_spec.get("affinity"),
                    "schedulerName": "default-scheduler",
                },
            },
        },
    }


@dataclass
class K8sBackend:
    """Adapter over a live cluster (or a fake implementing the same calls)."""

    # the Deployment mechanism cannot pin ONE replica (apply_move raises for
    # pod-granular moves); the reconcile plane reads this and issues
    # Deployment-scoped repairs
    supports_pod_moves = False

    workmodel: Workmodel
    core_api: Any = None
    apps_api: Any = None
    custom_api: Any = None
    namespace: str = "default"
    control_plane_names: tuple[str, ...] = ("master",)  # reference podmonitor.py:45
    delete_timeout_s: float = 180.0
    delete_poll_interval_s: float = 1.5
    node_capacity: int | None = None
    pod_capacity: int | None = None
    # teardown outage estimate (the window in which a moved Deployment
    # serves nothing): a conservative default, replaced by the MEASURED
    # delete → 404 → re-create → ready wall time after each move
    reconcile_delay_s: float = 10.0
    sleeper: Callable[[float], None] = field(default=time.sleep)
    # every API call routes through this policy (transport errors and
    # 429/5xx retried with backoff and jitter; definitive statuses never).
    # Deliberately SHORT: the controller's BoundaryClient retries the whole
    # boundary call one layer up, and a dead cluster must still reach the
    # circuit breaker in seconds
    retry: RetryPolicy = field(default_factory=lambda: RetryPolicy(
        max_attempts=2, base_delay_s=0.5, max_delay_s=2.0, deadline_s=10.0))
    slog: StructuredLogger = field(default_factory=lambda: get_logger("k8s"))
    device: str | torch.device | None = DEFAULT_DEVICE

    def _api(self, label: str, fn: Callable[[], Any]) -> Any:
        """One cluster API call under the shared retry policy."""
        return call_with_retry(fn, policy=self.retry, label=f"k8s.{label}",
                               retryable=is_transient, sleeper=self.sleeper)

    def _swallow(self, call: str, exc: BaseException) -> None:
        """An API error this adapter deliberately absorbs: logged through the
        structured logger and counted, never silent."""
        self.slog.warn("swallowed_error", call=call, error=repr(exc))
        get_registry().counter(
            "backend_swallowed_errors_total",
            "API errors a backend absorbed instead of raising",
            labelnames=("backend", "call"),
        ).labels(backend="k8s", call=call).inc()

    def __post_init__(self) -> None:
        if self.core_api is None or self.apps_api is None or self.custom_api is None:
            # lazy: only a real cluster needs the client package
            from kubernetes import client, config  # type: ignore

            config.load_kube_config()
            self.core_api = self.core_api or client.CoreV1Api()
            self.apps_api = self.apps_api or client.AppsV1Api()
            self.custom_api = self.custom_api or client.CustomObjectsApi()
        self.device = resolve_device(self.device)
        self._graph = self.workmodel.comm_graph(device=self.device)
        self._svc_index = {n: i for i, n in enumerate(self.workmodel.names)}
        # the monitor's structure memo: the parsed node table, capacities
        # and pod→Deployment mapping, keyed by the (node list, pod list)
        # resourceVersion pair — while neither list changed, the owner walks
        # are skipped and only the usage metrics are re-fetched (a client
        # exposing no resourceVersion never engages it)
        self._struct_memo: tuple[tuple[str, str], dict] | None = None
        # the per-pod owner memo: a pod's owner chain is immutable for its
        # lifetime (a re-created pod gets a new name), so the ReplicaSet walk
        # is cached by pod name even when the list resourceVersions churn;
        # pruned to the current listing at every rebuild
        self._owner_memo: dict[str, str | None] = {}

    def comm_graph(self) -> CommGraph:
        return self._graph

    # ---- snapshot ----

    def _deployment_for_pod(self, pod: Any) -> str | None:
        """Pod→ReplicaSet→Deployment owner walk (reference
        delete_replaced_pod.py:25-38)."""
        owners = (_get(pod, "metadata", "owner_references")
                  or _get(pod, "metadata", "ownerReferences", default=[]) or [])
        for o in owners:
            kind = _get(o, "kind")
            if kind == "Deployment":
                return _get(o, "name")
            if kind == "ReplicaSet":
                rs = self._api("read_replica_set",
                               lambda: self.apps_api.read_namespaced_replica_set(
                                   _get(o, "name"), self.namespace))
                for ro in (_get(rs, "metadata", "owner_references")
                           or _get(rs, "metadata", "ownerReferences", default=[]) or []):
                    if _get(ro, "kind") == "Deployment":
                        return _get(ro, "name")
        return None

    def monitor(self) -> ClusterState:
        """The padded snapshot on the backend's device (reference
        podmonitor.py:7-125)."""
        with timed_call("k8s", "monitor"):
            return _upload(self._monitor(), self.device)

    @staticmethod
    def _list_rv(obj) -> str | None:
        rv = _get(obj, "metadata", "resource_version") or _get(obj, "metadata",
                                                               "resourceVersion")
        return str(rv) if rv else None

    def _structure(self, nodes, pods_items) -> dict:
        """Parse the node table, capacities and the tracked pods'
        ``(name, service index, node)`` from the two listings."""
        node_names = self._worker_names(nodes)
        cap_cpu: dict[str, float] = {}
        cap_mem: dict[str, float] = {}
        for n in _get(nodes, "items", default=[]):
            name = _get(n, "metadata", "name")
            capacity = _get(n, "status", "capacity", default={}) or {}
            cap_cpu[name] = float(cpu_to_millicores(str(capacity.get("cpu", "0"))))
            cap_mem[name] = float(mem_to_bytes(str(capacity.get("memory", "0"))))
        entries: list[tuple[str, int, str | None]] = []
        owner_memo: dict[str, str | None] = {}
        for p in pods_items:
            name = _get(p, "metadata", "name")
            dep = (self._owner_memo[name] if name in self._owner_memo
                   else self._deployment_for_pod(p))
            owner_memo[name] = dep
            if dep is None or dep not in self._svc_index:
                continue
            node = _get(p, "spec", "node_name") or _get(p, "spec", "nodeName")
            entries.append((name, self._svc_index[dep], node))
        self._owner_memo = owner_memo  # pruned to the live listing
        return {"node_names": node_names, "cap_cpu": cap_cpu, "cap_mem": cap_mem,
                "pods": entries}

    def _monitor(self) -> ClusterState:
        nodes = self._api("list_node", lambda: self.core_api.list_node(watch=False))
        pods_items, pods_rv = self._list_namespace_pods_rv()
        nodes_rv = self._list_rv(nodes)
        key = (nodes_rv, pods_rv) if nodes_rv is not None and pods_rv is not None else None
        if key is not None and self._struct_memo is not None and self._struct_memo[0] == key:
            # nothing changed between polls: reuse the parsed structure,
            # skip the owner walks, fetch only fresh usage metrics
            struct = self._struct_memo[1]
            get_registry().counter(
                "backend_monitor_short_circuits_total",
                "monitor polls that reused the previous poll's parsed cluster structure "
                "because both list resourceVersions were unchanged (per-pod owner-chain "
                "walks skipped; usage metrics stay fresh)",
                labelnames=("backend",),
            ).labels(backend="k8s").inc()
        else:
            struct = self._structure(nodes, pods_items)
            if key is not None:
                self._struct_memo = (key, struct)
        node_names = struct["node_names"]

        # node usage (metrics-server): the per-node base load's source
        node_used: dict[str, float] = {}
        node_used_mem: dict[str, float] = {}
        try:
            res = self._api("node_metrics", lambda: self.custom_api.list_cluster_custom_object(
                "metrics.k8s.io", "v1beta1", "nodes"))
            for item in res.get("items", []):
                name = item["metadata"]["name"]
                node_used[name] = float(cpu_to_millicores(item["usage"]["cpu"]))
                node_used_mem[name] = float(mem_to_bytes(item["usage"]["memory"]))
        except Exception as e:
            if not _is_api_error(e):
                raise
            # metrics-server absent: usage stays 0 (reference podmonitor.py:86-87)
            self._swallow("monitor.node_metrics", e)

        # pod usage, containers summed (reference get_resource_usage.py:48-68)
        pod_usage: dict[str, tuple[float, float]] = {}
        try:
            res = self._api("pod_metrics",
                            lambda: self.custom_api.list_namespaced_custom_object(
                                "metrics.k8s.io", "v1beta1", self.namespace, "pods"))
            for item in res.get("items", []):
                cpu = sum(cpu_to_millicores(c["usage"]["cpu"])
                          for c in item.get("containers", []))
                mem = sum(mem_to_bytes(c["usage"]["memory"]) for c in item.get("containers", []))
                pod_usage[item["metadata"]["name"]] = (float(cpu), float(mem))
        except Exception as e:
            if not _is_api_error(e):
                raise
            self._swallow("monitor.pod_metrics", e)

        node_index = {n: i for i, n in reversed(list(enumerate(node_names)))}
        services, pod_nodes, pod_cpu, pod_mem, pod_names = [], [], [], [], []
        tracked_cpu = {n: 0.0 for n in node_names}
        tracked_mem = {n: 0.0 for n in node_names}
        for name, svc_idx, node in struct["pods"]:
            cpu, mem = pod_usage.get(name, (0.0, 0.0))
            services.append(svc_idx)
            pod_nodes.append(node_index.get(node, UNASSIGNED))
            pod_cpu.append(cpu)
            pod_mem.append(mem)
            pod_names.append(name)
            if node in tracked_cpu:
                tracked_cpu[node] += cpu
                tracked_mem[node] += mem

        # base = measured node usage minus tracked pod usage (system daemons)
        base_cpu = [max(node_used.get(n, 0.0) - tracked_cpu[n], 0.0) for n in node_names]
        base_mem = [max(node_used_mem.get(n, 0.0) - tracked_mem[n], 0.0) for n in node_names]
        return ClusterState.build(
            node_names=node_names,
            node_cpu_cap=[struct["cap_cpu"].get(n, 0.0) for n in node_names],
            node_mem_cap=[struct["cap_mem"].get(n, 0.0) for n in node_names],
            pod_services=services,
            pod_nodes=pod_nodes,
            pod_cpu=pod_cpu,
            pod_mem=pod_mem,
            pod_names=pod_names,
            node_base_cpu=base_cpu,
            node_base_mem=base_mem,
            node_capacity=self.node_capacity,
            pod_capacity=self.pod_capacity,
            device="cpu",
        )

    def _worker_names(self, nodes) -> list[str]:
        """The control-plane filter shared by monitor() and node_names."""
        return [_get(n, "metadata", "name") for n in _get(nodes, "items", default=[]) or []
                if _get(n, "metadata", "name") not in self.control_plane_names]

    @property
    def node_names(self) -> list[str]:
        """Worker node names (control plane excluded), freshly listed."""
        return self._worker_names(
            self._api("list_node", lambda: self.core_api.list_node(watch=False)))

    def cordon(self, node: str) -> bool:
        """``kubectl cordon``: mark the node unschedulable (reference
        auto_full_pipeline_repeat.sh:48-50)."""
        return self._set_unschedulable(node, True)

    def uncordon(self, node: str) -> bool:
        return self._set_unschedulable(node, False)

    def _set_unschedulable(self, node: str, value: bool) -> bool:
        try:
            self.core_api.patch_node(node, {"spec": {"unschedulable": value}})
            return True
        except Exception as e:
            logger.warning("cordon(%s, %s) failed: %s", node, value, e)
            return False

    def inject_imbalance(self, node: str) -> None:
        """The reference pipeline's "Before" construction on a live cluster:
        cordon every OTHER worker, re-create each tracked Deployment unpinned
        (the scheduler can only choose ``node``), then uncordon (reference
        auto_full_pipeline_repeat.sh:48-58). The simulator's call shape."""
        workers = self.node_names
        if node not in workers:
            # a typo'd target fails loudly instead of cordoning EVERY worker
            raise ValueError(f"unknown node {node!r}; workers: {workers}")
        cordoned = [n for n in workers if n != node and self.cordon(n)]
        try:
            for svc in self.workmodel.names:
                # affinityOnly with no hazard list: a plain delete + re-create
                # with the scheduler choosing; only `node` is schedulable
                self.apply_move(MoveRequest(service=svc, target_node=node,
                                            mechanism="affinityOnly"))
        finally:
            for n in cordoned:
                self.uncordon(n)

    def _list_namespace_pods_rv(self) -> tuple[list, str | None]:
        """This namespace's pods plus the LIST object's resourceVersion (the
        structure memo's key; None when the client exposes none): filtered
        server-side when the client offers ``list_namespaced_pod``, else the
        all-namespaces listing filtered here."""
        lister = getattr(self.core_api, "list_namespaced_pod", None)
        if lister is not None:
            pods = self._api("list_pods", lambda: lister(self.namespace, watch=False))
            return (_get(pods, "items", default=[]) or [], self._list_rv(pods))
        pods = self._api("list_pods",
                         lambda: self.core_api.list_pod_for_all_namespaces(watch=False))
        items = [p for p in (_get(pods, "items", default=[]) or [])
                 if _get(p, "metadata", "namespace") == self.namespace]
        return (items, self._list_rv(pods))

    def pod_restart_counts(self) -> dict[str, int] | None:
        """Per-pod container ``restartCount`` sums over the namespace (the
        reference's experiment-health metric, release1.sh:101-102), per pod
        so a crash delta survives delete + re-create. None when the listing
        fails."""
        try:
            items = self._list_namespace_pods_rv()[0]
        except Exception as e:
            if not _is_api_error(e):
                raise
            self._swallow("pod_restart_counts", e)
            return None
        out: dict[str, int] = {}
        for p in items:
            statuses = (_get(p, "status", "container_statuses")
                        or _get(p, "status", "containerStatuses", default=[]) or [])
            total = 0
            for cs in statuses:
                count = _get(cs, "restart_count")
                if count is None:
                    count = _get(cs, "restartCount", default=0)
                total += int(count or 0)
            out[str(_get(p, "metadata", "name"))] = total
        return out

    # ---- reconcile ----

    def _poll(self, name: str, done: Callable[[Any], bool], what: str) -> bool:
        """Read the Deployment until ``done(body)`` — or, with ``done``
        None, until the read 404s — bounded both ways: a poll budget
        (timeout / interval, so a no-op sleeper shortens the wait instead of
        spinning) AND the wall-clock deadline. Errors other than the awaited
        404 are logged and polled through: the Deployment is already
        foreground-deleted, and crashing here would lose the workload."""
        interval = max(self.delete_poll_interval_s, 1e-9)
        polls = max(1, int(round(self.delete_timeout_s / interval)))
        deadline = time.monotonic() + self.delete_timeout_s
        for _ in range(polls):
            if time.monotonic() > deadline:
                return False
            try:
                dep = self.apps_api.read_namespaced_deployment(name=name,
                                                               namespace=self.namespace)
                if done is not None and done(dep):
                    return True
            except Exception as e:
                if done is None and getattr(e, "status", None) == 404:
                    return True
                logger.warning("%s(%s): error while polling: %s", what, name, e)
            self.sleeper(interval)
        return False

    def _wait_deleted(self, name: str) -> bool:
        """Poll for the 404 (reference delete_replaced_pod.py:8-22)."""
        return self._poll(name, None, "wait_deleted")

    def _wait_ready(self, name: str) -> bool:
        """Poll until the re-created Deployment reports every replica ready,
        the true end of the serving outage (create acceptance is only the
        API accepting the object)."""

        def ready(dep) -> bool:
            want = _get(dep, "spec", "replicas")
            want = 1 if want is None else int(want)
            if want <= 0:
                return True  # scaled to zero: nothing to wait for
            have = _get(dep, "status", "ready_replicas") or _get(dep, "status",
                                                                 "readyReplicas") or 0
            return int(have) >= want

        return self._poll(name, ready, "wait_ready")

    def apply_move(self, move: MoveRequest) -> str | None:
        """Foreground delete + pinned re-create (reference
        delete_replaced_pod.py:144-185 + rescheduling.py:57-73). Returns the
        landing node on success (the advisory target under ``affinityOnly``:
        the scheduler's pick is observable only at the next monitor)."""
        with timed_call("k8s", "apply_move"):
            return self._apply_move(move)

    def _apply_move(self, move: MoveRequest) -> str | None:
        if move.pod is not None:
            # deleting one pod of a Deployment only makes its ReplicaSet
            # re-create it wherever the scheduler likes: no Deployment-level
            # mechanism pins a single replica
            raise ValueError(
                "per-pod moves are not expressible through the k8s Deployment mechanism "
                "(a deleted replica is re-created unpinned by its ReplicaSet); run "
                "placement_unit='pod' against the sim backend, or manage bare pods")
        name = move.service
        try:
            dep = self._api("read_deployment", lambda: self.apps_api.read_namespaced_deployment(
                name=name, namespace=self.namespace))
        except Exception as e:
            if not _is_api_error(e):
                raise
            self._swallow("apply_move.read_deployment", e)
            return None
        if not isinstance(dep, dict):
            # a real client model → plain dict
            from kubernetes.client import ApiClient  # type: ignore

            dep = ApiClient().sanitize_for_serialization(dep)
        body = extract_redeployable_spec(dep)

        tmpl_spec = body["spec"]["template"]["spec"]
        # each move expresses the CURRENT decision only: a previous move's
        # pins (a nodeSelector, a stale hostname NotIn rule) would survive
        # re-creation and override this round's placement
        _strip_placement(tmpl_spec)
        if move.hazard_nodes:
            tmpl_spec["affinity"] = merge_affinity(
                tmpl_spec.get("affinity"), exclude_hazard_affinity(list(move.hazard_nodes)))
        if move.mechanism == "nodeSelector":
            tmpl_spec["nodeSelector"] = {HOSTNAME_KEY: move.target_node}
        elif move.mechanism == "nodeName":
            tmpl_spec["nodeName"] = move.target_node
        elif move.mechanism != "affinityOnly":
            raise ValueError(f"unknown mechanism {move.mechanism!r}")

        t0 = time.monotonic()
        try:
            self._api("delete_deployment", lambda: self.apps_api.delete_namespaced_deployment(
                name=name, namespace=self.namespace, body={"propagationPolicy": "Foreground"}))
        except Exception as e:
            if not _is_api_error(e):
                raise
            if getattr(e, "status", None) != 404:  # already gone is fine
                # a transient failure: skip the move, keep the loop alive
                self._swallow("apply_move.delete_deployment", e)
                return None
        if not self._wait_deleted(name):
            return None  # timeout: skip (reference delete_replaced_pod.py:178-180)
        try:
            self._api("create_deployment", lambda: self.apps_api.create_namespaced_deployment(
                namespace=self.namespace, body=body))
        except Exception as e:
            if not _is_api_error(e):
                raise
            if getattr(e, "status", None) != 409:
                self._swallow("apply_move.create_deployment", e)
                return None
            # 409 AlreadyExists after our own delete → 404 wait: the first
            # create landed and its response was lost — the move SUCCEEDED
        # the outage window: delete → 404 → re-create → pods READY (a ready
        # timeout still stamps the elapsed budget); the floor keeps a fake
        # client's run from zeroing the accounting
        self._wait_ready(name)
        self.reconcile_delay_s = max(time.monotonic() - t0, 1e-3)
        # a whole-Deployment move restarts every replica
        count_reconcile("k8s", int(body["spec"].get("replicas") or 1))
        return move.target_node

    def advance(self, seconds: float) -> None:
        self.sleeper(seconds)
