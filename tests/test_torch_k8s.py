"""The live-cluster adapter against the JAX package on the CPU.

Every case of tests/test_k8s_wire.py, tests/test_backends.py's
``TestK8sBackend`` and its module-level k8s cases (the three
``test_harness_k8s_*`` ones run in tests/test_torch_experiment.py, beside
the experiment matrix), the four k8s cases of tests/test_resilience.py and the reconcile
cases of the k8s contract (tests/test_reconcile.py's Deployment-scoped
repairs and advisory adoption) run on both packages over the same fake
clients (the JAX tests' own: dict-world clusters and the recorded wire
bodies of ``tests/fixtures/k8s_wire/``). The case's assertions hold in each,
and what it observes — snapshots field by field, the bodies written to the
fake apiserver, landings, counters, the ledger's verdicts — is equal between
them, exactly. A greedy control loop over the fakes decides alike in both.
"""

import copy
import dataclasses
import json
import random
from types import SimpleNamespace

import numpy as np
import pytest
from test_backends import FakeCluster
from test_k8s_wire import RvReplayCluster, WireReplayCluster
from test_resilience import _ApiError, _MiniCore, _RaisingCustom
from test_torch_controller import DECISIONS
from test_torch_reconcile import JAX as RJAX
from test_torch_reconcile import TORCH as RTORCH
from test_torch_reconcile import _setup_ledger, backend, ctl_advisory_override_is_not_drift
from test_torch_state import assert_state_equal

from kubernetes_rescheduling_tpu.backends import k8s as jk8s
from kubernetes_rescheduling_tpu.backends.base import MoveRequest as JMove
from kubernetes_rescheduling_tpu.bench.controller import run_controller as j_run
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.core import workmodel as jwm
from kubernetes_rescheduling_tpu.core.state import UNASSIGNED as J_UNASSIGNED
from kubernetes_rescheduling_tpu.telemetry import registry as jregistry
from kubernetes_rescheduling_tpu_torch.backends import k8s as tk8s
from kubernetes_rescheduling_tpu_torch.backends.base import MoveRequest as TMove
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.core import workmodel as twm
from kubernetes_rescheduling_tpu_torch.core.state import UNASSIGNED as T_UNASSIGNED
from kubernetes_rescheduling_tpu_torch.telemetry import registry as tregistry


def arr(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _metric(reg, name, **labels):
    for rec in reg.snapshot():
        if rec["metric"] == name and (rec.get("labels") or {}) == labels:
            return rec.get("value")
    return 0.0


JAX = SimpleNamespace(name="jax", k8s=jk8s, Move=JMove, wm=jwm, UNASSIGNED=J_UNASSIGNED,
                      registry=jregistry, dev={})
TORCH = SimpleNamespace(name="torch", k8s=tk8s, Move=TMove, wm=twm, UNASSIGNED=T_UNASSIGNED,
                        registry=tregistry, dev={"device": "cpu"})


def bookinfo(P):
    S = P.wm.ServiceSpec
    return P.wm.Workmodel(services=(
        S(name="productpage", callees=("details", "reviews")), S(name="details"),
        S(name="reviews", callees=("ratings",), replicas=2), S(name="ratings"),
    ), source="bookinfo-wire")


def make_wire_backend(P, fc=None, **kw):
    fc = fc if fc is not None else WireReplayCluster()
    kw.setdefault("delete_timeout_s", 5.0)
    kw.setdefault("delete_poll_interval_s", 1.0)
    b = P.k8s.K8sBackend(workmodel=bookinfo(P), namespace="default", core_api=fc, apps_api=fc,
                         custom_api=fc, control_plane_names=("kind-control-plane",),
                         sleeper=lambda s: None, **kw, **P.dev)
    return b, fc


def fake_backend(P, fc_cls=FakeCluster):
    wm = P.wm.mubench_workmodel_c()
    fc = fc_cls(wm)
    return P.k8s.K8sBackend(workmodel=wm, core_api=fc, apps_api=fc, custom_api=fc,
                            sleeper=lambda s: None, **P.dev), fc


def snap(state) -> dict:
    return {f.name: (arr(getattr(state, f.name)).tolist()
                     if not isinstance(getattr(state, f.name), tuple)
                     else getattr(state, f.name))
            for f in dataclasses.fields(state)}


# ---------------- tests/test_k8s_wire.py ----------------


def wire_control_plane_excluded(P):
    b, _ = make_wire_backend(P)
    assert b.node_names == ["worker1", "worker2", "worker3"]
    return b.node_names


def wire_snapshot_parses_wire_bodies(P):
    b, _ = make_wire_backend(P)
    st = b.monitor()
    names = list(st.pod_names)
    assert all("node-exporter" not in n for n in names)  # DaemonSet pod untracked
    assert float(st.node_cpu_cap[0]) == 20000.0  # 20 CPUs
    # the sidecar's usage container-summed: 142m + 31m
    assert float(st.pod_cpu[names.index("productpage-7d9c56b8f4-abcde")]) == 173.0
    j = names.index("ratings-6cf8d8c9b5-q4r7s")  # missing metrics row: usage 0
    assert float(st.pod_cpu[j]) == 0.0 and bool(st.pod_valid[j])
    assert int(st.pod_node[names.index("reviews-5b8cd9fd6c-zx81v")]) == P.UNASSIGNED
    return snap(st)


def wire_base_load_from_node_metrics_with_missing_row(P):
    b, _ = make_wire_backend(P)
    st = b.monitor()
    assert float(st.node_base_cpu[0]) == pytest.approx(1824.0 - (173.0 + 88.0), rel=1e-3)
    assert float(st.node_base_cpu[2]) == 0.0  # worker3's row missing: clamps to 0
    return arr(st.node_base_cpu).tolist()


def wire_restart_counts_summed_across_containers(P):
    b, _ = make_wire_backend(P)
    counts = b.pod_restart_counts()
    assert counts["reviews-5b8cd9fd6c-k9m2p"] == 2
    assert counts["productpage-7d9c56b8f4-abcde"] == 1
    return counts


def wire_apply_move_with_mid_delete_404_flap(P):
    b, fc = make_wire_backend(P)
    dep = fc.deployments["reviews"]
    ready, deleting, not_ready = (copy.deepcopy(dep) for _ in range(3))
    ready["status"]["readyReplicas"] = 2
    deleting["metadata"]["deletionTimestamp"] = "2026-07-29T16:05:00Z"
    not_ready["status"]["readyReplicas"] = 0
    # initial read → deletion in progress (the flap) → 404 → not ready → ready
    fc.read_script["reviews"] = [dep, deleting, 404, not_ready, ready]
    landed = b.apply_move(P.Move(service="reviews", target_node="worker3",
                                 mechanism="nodeSelector"))
    assert landed == "worker3"
    assert fc.deleted == ["reviews"] and len(fc.created) == 1
    return {"landed": landed, "created": fc.created, "script": fc.read_script}


def wire_recreate_strips_stale_pins_and_server_fields(P):
    b, fc = make_wire_backend(P)
    fc.read_script["reviews"] = [fc.deployments["reviews"], 404]
    b.apply_move(P.Move(service="reviews", target_node="worker1", mechanism="nodeSelector"))
    body = fc.created[0]
    tmpl = body["spec"]["template"]["spec"]
    assert "nodeName" not in tmpl
    assert tmpl.get("nodeSelector") == {"kubernetes.io/hostname": "worker1"}
    assert "NotIn" not in json.dumps(tmpl.get("affinity") or {})
    md = body["metadata"]
    assert "resourceVersion" not in md and "uid" not in md and "status" not in body
    c = tmpl["containers"][0]
    assert c["resources"]["requests"]["cpu"] == "100m"
    assert c["env"] == [{"name": "LOG_DIR", "value": "/tmp/logs"}]
    assert c["ports"][0]["containerPort"] == 9080
    assert "livenessProbe" not in c and "readinessProbe" not in c
    return body


def wire_delete_flap_exhausting_poll_budget_fails_closed(P):
    b, fc = make_wire_backend(P)
    dep = fc.deployments["reviews"]
    fc.read_script["reviews"] = [dep] + [dep] * 50  # a stuck finalizer
    landed = b.apply_move(P.Move(service="reviews", target_node="worker3",
                                 mechanism="nodeSelector"))
    assert landed is None
    return {"remaining": len(fc.read_script["reviews"]), "created": fc.created}


def wire_unchanged_resource_versions_skip_the_rebuild(P):
    b, fc = make_wire_backend(P, RvReplayCluster(), delete_timeout_s=180.0,
                         delete_poll_interval_s=1.5)
    st1 = b.monitor()
    walks = fc.rs_reads
    assert walks > 0
    st2 = b.monitor()
    assert fc.rs_reads == walks  # the structure reused: no owner walk
    assert snap(st2) == snap(st1)
    return {"walks": walks, "state": snap(st2)}


def wire_changed_pod_list_rebuilds_but_owner_walks_stay_cached(P):
    b, fc = make_wire_backend(P, RvReplayCluster(), delete_timeout_s=180.0,
                         delete_poll_interval_s=1.5)
    b.monitor()
    walks = fc.rs_reads
    fc.pod_list["metadata"]["resourceVersion"] = "99999"
    b.monitor()
    assert b._struct_memo[0][1] == "99999"  # rebuilt
    assert fc.rs_reads == walks  # the per-pod owner memo held
    new_pod = copy.deepcopy(fc.pod_list["items"][0])
    new_pod["metadata"]["name"] = "reviews-5b8cd9fd6c-fresh"
    fc.pod_list["items"].append(new_pod)
    b.monitor()  # the same rv: short-circuit, the new pod invisible
    assert fc.rs_reads == walks
    fc.pod_list["metadata"]["resourceVersion"] = "100001"
    st = b.monitor()
    assert fc.rs_reads == walks + 1  # exactly the new pod's walk
    assert "reviews-5b8cd9fd6c-fresh" in b._owner_memo
    return {"memo": b._owner_memo, "state": snap(st)}


def wire_missing_resource_version_never_short_circuits(P):
    b, _ = make_wire_backend(P)
    b.monitor()
    b.monitor()
    assert b._struct_memo is None
    return None


# ---------------- tests/test_backends.py ----------------


def be_monitor(P):
    b, fc = fake_backend(P)
    state = b.monitor()
    assert "master" not in state.node_names and state.num_nodes == 2
    assert int(arr(state.pod_valid).sum()) == 20
    assert float(state.node_cpu_cap[0]) == 8000.0 and float(state.pod_cpu[0]) == 150.0
    tracked0 = sum(150.0 for i in range(state.num_pods)
                   if bool(state.pod_valid[i]) and int(state.pod_node[i]) == 0)
    assert float(state.node_base_cpu[0]) == pytest.approx(2000.0 - tracked0)
    return snap(state)


def be_apply_move_nodename(P):
    b, fc = fake_backend(P)
    assert b.apply_move(P.Move(service="s3", target_node="worker2", hazard_nodes=("worker1",),
                               mechanism="nodeName"))
    spec = fc.deployments["s3"]["spec"]["template"]["spec"]
    assert spec["nodeName"] == "worker2" and spec["schedulerName"] == "default-scheduler"
    c = spec["containers"][0]
    assert c["imagePullPolicy"] == "IfNotPresent" and "livenessProbe" not in c
    terms = spec["affinity"]["nodeAffinity"]["requiredDuringSchedulingIgnoredDuringExecution"]
    assert terms["nodeSelectorTerms"][0]["matchExpressions"][0]["values"] == ["worker1"]
    assert fc.pods["s3-pod"]["node"] == "worker2"
    return fc.deployments["s3"]


def be_apply_move_nodeselector(P):
    b, fc = fake_backend(P)
    assert b.apply_move(P.Move(service="s1", target_node="worker1", mechanism="nodeSelector"))
    spec = fc.deployments["s1"]["spec"]["template"]["spec"]
    assert spec["nodeSelector"] == {"kubernetes.io/hostname": "worker1"}
    assert spec.get("nodeName") is None
    return fc.deployments["s1"]


def be_apply_move_missing_deployment(P):
    b, _ = fake_backend(P)
    assert not b.apply_move(P.Move(service="nope", target_node="worker1"))
    return None


def be_mechanism_table_matches_reference(P):
    # reference rescheduling.py:103,135 (nodeSelector), :155,:216
    # (nodeName), :167-171 (affinity only)
    m = P.k8s.PlacementMechanism
    assert m["spread"] == m["binpack"] == "nodeSelector"
    assert m["random"] == m["communication"] == "nodeName"
    assert m["kubescheduling"] == "affinityOnly"
    return dict(m)


def be_merge_affinity_extends_lists(P):
    base = P.k8s.exclude_hazard_affinity(["w1"])
    merged = P.k8s.merge_affinity(base, P.k8s.exclude_hazard_affinity(["w2"]))
    terms = merged["nodeAffinity"]["requiredDuringSchedulingIgnoredDuringExecution"][
        "nodeSelectorTerms"]
    assert len(terms) == 2
    deep = P.k8s.merge_affinity({"a": {"b": [1], "c": 1}}, {"a": {"b": [2], "c": 2, "d": 3}})
    assert deep == {"a": {"b": [1, 2], "c": 2, "d": 3}}
    return merged, deep


def be_extract_spec_defaults(P):
    body = P.k8s.extract_redeployable_spec({"metadata": {"name": "x"}, "spec": {}})
    assert body["metadata"]["name"] == "x"
    assert body["spec"]["template"]["spec"]["restartPolicy"] == "Always"
    assert body["spec"]["template"]["spec"]["dnsPolicy"] == "ClusterFirst"
    return body


def be_pod_restart_counts(P):
    b, fc = fake_backend(P)
    counts = b.pod_restart_counts()
    assert counts is not None and all(v == 0 for v in counts.values())
    pods = list(fc.pods)
    fc.pods[pods[0]]["restarts"] = 2
    fc.pods[pods[1]]["restarts"] = 3
    counts = b.pod_restart_counts()
    assert counts[pods[0]] == 2 and counts[pods[1]] == 3 and sum(counts.values()) == 5

    class Failing:
        def list_pod_for_all_namespaces(self, watch=False):
            raise RuntimeError("api down")

    b.core_api = Failing()
    assert b.pod_restart_counts() is None  # swallowed, counted
    return counts


def be_k8s_inject_imbalance_cordons_and_piles_up(P):
    b, fc = fake_backend(P)
    assert set(b.node_names) == {"worker1", "worker2"}
    b.inject_imbalance("worker2")  # not the fake scheduler's first pick
    assert {info["node"] for info in fc.pods.values()} == {"worker2"}
    assert fc.cordoned == set()  # uncordoned afterwards
    state = b.monitor()
    pn = arr(state.pod_node)[arr(state.pod_valid)]
    assert (pn == state.node_names.index("worker2")).all()
    with pytest.raises(ValueError, match="unknown node"):
        b.inject_imbalance("worker-2")
    return snap(state)


def be_apply_move_strips_previous_pins(P):
    b, fc = fake_backend(P)
    assert b.apply_move(P.Move(service="s0", target_node="worker2", hazard_nodes=("worker1",),
                               mechanism="nodeSelector"))
    spec = fc.deployments["s0"]["spec"]["template"]["spec"]
    assert spec["nodeSelector"] == {"kubernetes.io/hostname": "worker2"}
    assert "worker1" in str(spec["affinity"])
    assert b.apply_move(P.Move(service="s0", target_node="worker1", mechanism="affinityOnly"))
    spec = fc.deployments["s0"]["spec"]["template"]["spec"]
    assert spec.get("nodeSelector") is None
    assert "worker1" not in str(spec.get("affinity") or {})
    assert fc.pods["s0-pod"]["node"] == "worker1"  # the fake scheduler chose freely
    return fc.deployments["s0"]


def be_per_pod_moves_are_refused(P):
    b, _ = fake_backend(P)
    assert b.supports_pod_moves is False
    with pytest.raises(ValueError, match="per-pod moves are not expressible"):
        b.apply_move(P.Move(service="s0", pod="s0-pod", target_node="worker1"))
    with pytest.raises(ValueError, match="unknown mechanism"):
        b.apply_move(P.Move(service="s0", target_node="worker1", mechanism="teleport"))
    return None


# ---------------- tests/test_resilience.py ----------------


def mini_backend(P, custom):
    return P.k8s.K8sBackend(workmodel=P.wm.mubench_workmodel_c(), core_api=_MiniCore(),
                            apps_api=object(), custom_api=custom, sleeper=lambda s: None,
                            **P.dev)


def res_k8s_swallows_api_errors_with_log_and_counter(P):
    b = mini_backend(P, _RaisingCustom(_ApiError(503)))
    state = b.monitor()  # metrics-server down: usage stays 0
    assert state.num_nodes == 1  # master excluded
    reg = P.registry.get_registry()
    for call in ("monitor.node_metrics", "monitor.pod_metrics"):
        assert _metric(reg, "backend_swallowed_errors_total", backend="k8s", call=call) == 1
    records = b.slog.records() if callable(b.slog.records) else b.slog.records
    swallowed = [r for r in records if r["event"] == "swallowed_error"]
    assert len(swallowed) >= 2
    return snap(state)


def res_k8s_programming_errors_are_not_swallowed(P):
    with pytest.raises(TypeError, match="bug in the adapter"):
        mini_backend(P, _RaisingCustom(TypeError("bug in the adapter"))).monitor()
    with pytest.raises(RecursionError):
        mini_backend(P, _RaisingCustom(RecursionError("runaway parse"))).monitor()
    return None


def res_k8s_create_conflict_after_delete_counts_as_success(P):
    body = {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": "s0", "namespace": "default"},
            "spec": {"replicas": 1, "template": {"metadata": {}, "spec": {"containers": []}}}}

    class ConflictApps:
        def __init__(self):
            self.deleted = False

        def read_namespaced_deployment(self, name, namespace):
            if self.deleted:
                raise _ApiError(404)
            return body

        def delete_namespaced_deployment(self, name, namespace, body=None):
            self.deleted = True

        def create_namespaced_deployment(self, namespace, body):
            raise _ApiError(409)  # our retried create collided with itself

    b = P.k8s.K8sBackend(workmodel=P.wm.mubench_workmodel_c(), core_api=_MiniCore(),
                         apps_api=ConflictApps(), custom_api=_RaisingCustom(_ApiError(404)),
                         sleeper=lambda s: None, delete_timeout_s=0.01,
                         delete_poll_interval_s=0.001, **P.dev)
    landed = b.apply_move(P.Move(service="s0", target_node="worker1", mechanism="nodeName"))
    assert landed == "worker1"
    reg = P.registry.get_registry()
    assert _metric(reg, "backend_swallowed_errors_total", backend="k8s",
                   call="apply_move.create_deployment") == 0
    return landed


def res_k8s_retries_throttled_status(P):
    calls = {"n": 0}

    class FlakyCustom(_RaisingCustom):
        def list_cluster_custom_object(self, *a, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise _ApiError(503)
            return {"items": []}

        def list_namespaced_custom_object(self, *a, **kw):
            return {"items": []}

    b = mini_backend(P, _RaisingCustom(_ApiError(404)))
    b.custom_api = FlakyCustom(None)
    b.monitor()
    assert calls["n"] == 2  # the 503 retried, then succeeded
    assert _metric(P.registry.get_registry(), "boundary_retries_total",
                   call="k8s.node_metrics") == 1
    return calls


CASES = [f for name, f in sorted(globals().items())
         if name.startswith(("wire_", "be_", "res_")) and callable(f)]


@pytest.mark.parametrize("case", CASES, ids=[f.__name__ for f in CASES])
def test_k8s_case_matches_jax(case):
    """The case's assertions hold in both packages, and what it observes is
    equal — with each package's process registry fresh, so the counters the
    adapter writes there are compared too."""
    seen = []
    for P in (JAX, TORCH):
        prev = P.registry.set_registry(P.registry.MetricsRegistry())
        try:
            out = case(P)
            counters = sorted(
                (r["metric"], tuple(sorted((r.get("labels") or {}).items())), r.get("value"))
                for r in P.registry.get_registry().snapshot()
                if r["metric"] in ("backend_swallowed_errors_total", "boundary_retries_total",
                                   "boundary_failures_total", "backend_reconciles_total",
                                   "backend_pods_restarted_total",
                                   "backend_monitor_short_circuits_total")
                or (r["metric"] == "backend_calls_total"))
        finally:
            P.registry.set_registry(prev)
        seen.append((json.loads(json.dumps(out, default=str)), counters))
    assert seen[1] == seen[0]


def test_bare_k8s_backend_needs_the_kubernetes_client():
    """Without client objects the adapter imports the ``kubernetes`` package
    lazily; where it is not installed both packages raise the ImportError —
    never a silent simulator."""
    try:
        import kubernetes  # noqa: F401
    except ImportError:
        pass
    else:
        pytest.skip("the kubernetes client is installed here: a bare backend would "
                    "read this machine's kubeconfig")
    for P in (JAX, TORCH):
        with pytest.raises(ImportError):
            P.k8s.K8sBackend(workmodel=P.wm.mubench_workmodel_c())


def test_k8s_wire_snapshot_on_the_device_equals_the_host_parse():
    """The snapshot the port uploads is the JAX parse of the same bodies."""
    jb, _ = make_wire_backend(JAX)
    tb, _ = make_wire_backend(TORCH)
    assert_state_equal(tb.monitor(), jb.monitor())
    assert tb.comm_graph().names == tuple(jb.comm_graph().names)
    np.testing.assert_array_equal(arr(tb.comm_graph().adj), arr(jb.comm_graph().adj))


@pytest.mark.parametrize("algorithm", ["communication", "kubescheduling", "spread"])
def test_greedy_loop_over_the_fake_cluster_matches_jax(algorithm):
    """The reference's own loop through the adapter: greedy rounds over the
    dict-world cluster (worker1 hot), the same decisions, the same bodies
    written, the same records — reconcile blocks included (kubescheduling's
    advisory moves are adopted, never charged)."""

    class HotCluster(FakeCluster):
        def list_cluster_custom_object(self, group, version, plural):
            usage = {"master": "1000m", "worker1": "6000m", "worker2": "1000m"}
            return {"items": [{"metadata": {"name": n},
                               "usage": {"cpu": usage[n], "memory": "4Gi"}}
                              for n in self.nodes]}

    runs = []
    for P, run, Config in ((JAX, j_run, JConfig), (TORCH, t_run, TConfig)):
        b, fc = fake_backend(P, HotCluster)
        cfg = Config(algorithm=algorithm, max_rounds=3, sleep_after_action_s=0.0, seed=0,
                     backend="k8s")
        kw = {"device": "cpu"} if P is TORCH else {}
        res = run(b, cfg, registry=P.registry.MetricsRegistry(), **kw)
        runs.append((res, fc))
    (j, jfc), (t, tfc) = runs
    assert len(t.rounds) == len(j.rounds) == 3 and t.moves >= 1
    for a, b in zip(t.rounds, j.rounds):
        for k in DECISIONS + ("reconcile",):
            assert getattr(a, k) == getattr(b, k), (a.round, k)
        assert a.communication_cost == b.communication_cost
        assert a.load_std == pytest.approx(b.load_std, rel=1e-6)
    assert tfc.deployments == jfc.deployments and tfc.pods == jfc.pods


# ---------------- tests/test_reconcile.py: the k8s contract ----------------


def led_repairs_scope_to_service_without_pod_moves(P, reg):
    """A backend advertising ``supports_pod_moves = False`` (the k8s
    Deployment mechanism) gets Deployment-scoped repairs."""
    b, led, names = _setup_ledger(P, reg)
    moved = b.external_move_random(random.Random(3))
    led.observe(b.monitor(), service_names=names)
    assert led.drift_pods == 1

    class NoPodMoves:  # the k8s contract, sim-backed
        supports_pod_moves = False

        def apply_move(self, move):
            assert move.pod is None, "per-pod move reached a no-pod-move backend"
            return b.apply_move(move)

    class Boundary:
        raw_backend = NoPodMoves()

        def apply_move(self, move):
            return self.raw_backend.apply_move(move)

    issued = led.issue_repairs(Boundary(), budget=2)
    assert [r["pod"] for r in issued] == [moved["pod"]]
    out = led.observe(b.monitor(), service_names=names)
    assert out["divergences"] == [] and led.drift_pods == 0
    return {"moved": moved, "issued": issued, "intent": led.intent}


def led_advisory_move_override_adopted_not_drift(P, reg):
    """k8s echoes the advisory target at apply time; the scheduler's real
    pick shows at the next monitor and is adopted, never drift."""
    b, led, names = _setup_ledger(P, reg)
    pod, svc = b.monitor().pod_names[0], names[0]
    led.record_moves([(svc, pod, "rc3", "rc3", True)])
    b.apply_move(P.Move(service=svc, pod=pod, target_node="rc5"))
    out = led.observe(b.monitor(), service_names=names)
    assert out["divergences"] == [] and led.drift_pods == 0
    assert led.intent[pod] == "rc5"
    return {"out": out, "intent": led.intent}


def led_advisory_meta_survives_missing_debounce(P, reg):
    """An advisory pod absent for one snapshot (mid re-create) keeps its
    move meta through the debounce and is adopted where it lands."""
    b, led, names = _setup_ledger(P, reg)
    state = b.monitor()
    pod, svc = state.pod_names[0], names[0]
    led.record_moves([(svc, pod, "rc3", "rc3", True)])
    valid = arr(state.pod_valid).copy()
    valid[0] = False
    out = led.observe(P.put(state, pod_valid=valid), service_names=names)
    assert out["divergences"] == []
    b.apply_move(P.Move(service=svc, pod=pod, target_node="rc5"))
    out2 = led.observe(b.monitor(), service_names=names)
    assert out2["divergences"] == [] and led.drift_pods == 0 and led.intent[pod] == "rc5"
    return {"out": out2, "intent": led.intent}


def led_adopt_observed_rebases_every_diff(P, reg):
    """The advisory-backend mode: every diff adopts what it observes; a pod
    another actor moved is baseline, never charged or repaired."""
    b = backend(P)
    led = (P.rec.IntentLedger(RJAX_CFG(), registry=reg, adopt_observed=True) if P is RJAX
           else P.rec.IntentLedger(registry=reg, adopt_observed=True))
    names = b.comm_graph().names
    led.rebase(b.monitor(), service_names=names)
    moved = b.external_move_random(random.Random(3))
    out = led.observe(b.monitor(), service_names=names)
    assert out["divergences"] == [] and led.drift_pods == 0
    assert led.intent[moved["pod"]] == moved["to"]
    assert led.issue_repairs(None, budget=2) == []
    return {"moved": moved, "intent": led.intent}


def RJAX_CFG():
    from kubernetes_rescheduling_tpu.config import ReconcileConfig

    return ReconcileConfig()


LEDGER_CASES = [led_repairs_scope_to_service_without_pod_moves,
                led_advisory_move_override_adopted_not_drift,
                led_advisory_meta_survives_missing_debounce,
                led_adopt_observed_rebases_every_diff,
                ctl_advisory_override_is_not_drift]


@pytest.mark.parametrize("case", LEDGER_CASES, ids=[f.__name__ for f in LEDGER_CASES])
def test_k8s_reconcile_case_matches_jax(case):
    """tests/test_reconcile.py's cases of the k8s contract: the case's
    assertions hold in both packages, and its observations and counters are
    equal."""
    seen = []
    for P in (RJAX, RTORCH):
        reg = P.Registry()
        seen.append((case(P, reg), P.counters(reg)))
    assert seen[1] == seen[0]


def test_intents_carry_the_advisory_flag():
    """``move_intent``'s fifth element marks the advisory mechanism, as in
    the JAX package."""
    for mech, landed in (("affinityOnly", "n2"), ("affinityOnly", None), ("nodeName", "n2")):
        t = RTORCH.rec.move_intent(mech, "svc", "n1", landed, pod="p")
        j = RJAX.rec.move_intent(mech, "svc", "n1", landed, pod="p")
        assert t == j and len(t) == 5 and t[4] == (mech == "affinityOnly")
