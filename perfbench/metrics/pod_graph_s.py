"""Seconds the port spent building pod replays' pod-level graphs in the
run, its set-up included: ``pod_graph_build_seconds_total`` (the graph,
its trace order and its call-pair index, once a pod set)."""

from kubernetes_rescheduling_tpu_torch.telemetry.registry import get_registry


def read(run):
    values = [r["value"] for r in get_registry().snapshot()
              if r["metric"] == "pod_graph_build_seconds_total"]
    return float(sum(values)) if values else None
