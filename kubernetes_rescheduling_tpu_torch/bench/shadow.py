"""Shadow plane: score our recommendations against the recorded scheduler —
the port of ``kubernetes_rescheduling_tpu.bench.shadow``.

In shadow mode (``config.shadow`` / ``reschedule --shadow``) the normal
decisions run on each admitted snapshot of a replayed trace, and their
moves land in a shadow ledger instead of a cluster (``backends/replay.py``).
This module is the scoring half: a **counterfactual twin** — the admitted
snapshot's loads and capacities with ``pod_node`` replaced by OUR
cumulative placement (the trace's recorded placement plus every
recommendation issued so far) — evaluated by the same round-end metrics the
round already dispatches (``bench/round_end.py``), its result riding the
round's ONE ``round_end`` transfer: the plane adds a device piece to the
round's :class:`~bench.round_end.RoundCloser`, never a read of its own.

Per scored round the record grows a ``shadow`` block: cost and load spread
of the actual and the counterfactual placement, the delta, the running win
rate, and with attribution on the twin's attribution record (sum-consistent
like the actual one) plus per-edge deltas naming where we beat the recorded
scheduler. The gauges ``shadow_win_rate`` / ``shadow_cost_delta`` and the
counter ``shadow_rounds_total{outcome}`` publish the head-to-head; the
watchdog's ``shadow_win_rate`` rule (``slo_shadow_min_win_rate``) makes a
losing run a visible SLO.

Host-side identity is name-keyed (pods shift index between windows), and the
host arrays are the admission guard's already-pulled copies. A
recommendation re-homes its service's pods through a service → pods index
built once a round, so a global round's thousands of recommendations cost
one pass over the pod table, not one each.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch.bench.round_end import (
    METRIC_COST,
    METRIC_HEAD,
    METRIC_LOAD_STD,
    dispatch_round_end,
)
from kubernetes_rescheduling_tpu_torch.bench.reconcile import IntentLedger
from kubernetes_rescheduling_tpu_torch.core.state import UNASSIGNED
from kubernetes_rescheduling_tpu_torch.elastic.buckets import device_graph, device_view
from kubernetes_rescheduling_tpu_torch.telemetry import attribution as attribution_mod
from kubernetes_rescheduling_tpu_torch.telemetry.accounting import pull_arrays
from kubernetes_rescheduling_tpu_torch.telemetry.registry import get_registry

# the host read of a guard-less caller (device_transfers_total{site=...})
SHADOW_SITE = "shadow"

# edges reported in the per-round delta table (where we beat / lose)
_DELTA_EDGES = 8

_HOST_FIELDS = ("pod_valid", "pod_node", "pod_service", "node_valid")


class ShadowPlane:
    """Counterfactual twin + head-to-head accounting (one per run)."""

    def __init__(self, cfg, *, registry=None, logger=None) -> None:
        self.cfg = cfg
        self.registry = registry
        self.logger = logger
        # OUR cumulative placement: pod name -> node name (None =
        # unscheduled). Pods the controller never moved track the recorded
        # placement; ``_owned`` holds the pods a recommendation re-homed,
        # and only those keep our node through realignment
        self.twin: dict[str, str | None] = {}
        self._owned: set[str] = set()
        self.wins = 0
        self.scored = 0
        self.ledger: list[dict] = []  # per-round shadow blocks, in order
        self._svc_index_memo: tuple[tuple, dict] | None = None

    # ---- bookkeeping ----

    def _reg(self):
        return self.registry if self.registry is not None else get_registry()

    def _svc_index(self, graph) -> dict[str, int]:
        memo = self._svc_index_memo
        if memo is None or memo[0] is not graph.names:
            memo = (graph.names, {n: i for i, n in enumerate(graph.names)})
            self._svc_index_memo = memo
        return memo[1]

    def _host(self, state, arrays) -> dict:
        """The guard's host arrays, or for a guard-less caller one counted
        transfer of the four fields."""
        if arrays is not None:
            return arrays
        return pull_arrays({k: getattr(state, k) for k in _HOST_FIELDS}, SHADOW_SITE,
                           self.registry)

    @staticmethod
    def _observed(state, arrays) -> dict[str, str | None]:
        """pod name -> node name from one admitted snapshot: THE ledger's
        decode (``IntentLedger._observed``), shared so the reconcile plane's
        and the twin's views of the observed placement never drift apart."""
        return IntentLedger._observed(state, (), arrays)[0]

    def bind(self, state, graph, arrays=None) -> None:
        """Startup baseline: twin := the first admitted snapshot's recorded
        placement (we diverge only by recommending)."""
        self.twin = self._observed(state, self._host(state, arrays))

    # ---- per-round step ----

    def observe_round(self, rnd, record, state, graph, closer, *, arrays, fresh,
                      top_k) -> None:
        """Fold this round's recommendations into the twin and, on a fresh
        round, defer the counterfactual scoring onto the round's closer.

        Called AFTER the actual metrics piece is attached: decode order
        inside the single flush puts ``record.communication_cost`` on the
        record before the shadow decode compares against it. The host
        seconds of the realign and the re-homing land in
        ``record.phase_s["shadow"]``."""
        t0 = time.perf_counter()
        svc_index = self._svc_index(graph)
        arrays = self._host(state, arrays)
        if not fresh:
            # degraded round: no admitted snapshot to realign or score
            # against — recommendations still accumulate on the twin, keyed
            # by the carried snapshot's (unchanged) pod table
            self._rehome(state, arrays, svc_index, record.applied_moves)
            record.phase_s["shadow"] = time.perf_counter() - t0
            return
        pv = np.asarray(arrays["pod_valid"])
        if not bool(pv.any()):
            # a pods-free window (a machine-events-only stretch of a real
            # corpus): both placements cost 0 by vacuity, and scoring it
            # would credit a free win; no recommendation can exist either
            return

        obs = self._observed(state, arrays)
        # realign to this window's pod table: new and never-re-homed pods
        # track the recorded placement, vanished pods drop, and only pods a
        # recommendation re-homed keep our node. A recommended node that
        # since DIED in the trace releases ownership: the recorded
        # re-placement stands in for the rescheduling any scheduler must
        # then do
        nv = np.asarray(arrays["node_valid"])
        alive = {state.node_names[i] for i in np.flatnonzero(nv).tolist()
                 if i < len(state.node_names)}
        owned, twin = self._owned, self.twin

        def twin_node(name: str, observed_node: str | None) -> str | None:
            if name in owned:
                ours = twin.get(name, observed_node)
                if ours is None or ours in alive:
                    return ours
                owned.discard(name)
            return observed_node

        self.twin = {name: twin_node(name, node) for name, node in obs.items()}
        self._rehome(state, arrays, svc_index, record.applied_moves)

        # the counterfactual twin: this snapshot's loads under OUR cumulative
        # placement — the same tensors, pod_node swapped
        node_index = {n: i for i, n in enumerate(state.node_names)}
        twin_arr = np.array(np.asarray(arrays["pod_node"]), dtype=np.int32)
        pod_names = state.pod_names
        for i in np.flatnonzero(pv).tolist():
            if i >= len(pod_names):
                continue
            target = self.twin.get(pod_names[i])
            ti = node_index.get(target) if target is not None else None
            twin_arr[i] = ti if ti is not None else UNASSIGNED
        twin_state = state.replace(pod_node=torch.as_tensor(twin_arr, device=state.device))
        record.phase_s["shadow"] = time.perf_counter() - t0
        dev = dispatch_round_end(device_view(twin_state), device_graph(graph), top_k=top_k)
        ctx = {
            "node_names": state.node_names,
            "svc_names": graph.names,
            "num_nodes": state.num_nodes,
            "num_services": graph.num_services,
        }
        closer.defer(dev, lambda flat: self._score(rnd, record, ctx, top_k, flat))

    def _rehome(self, state, arrays, svc_index, applied_moves) -> None:
        """Apply the round's service-unit recommendations to the twin: every
        valid pod of a recommended service moves to its recommended node."""
        if not applied_moves:
            return
        pv = np.asarray(arrays["pod_valid"])
        ps = np.asarray(arrays["pod_service"])
        pod_names = state.pod_names
        idx = np.flatnonzero(pv)
        idx = idx[idx < len(pod_names)]
        pods_of: dict[int, list[int]] = {}
        for i, s in zip(idx.tolist(), ps[idx].tolist()):
            pods_of.setdefault(s, []).append(i)
        for service, landed in applied_moves:
            si = svc_index.get(service)
            for i in pods_of.get(si, ()) if si is not None else ():
                self.twin[pod_names[i]] = landed
                self._owned.add(pod_names[i])

    # ---- the flush-time decode ----

    def _score(self, rnd, record, ctx, top_k, flat) -> None:
        cost_shadow = float(flat[METRIC_COST])
        lstd_shadow = float(flat[METRIC_LOAD_STD])
        cost_actual = float(record.communication_cost)
        lstd_actual = float(record.load_std)
        delta = cost_actual - cost_shadow
        eps = 1e-6 * max(1.0, abs(cost_actual))
        win = cost_shadow <= cost_actual * (1.0 - self.cfg.win_margin) + eps
        self.scored += 1
        if win:
            self.wins += 1
        win_rate = self.wins / self.scored

        block: dict = {
            "round": rnd,
            "recommended": len(record.applied_moves),
            "cost_actual": cost_actual,
            "cost_shadow": cost_shadow,
            "cost_delta": delta,
            "load_std_actual": lstd_actual,
            "load_std_shadow": lstd_shadow,
            "win": bool(win),
            "wins": self.wins,
            "scored": self.scored,
            "win_rate": win_rate,
        }
        if top_k > 0:
            attr = attribution_mod.decode_attribution(
                flat[METRIC_HEAD:], node_names=ctx["node_names"],
                service_names=ctx["svc_names"], top_k=top_k, num_nodes=ctx["num_nodes"],
                num_services=ctx["num_services"],
            )
            block["attribution"] = attr
            if isinstance(record.attribution, dict):
                block["edges_delta"] = _edge_deltas(record.attribution, attr)
        record.shadow = block
        self.ledger.append(block)

        reg = self._reg()
        reg.gauge(
            "shadow_win_rate",
            "fraction of scored shadow rounds where the counterfactual placement's "
            "communication cost was at or below the real scheduler's (running, this run)",
        ).set(win_rate)
        reg.gauge(
            "shadow_cost_delta",
            "actual minus counterfactual communication cost of the most recent scored "
            "shadow round (positive = we beat the real scheduler)",
        ).set(delta)
        reg.counter(
            "shadow_rounds_total",
            "scored shadow rounds by head-to-head outcome against the trace's actual "
            "scheduler",
            labelnames=("outcome",),
        ).labels(outcome="win" if win else "loss").inc()
        if self.logger is not None:
            self.logger.info("shadow_round", round=rnd, cost_actual=cost_actual,
                             cost_shadow=cost_shadow, cost_delta=delta, win=bool(win),
                             win_rate=win_rate)


def _edge_deltas(actual: dict, shadow: dict) -> list[dict]:
    """Per-service-edge head-to-head: actual minus counterfactual cost for
    every edge either attribution recorded, best for us first. Only edges in
    a top-k are visible; the rest is in each attribution's ``tail``."""

    def by_pair(attr: dict) -> dict[tuple[str, str], float]:
        out: dict[tuple[str, str], float] = {}
        for e in attr.get("edges") or ():
            key = (e.get("src_service"), e.get("dst_service"))
            out[key] = out.get(key, 0.0) + float(e.get("cost", 0.0))
        return out

    a, s = by_pair(actual), by_pair(shadow)
    rows = [
        {
            "src_service": src,
            "dst_service": dst,
            "actual": a.get((src, dst), 0.0),
            "shadow": s.get((src, dst), 0.0),
            "delta": a.get((src, dst), 0.0) - s.get((src, dst), 0.0),
        }
        for src, dst in set(a) | set(s)
    ]
    rows.sort(key=lambda r: r["delta"], reverse=True)
    return rows[:_DELTA_EDGES]
