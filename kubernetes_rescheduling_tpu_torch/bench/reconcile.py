"""Intent reconciliation — the port of ``kubernetes_rescheduling_tpu.bench.reconcile``
(host code): the controller closes the loop on its own moves.

A lost move, a scheduler override or another actor's write (a second
scheduler, a human ``kubectl``) would otherwise stay invisible: the
boundary's ``landed`` return is only what the cluster claimed. The
**intent ledger**:

- records, after each round's applies, where every pod SHOULD be
  (:meth:`IntentLedger.record_moves`: the requested target plus what the
  boundary claimed);
- diffs the next admitted snapshot against that intent
  (:meth:`IntentLedger.observe`) and classifies each divergence:

  ========================  =====================================================
  ``wrong_node``            a PINNING move landed where the boundary said, which
                            was not where the controller aimed (a race).
                            Advisory moves (``affinityOnly``) record the landed
                            node as intent: a scheduler override is legitimate
                            placement, never charged or repaired
  ``lost_move``             the boundary reported success but the pod still sits
                            on its old node (an acknowledged-but-lost write)
  ``external_drift``        a pod moved with no move of ours in flight
  ``phantom_pod``           a pod in the snapshot that no intent explains
                            (debounced: two consecutive sightings, so one
                            lagging read never counts)
  ``missing_pod``           an intended pod absent from the snapshot (same
                            debounce)
  ``unknown_landing``       a move landed on a node the working snapshot does
                            not know (counted at apply time by the greedy
                            round, ``bench/controller.py``)
  ========================  =====================================================

  Churn events (``RoundRecord.churn``) are consumed FIRST: deploys,
  teardowns, autoscaling and node drain/add re-anchor the affected intent
  instead of reading as drift, and a pod whose intended node died or left
  the cluster is consumed as a node event, never charged.

- queues **rate-limited corrective moves** (:meth:`IntentLedger.issue_repairs`:
  pod-granular ``MoveRequest``s; the JAX package's Deployment-scoped ones,
  for a backend that cannot pin one replica, wait with the k8s backend,
  ROADMAP Queue 1 item 4) through the
  boundary's retry, breaker and budget, at most ``repair_budget_per_round``
  a round, until observed state converges back to intent. The pending
  repairs are the ``reconcile_drift_pods`` gauge.

The ledger is host-side; a diff reuses the admission guard's host arrays
or, with the guard off, reads the snapshot's fields in one counted
transfer (``site="reconcile"``). It persists through checkpoints
(:meth:`snapshot` / :meth:`restore`): a resumed controller reconciles its
restored intent against the first admitted snapshot instead of trusting
it blindly.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from kubernetes_rescheduling_tpu_torch.backends.base import MoveRequest
from kubernetes_rescheduling_tpu_torch.telemetry.accounting import pull_arrays
from kubernetes_rescheduling_tpu_torch.telemetry.registry import get_registry

RECONCILE_SITE = "reconcile"

KIND_WRONG_NODE = "wrong_node"
KIND_LOST_MOVE = "lost_move"
KIND_EXTERNAL_DRIFT = "external_drift"
KIND_PHANTOM_POD = "phantom_pod"
KIND_MISSING_POD = "missing_pod"
KIND_UNKNOWN_LANDING = "unknown_landing"

# sightings before a phantom/missing pod is charged: one absent-then-back
# snapshot is a lagging watch cache (a partial monitor),
# not a divergence
_DEBOUNCE = 2


def count_divergence(registry, kind: str) -> None:
    """THE ``reconcile_divergences_total`` declaration — the ledger and
    the greedy round's unknown-landing patch share it so the family can
    never fork."""
    reg = registry if registry is not None else get_registry()
    reg.counter(
        "reconcile_divergences_total",
        "intent-vs-observed divergences detected by the reconciliation "
        "plane, by kind",
        labelnames=("kind",),
    ).labels(kind=kind).inc()


def move_intent(
    mechanism: str,
    service: str,
    requested: str,
    landed: str | None,
    *,
    pod: str | None = None,
) -> tuple:
    """THE intent-capture rule for an applied move, ``(service, pod,
    intended, landed)``: under the advisory mechanism (``affinityOnly``)
    the scheduler's choice IS legitimate placement — intent adopts where
    the move landed; pinning mechanisms keep the requested target so an
    override reads as a ``wrong_node`` divergence. (The JAX package's
    fifth element, the advisory flag that adopts the node observed at the
    next diff, serves a backend that can only echo the advisory target —
    the k8s backend, ROADMAP Queue 1 item 4; the simulator reports where
    the move landed.)"""
    intended = landed if mechanism == "affinityOnly" and landed is not None else requested
    return (service, pod, intended, landed)


class IntentLedger:
    """Per-pod intended placement + divergence classification + repairs.

    One ledger per control loop (``tenant=None``) or per fleet tenant
    (``tenant=<name>``: the drift gauge is then the tenant-labeled
    ``fleet_reconcile_drift_pods``, published through ``tenant_series``,
    the fleet's cardinality gate, and the ledger's events carry the
    tenant). The JAX package's adopt-observed mode (its shadow plane's
    replay backend) waits with that plane (ROADMAP Queue 1 item 4).
    """

    def __init__(self, *, registry=None, logger=None, tenant=None, tenant_series=None):
        self.registry = registry
        self.logger = logger
        self.tenant = tenant
        self.tenant_series = tenant_series
        self.intent: dict[str, str | None] = {}  # pod name -> node name
        self.pod_service: dict[str, str] = {}
        # each service's pods in pod_service's order (record_moves' index),
        # built at first use after pod_service changed
        self._pods_of: dict[str, list[str]] | None = None
        # moves since the last observe: pod -> {service, requested,
        # landed, old} (what the boundary claimed, for classification)
        self.moves: dict[str, dict] = {}
        # pending corrective moves: pod -> {service, target, kind}
        self.repairs: dict[str, dict] = {}
        # churn events noted but not yet consumed by an observe(): a
        # degraded round has no admitted snapshot to diff, so its events
        # wait here for the next fresh diff (else a teardown applied on a
        # degraded round would read as missing pods two rounds later)
        self.pending_events: list[dict] = []
        self._phantom_streak: dict[str, int] = {}
        self._missing_streak: dict[str, int] = {}
        self._primed = False
        # recently diffed snapshot OBJECTS (identity ring): observe()
        # skips any of them — a fresh monitor always builds a new
        # object, so an already-seen one is a stale re-serve, not a new
        # read. A ring, not one slot: a stale monitor can re-serve
        # a snapshot from SEVERAL reads back when corrupt/partial rounds
        # sat in between (those aren't cached by the wrapper). Bounded,
        # and snapshots are small, so the held refs are negligible.
        self._recent_states: deque = deque(maxlen=8)

    # ---- bookkeeping ----

    def _reg(self):
        return self.registry if self.registry is not None else get_registry()

    def _set_gauge(self) -> None:
        reg = self._reg()
        if self.tenant is None:
            reg.gauge(
                "reconcile_drift_pods",
                "pods whose observed placement currently diverges from "
                "the controller's intent (corrective moves pending)",
            ).set(len(self.repairs))
            return
        series = self.tenant_series
        if series is None:
            from kubernetes_rescheduling_tpu_torch.telemetry.fleet_rollup import TenantSeries

            # ungated outside the fleet loop, built per call so it follows
            # the registry resolution of _reg()
            series = TenantSeries(reg, tenants=1, budget=None)
        series.gauge_set(
            "fleet_reconcile_drift_pods",
            "per-tenant pods whose observed placement currently diverges from that "
            "tenant's intent",
            self.tenant,
            len(self.repairs),
        )

    def _tagged(self, fields: dict) -> dict:
        return fields if self.tenant is None else {"tenant": self.tenant, **fields}

    @property
    def pending_repairs(self) -> bool:
        return bool(self.repairs)

    @property
    def drift_pods(self) -> int:
        return len(self.repairs)

    # ---- persistence (checkpoint extra) ----

    def snapshot(self) -> dict:
        """JSON-able intent for the checkpoint sidecar, in the JAX package's
        layout (the pending churn events included: a checkpoint taken on a
        degraded round must not lose the events its next diff consumes)."""
        return {
            "intent": dict(self.intent),
            "pod_service": dict(self.pod_service),
            "pending_events": [dict(e) for e in self.pending_events],
        }

    def restore(self, snap: dict | None) -> None:
        """Adopt a checkpointed intent: the next :meth:`observe` then
        reconciles the resumed cluster against it instead of trusting
        the first snapshot blindly."""
        if not snap or not snap.get("intent"):
            return
        self.intent = dict(snap["intent"])
        self.pod_service = dict(snap.get("pod_service") or {})
        self._pods_of = None
        self.pending_events = [dict(e) for e in snap.get("pending_events") or []]
        self._primed = True

    # ---- intent sources ----

    def _host(self, state, host_arrays=None) -> dict:
        """The snapshot's ``pod_valid`` / ``pod_node`` / ``pod_service`` /
        ``node_valid`` on the host: the admission guard's arrays when it
        admitted this very object, else one counted transfer."""
        if host_arrays is not None:
            return host_arrays
        return pull_arrays(
            {k: getattr(state, k) for k in ("pod_valid", "pod_node", "pod_service",
                                             "node_valid")},
            RECONCILE_SITE,
            self.registry,
        )

    @staticmethod
    def _observed(state, service_names, arrays) -> tuple[dict, dict]:
        """``pod name -> node name (None = unscheduled)`` plus the pod's
        service name, from one admitted snapshot's host arrays
        (:meth:`_host`)."""
        obs: dict[str, str | None] = {}
        svc_of: dict[str, str] = {}
        valid, nodes, svcs = arrays["pod_valid"], arrays["pod_node"], arrays["pod_service"]
        pod_names = state.pod_names
        node_names = state.node_names
        n_pod = len(pod_names)
        n_node = len(node_names)
        n_svc = len(service_names)
        vidx = np.flatnonzero(valid)
        # bulk tolist() beats per-element numpy scalar indexing by ~an
        # order of magnitude — this runs once per fresh round over every
        # valid pod, in the foreground close path
        for i, n, s in zip(
            vidx.tolist(),
            np.asarray(nodes)[vidx].tolist(),
            np.asarray(svcs)[vidx].tolist(),
        ):
            if i >= n_pod:
                continue
            name = pod_names[i]
            obs[name] = node_names[n] if 0 <= n < n_node else None
            if 0 <= s < n_svc:
                svc_of[name] = service_names[s]
        return obs, svc_of

    def rebase(self, state, *, service_names=(), host_arrays=None) -> None:
        """Intent := observed (startup baseline, or a wholesale
        re-anchor)."""
        self.intent, self.pod_service = self._observed(
            state, service_names, self._host(state, host_arrays))
        self._pods_of = None
        self.moves.clear()
        self.repairs.clear()
        self.pending_events.clear()
        self._phantom_streak.clear()
        self._missing_streak.clear()
        self._primed = True
        self._recent_states.append(state)
        self._set_gauge()

    def note_churn(self, events) -> None:
        """Queue churn events for the NEXT observe: the loop notes them every
        round, whether or not the round has an admitted snapshot."""
        self.pending_events.extend(events)

    def record_moves(self, intents) -> None:
        """One entry per boundary move this round:
        ``(service, pod | None, requested_node, landed_node)`` (as
        :func:`move_intent` builds it) — ``pod=None`` means the whole
        Deployment moved (the service-unit mechanisms), a name means one
        replica (pod mode / repairs). A failed move (``landed is None``)
        changes no intent."""
        for entry in intents:
            service, pod, requested, landed = entry
            if landed is None:
                continue
            pods = [pod] if pod is not None else self._service_pods().get(service, [])
            for p in pods:
                self.moves[p] = {
                    "service": service,
                    "requested": requested,
                    "landed": landed,
                    "old": self.intent.get(p),
                }
                self.intent[p] = requested
                # an explicit move supersedes any queued repair
                self.repairs.pop(p, None)
        self._set_gauge()

    # ---- the reconcile diff ----

    def observe(self, state, *, service_names=(), churn_events=(), host_arrays=None) -> dict:
        """Diff one admitted snapshot against intent: classify + count
        divergences, queue corrective moves, return the round's
        ``reconcile`` payload piece (``{"divergences": [...]}``).

        Churn events come from ``churn_events`` plus anything queued with
        :meth:`note_churn` (consumed here either way).

        ``host_arrays`` lets the admission guard hand over the snapshot fields it already
        pulled for THIS state object (``AdmissionGuard.host_arrays``) so
        the hot monitor path pays one device->host transfer, not two."""
        if not self._primed:
            self.rebase(state, service_names=service_names)
            return {"divergences": []}
        if any(s is state for s in self._recent_states):
            # an already-diffed snapshot OBJECT: a stale monitor
            # re-serving an earlier read (possibly from several reads
            # back) carries no new observation — re-diffing it would
            # misread every in-flight move as lost (the pre-move
            # placement shows again) and rewind confirmed moves into
            # phantom drift. Moves and pending churn stay queued for the
            # next genuinely fresh diff. (A live API serving stale
            # DATA in a fresh object is undetectable here by
            # construction — that is what the debounce and the repair
            # loop's convergence absorb.)
            return {"divergences": []}

        host = self._host(state, host_arrays)
        node_valid = host["node_valid"]
        obs, svc_of = self._observed(state, service_names, host)
        events = (*self.pending_events, *churn_events)
        self.pending_events = []
        ev_services: set[str] = set()
        ev_nodes: set[str] = set()
        for ev in events:
            kind = ev.get("kind")
            if kind in ("service_deploy", "service_teardown", "replica_scale"):
                if ev.get("service"):
                    ev_services.add(ev["service"])
            elif kind in ("node_drain", "node_add"):
                if ev.get("node"):
                    ev_nodes.add(ev["node"])
            elif kind == "spot_preemption":
                ev_nodes.update(ev.get("nodes") or ())
        known_nodes = set(state.node_names)
        alive = {
            state.node_names[int(i)]
            for i in np.flatnonzero(node_valid)
            if int(i) < len(state.node_names)
        }

        moves, self.moves = self.moves, {}
        divergences: list[dict] = []

        def diverge(kind: str, pod: str, expected, observed) -> None:
            d = {
                "kind": kind,
                "pod": pod,
                "service": self.pod_service.get(pod) or svc_of.get(pod),
                "expected": expected,
                "observed": observed,
            }
            divergences.append(d)
            count_divergence(self.registry, kind)
            if self.logger is not None:
                self.logger.warn("reconcile_divergence", **self._tagged(d))

        for pod, expected in list(self.intent.items()):
            service = self.pod_service.get(pod)
            if pod not in obs:
                # gone from the snapshot: a teardown or scale-down (churn
                # events) and node events consume; a lagging watch cache gets
                # one round of grace (debounce); anything left is a missing
                # pod — counted once, then re-anchored
                if service in ev_services or expected in ev_nodes:
                    self._drop(pod)
                    continue
                streak = self._missing_streak.get(pod, 0) + 1
                if streak < _DEBOUNCE:
                    self._missing_streak[pod] = streak
                    if pod in moves:
                        # the deferred diff still needs this move's meta
                        # (the true old node): without it a debounced
                        # pod's lost move would read as drift instead of
                        # lost_move
                        self.moves[pod] = moves[pod]
                    continue
                diverge(KIND_MISSING_POD, pod, expected, None)
                self._drop(pod)
                continue
            self._missing_streak.pop(pod, None)
            observed = obs[pod]
            if observed == expected:
                self.repairs.pop(pod, None)  # converged (repair landed)
                continue
            meta = moves.get(pod)
            if observed is None:
                if expected is None or expected not in alive:
                    # evicted by a node death the snapshot itself shows —
                    # consumed, adopt the unscheduled state as intent
                    self.intent[pod] = None
                    self.repairs.pop(pod, None)
                    continue
                kind = KIND_EXTERNAL_DRIFT  # unscheduled under a live node
            elif (
                meta is not None
                and observed == meta.get("landed")
                and meta.get("landed") != meta.get("requested")
            ):
                kind = KIND_WRONG_NODE
            elif meta is not None and observed == meta.get("old"):
                kind = KIND_LOST_MOVE
            elif expected not in known_nodes or expected not in alive:
                # the intended node left the cluster (or died) and the
                # scheduler re-placed the pod — a node event, not drift
                self.intent[pod] = observed
                self.repairs.pop(pod, None)
                continue
            elif service in ev_services or observed in ev_nodes:
                # churn re-placed it (a deploy wave, a drain's rescheduling)
                self.intent[pod] = observed
                self.repairs.pop(pod, None)
                continue
            else:
                kind = KIND_EXTERNAL_DRIFT
            rep = self.repairs.get(pod)
            if (
                rep is not None
                and observed == rep.get("from")
                and expected == rep.get("target")
            ):
                # the SAME divergence, already counted, still awaiting
                # repair budget (or running detect-and-count-only) — one
                # fault, one count, and the queued repair keeps the kind
                # it was classified with (by now the in-flight move meta
                # is gone, so re-classifying here would mislabel it
                # external_drift)
                continue
            diverge(kind, pod, expected, observed)
            svc = service or svc_of.get(pod)
            # a repair needs a live target and a resolvable service name
            # (the boundary's MoveRequest is service-scoped even for a
            # single replica); anything else stays detect-and-count
            if expected is not None and expected in alive and svc:
                self.repairs[pod] = {
                    "service": svc,
                    "pod": pod,
                    "target": expected,
                    "kind": kind,
                    # where the pod actually sits — the repair move's true
                    # "old" (intent already equals the target, so without
                    # this a LOST repair would re-classify as
                    # external_drift instead of lost_move on every retry)
                    "from": observed,
                }

        for pod, observed in obs.items():
            if pod in self.intent:
                continue
            service = svc_of.get(pod)
            if service in ev_services or observed in ev_nodes:
                self._adopt(pod, observed, service)
                continue
            streak = self._phantom_streak.get(pod, 0) + 1
            if streak < _DEBOUNCE:
                self._phantom_streak[pod] = streak
                continue
            diverge(KIND_PHANTOM_POD, pod, None, observed)
            self._adopt(pod, observed, service)

        # streaks only survive while their condition persists
        self._phantom_streak = {
            p: s for p, s in self._phantom_streak.items()
            if p in obs and p not in self.intent
        }
        self._missing_streak = {
            p: s for p, s in self._missing_streak.items() if p not in obs
        }
        self._recent_states.append(state)
        self._set_gauge()
        return {"divergences": divergences}

    def _service_pods(self) -> dict[str, list[str]]:
        """Each service's pods, in pod_service's order: a global round
        records one Deployment move per service, and a scan of every pod
        per move is O(services x pods)."""
        if self._pods_of is None:
            pods_of: dict[str, list[str]] = {}
            for p, s in self.pod_service.items():
                pods_of.setdefault(s, []).append(p)
            self._pods_of = pods_of
        return self._pods_of

    def _drop(self, pod: str) -> None:
        self.intent.pop(pod, None)
        self.pod_service.pop(pod, None)
        self._pods_of = None
        self.repairs.pop(pod, None)
        self._missing_streak.pop(pod, None)

    def _adopt(self, pod: str, node, service) -> None:
        self.intent[pod] = node
        if service is not None:
            self.pod_service[pod] = service
            self._pods_of = None
        self._phantom_streak.pop(pod, None)

    # ---- corrective moves ----

    def issue_repairs(self, boundary, budget: int) -> list[dict]:
        """Issue up to ``budget`` corrective moves through the boundary
        (retry/breaker/failure budget all apply — a repair is a move
        like any other), each pinning one pod. Issued repairs leave the
        queue and are re-recorded as intent, so the next :meth:`observe` either sees
        convergence or re-detects and re-queues; a boundary-failed repair
        re-queues immediately. ``budget == 0`` disables repairs (detect
        and count only). Returns the issued repair dicts (with their
        ``landed`` outcome) for the round record."""
        if budget <= 0 or not self.repairs:
            return []
        issued: list[dict] = []
        for pod in list(self.repairs):
            if len(issued) >= budget:
                break
            rep = self.repairs.pop(pod)
            landed = boundary.apply_move(
                MoveRequest(
                    service=rep["service"] or "",
                    pod=pod,
                    target_node=rep["target"],
                    # a corrective move PINS: the whole point is landing
                    # exactly where the intent says
                    mechanism="nodeName",
                )
            )
            out = {**rep, "landed": landed}
            issued.append(out)
            if landed is not None:
                # counted only when the move actually went out: a frozen
                # boundary returning None re-queues the SAME repair — one
                # convergence-comparable count, not one per retry round
                self._reg().counter(
                    "reconcile_repair_moves_total",
                    "corrective moves applied by the reconciliation "
                    "plane to converge observed placement back to "
                    "intent, by the divergence kind they repair",
                    labelnames=("kind",),
                ).labels(kind=rep["kind"]).inc()
                self.record_moves([(rep["service"], pod, rep["target"], landed)])
                if rep.get("from") is not None and pod in self.moves:
                    # record_moves captured old=intent (== the repair
                    # target); the classifying diff needs the node the
                    # pod REALLY came from, so a swallowed repair reads
                    # as the lost_move it is
                    self.moves[pod]["old"] = rep["from"]
            else:
                # boundary failure (or frozen moves): keep the debt
                self.repairs[pod] = rep
            if self.logger is not None:
                self.logger.info("reconcile_repair", **self._tagged(out))
        self._set_gauge()
        return issued


def reconcile_round_block(
    guard,
    ledger,
    *,
    state,
    service_names,
    churn_events=(),
    fresh: bool,
    last_drift: int,
    boundary,
    repair_budget: int,
) -> tuple[dict | None, int]:
    """One round of the reconciliation plane:

    - the admission guard's per-round counts always ride the block;
    - churn events are NOTED every round — a degraded round (``fresh=False``)
      has no admitted snapshot to diff, so its events wait in the ledger for
      the next fresh observe (legitimate churn never reads as phantom or
      missing pods);
    - a fresh round diffs observed vs intent (reusing the guard's
      already-pulled host arrays — no second transfer) and issues
      rate-limited repairs through the boundary;
    - the round drift RESOLVED on still carries an explicit
      ``drift_pods=0``: a reader that judges the latest round with
      reconcile data must see the recovery, not silence.

    Returns ``(record.reconcile payload | None, new last_drift)``.
    """
    block: dict = {}
    if guard is not None:
        adm = guard.take_info()
        if adm:
            block["admission"] = adm
    drift = last_drift
    if ledger is not None:
        ledger.note_churn(churn_events)
        if fresh:
            diff = ledger.observe(
                state,
                service_names=service_names,
                host_arrays=(
                    guard.host_arrays(state) if guard is not None else None
                ),
            )
            if diff["divergences"]:
                block["divergences"] = diff["divergences"]
            repairs = ledger.issue_repairs(boundary, repair_budget)
            if repairs:
                block["repairs"] = repairs
        drift = ledger.drift_pods
        if block or drift or last_drift:
            block["drift_pods"] = drift
    return (block or None), drift
