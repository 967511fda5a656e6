"""Snapshot admission — the port of
``kubernetes_rescheduling_tpu.bench.admission`` (host code).

Every ``boundary.monitor()`` result the control loop consumes passes an
:class:`AdmissionGuard` before it can touch device state (the runtime's
``monitor_admitted`` is the loop's only call of ``boundary.monitor()``).
One NaN, Inf or negative load would otherwise poison the solver's scores,
the metrics and the intent ledger without a word (NaN compares false
everywhere). The guard sorts every snapshot into one of three outcomes:

- **admit unchanged**: a snapshot with nothing wrong is returned AS THE
  SAME OBJECT, so a fault-free run is bit-identical to a run without the
  guard;
- **repair and admit**: non-finite or negative readings are replaced with
  the pod's or node's LAST-GOOD value (matched by name across snapshots; 0
  for a never-seen entry), and readings above any node's capacity are
  clamped to it, each counted in ``admission_quarantined_total{field,reason}``;
- **reject**: duplicate pod names among valid pods, pod→node references
  outside the node table, or more than ``max_quarantine_frac`` of the
  valid pods needing repair. A rejection returns ``None`` (the boundary's
  failure signal) and charges the boundary (``on_reject``), so the round
  degrades on the last good snapshot; counted
  ``admission_rejected_total{reason}``.

The guard reads every field it classifies in ONE counted transfer per
admit (``device_transfers_total{site="admission"}``) and hands the
identity fields to the intent ledger (:meth:`AdmissionGuard.host_arrays`),
so the ledger's diff needs no transfer of its own.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch.core.state import UNASSIGNED, ClusterState
from kubernetes_rescheduling_tpu_torch.telemetry.accounting import pull_arrays
from kubernetes_rescheduling_tpu_torch.telemetry.registry import get_registry

ADMISSION_SITE = "admission"

# snapshot fields the guard quarantines per entry, with their entity axis
POD_FIELDS = ("pod_cpu", "pod_mem")
NODE_FIELDS = ("node_cpu_cap", "node_mem_cap", "node_base_cpu", "node_base_mem")

# classification reasons (the `reason` label values)
REASON_NAN = "nan"
REASON_INF = "inf"
REASON_NEGATIVE = "negative"
REASON_OVER_CAPACITY = "over_capacity"

REJECT_DUPLICATE_POD = "duplicate_pod"
REJECT_UNKNOWN_NODE = "unknown_node"
REJECT_QUARANTINE_OVERFLOW = "quarantine_overflow"


class AdmissionGuard:
    """Classify-and-handle for monitor snapshots (see module docstring).

    One guard per control loop: it carries the last-good per-pod/per-node
    readings the quarantine path reuses, and accumulates per-round counts
    for ``RoundRecord.reconcile`` via :meth:`take_info`.
    ``max_quarantine_frac`` is the share of valid pods past which a
    snapshot is rejected whole. A loop without admission has no guard
    (``reconcile_admission=False``). ``on_reject(reason)`` — typically
    ``BoundaryClient.admission_reject`` — charges a rejection to the
    boundary's failure machinery.
    """

    def __init__(
        self,
        *,
        max_quarantine_frac: float = 0.5,
        registry=None,
        logger=None,
        on_reject: Callable[[str], None] | None = None,
    ) -> None:
        self.max_quarantine_frac = max_quarantine_frac
        self.registry = registry
        self.logger = logger
        self.on_reject = on_reject
        # last-good readings: the previous ADMITTED snapshot's arrays plus
        # a lazily built name→index map (names are the stable identity —
        # pod tables shift index under churn). Stored as arrays, not a
        # per-entry dict, so the clean path costs O(1) python per admit.
        self._last_pod: tuple[tuple, np.ndarray, dict[str, np.ndarray]] | None = None
        self._last_node: tuple[tuple, np.ndarray, dict[str, np.ndarray]] | None = None
        self._pod_index: dict[str, int] | None = None
        self._node_index: dict[str, int] | None = None
        # duplicate-name memo, keyed by names-tuple identity (static
        # between churn waves): duplicates among VALID pods require
        # duplicates in the full tuple, so a unique tuple lets every
        # admit skip the per-valid-pod scan entirely
        self._names_dup: tuple[tuple, bool] | None = None
        # counts since the last take_info(), keyed "field:reason" /
        # "rejected:reason" — the per-round record payload
        self._info: dict[str, int] = {}
        # the last ADMITTED snapshot object and the host arrays already
        # pulled for it — the intent ledger's observe() reuses them
        # (host_arrays) instead of paying a second device->host transfer
        # for the same snapshot in the same round
        self._admitted: tuple[object, dict[str, np.ndarray]] | None = None

    # ---- bookkeeping ----

    def _reg(self):
        return self.registry if self.registry is not None else get_registry()

    def _quarantine_count(self, field: str, reason: str, n: int) -> None:
        if n <= 0:
            return
        self._reg().counter(
            "admission_quarantined_total",
            "snapshot readings repaired by the admission guard "
            "(last-good reuse or capacity clamp), by field and reason",
            labelnames=("field", "reason"),
        ).labels(field=field, reason=reason).inc(n)
        key = f"{field}:{reason}"
        self._info[key] = self._info.get(key, 0) + n

    def _reject(self, reason: str, **detail) -> None:
        self._reg().counter(
            "admission_rejected_total",
            "monitor snapshots rejected whole by the admission guard "
            "(the round degrades on the last good snapshot)",
            labelnames=("reason",),
        ).labels(reason=reason).inc()
        key = f"rejected:{reason}"
        self._info[key] = self._info.get(key, 0) + 1
        if self.logger is not None:
            self.logger.warn("admission_reject", reason=reason, **detail)
        if self.on_reject is not None:
            self.on_reject(reason)

    def take_info(self) -> dict[str, int]:
        """Counts accumulated since the last call (the round's
        ``reconcile["admission"]`` payload); empty dict when clean."""
        info, self._info = self._info, {}
        return info

    # ---- last-good lookup (name-keyed across snapshots) ----

    def _last_good(self, kind: str, name: str | None, field: str) -> float:
        """The previous admitted snapshot's reading for this pod/node, 0.0
        for a never-seen (or then-invalid) entry."""
        stored = self._last_pod if kind == "pod" else self._last_node
        if stored is None or name is None:
            return 0.0
        names, valid, arrays = stored
        index = self._pod_index if kind == "pod" else self._node_index
        if index is None:
            index = {n: i for i, n in enumerate(names)}
            if kind == "pod":
                self._pod_index = index
            else:
                self._node_index = index
        i = index.get(name)
        if i is None or i >= len(valid) or not bool(valid[i]):
            return 0.0
        return float(arrays[field][i])

    # ---- the guard ----

    def admit(self, state: ClusterState | None) -> ClusterState | None:
        """Classify one monitor result. ``None`` passes through (the
        boundary already charged that failure); a clean snapshot returns
        IDENTICALLY (same object — the bit-identity contract); a
        repairable one returns a patched copy; a structurally broken one
        returns ``None`` after charging the boundary."""
        if state is None:
            return state

        # ONE counted transfer for everything the guard classifies
        host = pull_arrays(
            {
                "pod_valid": state.pod_valid,
                "pod_node": state.pod_node,
                # pod_service rides the same transfer for the intent
                # ledger's observe() (see host_arrays), not for admission
                "pod_service": state.pod_service,
                "node_valid": state.node_valid,
                **{f: getattr(state, f) for f in POD_FIELDS + NODE_FIELDS},
            },
            ADMISSION_SITE,
            self.registry,
        )
        pod_valid = host["pod_valid"]
        vidx = np.flatnonzero(pod_valid)
        pod_names = state.pod_names

        # structural rejects first: no per-entry repair can fix identity.
        # The per-valid-pod scan only runs when the (memoized) full names
        # tuple actually contains duplicates — the clean path stays O(1)
        # python here
        if self._names_dup is None or self._names_dup[0] is not pod_names:
            self._names_dup = (
                pod_names, len(pod_names) != len(set(pod_names))
            )
        if self._names_dup[1]:
            names_at = [
                pod_names[int(i)] for i in vidx if int(i) < len(pod_names)
            ]
            if len(names_at) != len(set(names_at)):  # name the culprit
                seen: set[str] = set()
                for name in names_at:
                    if name in seen:
                        self._reject(REJECT_DUPLICATE_POD, pod=name)
                        return None
                    seen.add(name)
        pod_node = host["pod_node"]
        if vidx.size:
            refs = pod_node[vidx]
            # the node TABLE is the name tuple — bucketed capacity pads
            # node arrays beyond it, and a ref into a padded slot is as
            # unknown as one past the array (no such node exists to name)
            n_known = len(state.node_names)
            bad_refs = (refs >= n_known) | (refs < UNASSIGNED)
            if bool(np.any(bad_refs)):
                bad = vidx[bad_refs]
                self._reject(
                    REJECT_UNKNOWN_NODE,
                    pods=[
                        pod_names[int(i)] if int(i) < len(pod_names) else int(i)
                        for i in bad[:4]
                    ],
                )
                return None

        node_valid = host["node_valid"]
        node_names = state.node_names

        # plan every repair BEFORE applying any: the overflow check must
        # see the whole damage picture, and a rejected snapshot must not
        # have half-counted quarantines
        repairs: dict[str, np.ndarray] = {}
        planned: list[tuple[str, str, int]] = []  # (field, reason, count)
        quarantined_pods: set[int] = set()

        def plan_node_field(field: str) -> np.ndarray:
            # classify on the pulled array; copy ONLY when repairing —
            # the clean path must not memcpy every field every monitor
            src = host[field]
            bad = node_valid & (~np.isfinite(src) | (src < 0.0))
            if not bool(bad.any()):
                return src
            arr = np.array(src)
            for reason, mask in (
                (REASON_NAN, np.isnan(arr)),
                (REASON_INF, np.isinf(arr)),
                (REASON_NEGATIVE, np.isfinite(arr) & (arr < 0.0)),
            ):
                n = int((bad & mask).sum())
                if n:
                    planned.append((field, reason, n))
            for i in np.flatnonzero(bad):
                name = node_names[int(i)] if int(i) < len(node_names) else None
                arr[i] = self._last_good("node", name, field)
            repairs[field] = arr
            return arr

        node_arrays = {f: plan_node_field(f) for f in NODE_FIELDS}

        # the physical ceilings an honest reading cannot exceed: one pod
        # cannot use more than the biggest node's whole capacity
        alive = node_valid & (node_arrays["node_cpu_cap"] > 0)
        cpu_ceiling = float(
            np.max(node_arrays["node_cpu_cap"][alive], initial=0.0)
        )
        mem_ceiling = float(
            np.max(
                node_arrays["node_mem_cap"][
                    node_valid & (node_arrays["node_mem_cap"] > 0)
                ],
                initial=0.0,
            )
        )
        ceilings = {"pod_cpu": cpu_ceiling, "pod_mem": mem_ceiling}

        def plan_pod_field(field: str) -> None:
            # same clean-path contract as plan_node_field: classify on
            # the pulled array, copy only when something needs repair
            src = host[field]
            nan = pod_valid & np.isnan(src)
            inf = pod_valid & np.isinf(src)
            neg = pod_valid & np.isfinite(src) & (src < 0.0)
            ceiling = ceilings[field]
            over = (
                pod_valid
                & np.isfinite(src)
                & (src >= 0.0)
                & (src > ceiling)
                if ceiling > 0
                else np.zeros_like(pod_valid)
            )
            if not bool((nan | inf | neg | over).any()):
                return
            arr = np.array(src)
            for reason, mask in (
                (REASON_NAN, nan),
                (REASON_INF, inf),
                (REASON_NEGATIVE, neg),
            ):
                n = int(mask.sum())
                if n:
                    planned.append((field, reason, n))
                for i in np.flatnonzero(mask):
                    name = (
                        pod_names[int(i)] if int(i) < len(pod_names) else None
                    )
                    good = self._last_good("pod", name, field)
                    if ceiling > 0.0 and good > ceiling:
                        # last-good was admitted under a LARGER node pool
                        # (churn since shrank the ceiling): the
                        # replacement must honor the same over-capacity
                        # invariant raw readings do. Still one reading,
                        # one count — under its nan/inf/negative reason
                        good = ceiling
                    arr[i] = good
                    quarantined_pods.add(int(i))
            n_over = int(over.sum())
            if n_over:
                planned.append((field, REASON_OVER_CAPACITY, n_over))
                arr[over] = ceiling
                quarantined_pods.update(int(i) for i in np.flatnonzero(over))
            repairs[field] = arr

        for f in POD_FIELDS:
            plan_pod_field(f)

        if quarantined_pods and vidx.size:
            frac = len(quarantined_pods) / float(vidx.size)
            if frac > self.max_quarantine_frac:
                # a mostly-fabricated metrics wave: repairing it
                # entry-by-entry would launder garbage into 'last good'
                self._reject(
                    REJECT_QUARANTINE_OVERFLOW,
                    quarantined=len(quarantined_pods),
                    valid_pods=int(vidx.size),
                    frac=round(frac, 4),
                )
                return None

        if repairs:
            for field, reason, n in planned:
                self._quarantine_count(field, reason, n)
            if self.logger is not None:
                self.logger.warn(
                    "admission_quarantine",
                    repaired={f"{f}:{r}": n for f, r, n in planned},
                )
            state = state.replace(**{
                f: torch.as_tensor(arr, device=state.device) for f, arr in repairs.items()
            })

        # last-good refreshes from the ADMITTED (post-repair) values —
        # quarantine replacements are by construction values that
        # themselves passed admission — reusing the host arrays already
        # pulled above (repaired fields substitute their patched copy)
        self._remember(
            state, host["pod_valid"], host["node_valid"],
            {f: repairs.get(f, host[f]) for f in POD_FIELDS + NODE_FIELDS},
        )
        # identity fields are never repaired, so the pulled arrays stay
        # valid for the (possibly replaced) admitted object
        self._admitted = (
            state,
            {
                k: host[k]
                for k in ("pod_valid", "pod_node", "pod_service", "node_valid")
            },
        )
        return state

    def host_arrays(self, state) -> dict[str, np.ndarray] | None:
        """The host copies of ``pod_valid``/``pod_node``/``pod_service``/
        ``node_valid`` pulled when ``state`` was admitted — ``None``
        unless ``state`` IS (object identity) the last admitted snapshot,
        so a stale or device-side-mutated state can never match."""
        if self._admitted is not None and self._admitted[0] is state:
            return self._admitted[1]
        return None

    def _remember(
        self,
        state: ClusterState,
        pod_valid: np.ndarray,
        node_valid: np.ndarray,
        arrays: dict[str, np.ndarray],
    ) -> None:
        """Store the admitted snapshot's host arrays as last-good. O(1)
        python: arrays are stored as-is, the name→index maps rebuild
        lazily and only when the name tuples actually change identity
        (they are static between churn waves)."""
        if self._last_pod is None or self._last_pod[0] is not state.pod_names:
            self._pod_index = None
        self._last_pod = (
            state.pod_names,
            pod_valid,
            {f: arrays[f] for f in POD_FIELDS},
        )
        if (
            self._last_node is None
            or self._last_node[0] is not state.node_names
        ):
            self._node_index = None
        self._last_node = (
            state.node_names,
            node_valid,
            {f: arrays[f] for f in NODE_FIELDS},
        )
