"""Flight recorder: a bounded ring of the last N rounds, dumped as a
self-contained diagnostics bundle when something goes wrong.

Per executed round the controller records a compact entry — snapshot
digest, the full ``RoundRecord`` dict (including its decision
explanations), the round's structured events, and the tail of recent
spans. On a trigger (circuit-breaker open, a crash escaping the loop, or
SIGUSR1) the ring plus a registry snapshot and a provenance manifest is
written as ONE JSON file an operator can ship — no access to the dead
process required. ``telemetry bundle <file>`` summarizes it, including
the explain-consistency verdict over every recorded decision.

Dumping is deliberately best-effort: a recorder failure must never take
down the loop it is there to diagnose (failures are logged and counted,
never raised). The port of ``kubernetes_rescheduling_tpu.telemetry.
flight_recorder``; the bundle's ``device_costs`` is the port's compiled-cost
book (``costmodel.py``).
"""

from __future__ import annotations

import collections
import hashlib
import json
import time
from pathlib import Path
from typing import Any

from kubernetes_rescheduling_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    get_registry,
)

BUNDLE_KIND = "flight_recorder_bundle"


def state_digest(state) -> str:
    """Short content hash of a snapshot's placement (pod→node + validity):
    two bundles with the same digest saw the same placement. Hashes
    ``pod_node`` as i32 and ``pod_valid`` as bool bytes, as the JAX package
    does, so the two digest the same placement alike. The read is one
    host copy of the two tensors (a sync on the card)."""
    import numpy as np
    import torch

    node = state.pod_node
    valid = state.pod_valid
    if isinstance(node, torch.Tensor):
        node, valid = (t.cpu().numpy() for t in torch.stack(
            [node.to(torch.int32), valid.to(torch.int32)]).unbind(0))
    h = hashlib.sha1()
    h.update(np.asarray(node, dtype=np.int32).tobytes())
    h.update(np.asarray(valid, dtype=np.bool_).tobytes())
    return h.hexdigest()[:16]


class FlightRecorder:
    def __init__(
        self,
        capacity: int = 16,
        *,
        bundle_dir: str | Path | None = None,
        registry: MetricsRegistry | None = None,
        logger=None,
        span_tail: int = 20,
    ) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.bundle_dir = Path(bundle_dir) if bundle_dir is not None else None
        self.registry = registry
        self.logger = logger
        self.span_tail = span_tail
        self._ring: collections.deque[dict[str, Any]] = collections.deque(
            maxlen=capacity
        )
        self._dump_seq = 0
        self.dumps: list[Path] = []

    def _reg(self) -> MetricsRegistry:
        return self.registry if self.registry is not None else get_registry()

    # ---- recording ----

    def record_round(
        self,
        *,
        round: int,
        digest: str | None = None,
        record: dict[str, Any] | None = None,
        events: list[dict[str, Any]] | None = None,
        spans: list[dict[str, Any]] | None = None,
    ) -> None:
        self._ring.append(
            {
                "round": round,
                "ts": time.time(),
                "digest": digest,
                "record": record,
                "events": list(events or ()),
                "spans": list(spans or ()),
            }
        )

    def record_skip(self, round: int, **fields: Any) -> None:
        self._ring.append(
            {"round": round, "ts": time.time(), "skipped": True, **fields}
        )

    @property
    def rounds(self) -> list[dict[str, Any]]:
        return list(self._ring)

    # ---- dumping ----

    def snapshot(self, reason: str, **fields: Any) -> dict[str, Any]:
        """The bundle object — self-contained: ring + metrics + manifest
        + the compiled-cost book (what the captured graphs in these rounds
        cost) + the attribution book (where the cost sat), even if the
        process dies before anyone scrapes /metrics."""
        from kubernetes_rescheduling_tpu_torch.telemetry.attribution import (
            get_attribution_book,
        )
        from kubernetes_rescheduling_tpu_torch.telemetry.costmodel import get_costbook
        from kubernetes_rescheduling_tpu_torch.telemetry.manifest import run_manifest

        return {
            "kind": BUNDLE_KIND,
            "reason": reason,
            "ts": time.time(),
            **fields,
            "rounds": self.rounds,
            "metrics": self._reg().snapshot(),
            "device_costs": get_costbook().as_dict(),
            "attribution": get_attribution_book().as_dict(),
            "manifest": run_manifest(),
        }

    def dump(
        self, reason: str, path: str | Path | None = None, **fields: Any
    ) -> Path | None:
        """Write a bundle; returns the path, or None when no destination
        is configured or the write failed (best-effort by contract)."""
        if path is None:
            if self.bundle_dir is None:
                return None
            self._dump_seq += 1
            path = self.bundle_dir / f"flight_{self._dump_seq:03d}_{reason}.json"
        p = Path(path)
        try:
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(
                json.dumps(self.snapshot(reason, **fields), default=str)
            )
        except Exception as e:  # noqa: BLE001 — diagnostics must not crash the loop
            if self.logger is not None:
                self.logger.error(
                    "flight_dump_failed", reason=reason, error=repr(e)
                )
            return None
        self._reg().counter(
            "flight_recorder_dumps_total",
            "flight-recorder bundles written",
            labelnames=("reason",),
        ).labels(reason=reason).inc()
        self.dumps.append(p)
        if self.logger is not None:
            self.logger.info("flight_dump", reason=reason, path=str(p))
        return p
