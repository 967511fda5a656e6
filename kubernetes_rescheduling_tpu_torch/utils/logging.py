"""Structured logging — the port of
``kubernetes_rescheduling_tpu.utils.logging`` (pure host code).

One JSON object per event, to a file, a stream, or only the in-memory ring
of the newest ``max_records`` events (a controller logs one event per round
forever; the file and stream sinks see every event). Fleet mode shares one
ring across its tenants, with per-tenant fair shares and counted drops.
"""

from __future__ import annotations

import collections
import json
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, IO

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}


@dataclass
class StructuredLogger:
    """JSONL event logger with optional human-readable echo.

    In-memory retention is a RING buffer of the newest ``max_records``
    events (a long-running controller logs one event per round forever;
    an unbounded list was a slow leak). The file/stream sinks still see
    every event — only the in-process ``records`` view is capped.

    Fleet mode shares ONE ring across tenants, and a plain ring is
    unfair: one chatty tenant (a chaos soak's fault storm) silently
    evicts every other tenant's events, making a quiet tenant
    indistinguishable from an evicted one. Two fixes, both bounded:

    - every eviction of a TENANT-tagged event is counted
      (``fleet_events_dropped_total{reason}`` in the metrics registry
      plus the in-process :attr:`dropped_by_tenant` tally), so silence
      and eviction are distinguishable;
    - ``max_records_per_tenant`` (0 = off; the fleet loop sets a fair
      share) caps any one tenant's in-ring events — a tenant at its cap
      evicts its OWN oldest event (reason ``tenant_cap``), never
      another tenant's.

    File/stream sinks are unaffected — fairness governs only the
    in-memory ring the live ``/events`` endpoint serves.
    """

    name: str = "krt"
    path: str | Path | None = None
    stream: IO | None = None
    level: str = "info"
    echo: bool = False
    max_records: int = 4096
    max_records_per_tenant: int = 0
    registry: Any = None  # metric sink for drop counts (default registry
                          # when None — resolved lazily, import stays light)

    # the ring is an OrderedDict keyed by a monotone sequence id, with a
    # per-tenant deque of live seq ids: both eviction paths (global ring
    # capacity, per-tenant fair share) find and unlink their victim in
    # O(1) — a chatty tenant's fault storm must not turn the hot logging
    # path into a linear ring scan per event
    _records: "collections.OrderedDict" = field(default=None, repr=False)  # type: ignore[assignment]
    _seq: int = field(default=0, repr=False)
    _tenant_seqs: dict = field(default=None, repr=False)  # type: ignore[assignment]
    dropped_by_tenant: collections.Counter = field(
        default=None, repr=False  # type: ignore[assignment]
    )
    _lock: threading.Lock = field(default=None, repr=False)  # type: ignore[assignment]

    # distinct tenants the drop tally remembers before halving to its
    # top counts — tenant churn must not grow the process-lifetime
    # cached logger without bound (the watchdog/ring discipline)
    _DROP_TALLY_CAP = 1024

    def __post_init__(self) -> None:
        self._records = collections.OrderedDict()
        self._tenant_seqs = {}
        self.dropped_by_tenant = collections.Counter()
        # the multi-step ring mutation must be atomic: the pipelined loop
        # logs from its monitor thread (a bare deque.append was GIL-atomic;
        # this bookkeeping is not)
        self._lock = threading.Lock()

    def _count_drop(self, tenant: str, reason: str) -> None:
        self.dropped_by_tenant[tenant] += 1
        if len(self.dropped_by_tenant) > self._DROP_TALLY_CAP:
            self.dropped_by_tenant = collections.Counter(
                dict(
                    self.dropped_by_tenant.most_common(
                        self._DROP_TALLY_CAP // 2
                    )
                )
            )
        reg = self.registry
        if reg is None:
            from kubernetes_rescheduling_tpu_torch.telemetry.registry import (
                get_registry,
            )

            reg = get_registry()
        reg.counter(
            "fleet_events_dropped_total",
            "tenant-tagged events dropped from the shared in-memory "
            "event ring, by reason (ring_full = displaced at capacity; "
            "tenant_cap = the tenant hit its fair ring share and "
            "displaced its own oldest event) — tenant identity rides "
            "the logger's dropped_by_tenant tally, not a label key",
            labelnames=("reason",),
        ).labels(reason=reason).inc()

    def _remember(self, rec: dict) -> None:
        if self.max_records <= 0:
            # the historical deque(maxlen=0) contract: an in-memory
            # ring of zero keeps nothing (sinks still see every event)
            return
        tenant = rec.get("tenant")
        with self._lock:
            cap = self.max_records_per_tenant
            if tenant is not None and cap > 0:
                seqs = self._tenant_seqs.get(tenant)
                if seqs is not None and len(seqs) >= cap:
                    # fairness: a tenant at its ring share displaces its
                    # OWN oldest event, never another tenant's
                    self._records.pop(seqs.popleft(), None)
                    if not seqs:
                        del self._tenant_seqs[tenant]
                    self._count_drop(tenant, "tenant_cap")
            if len(self._records) >= self.max_records:
                old_seq, evicted = self._records.popitem(last=False)
                ev_tenant = evicted.get("tenant")
                if ev_tenant is not None:
                    seqs = self._tenant_seqs.get(ev_tenant)
                    # seq ids are globally monotone, so the ring's
                    # oldest entry is also its tenant's oldest live seq
                    if seqs and seqs[0] == old_seq:
                        seqs.popleft()
                        if not seqs:  # churn-proof: no residue deques
                            del self._tenant_seqs[ev_tenant]
                    self._count_drop(ev_tenant, "ring_full")
            self._seq += 1
            self._records[self._seq] = rec
            if tenant is not None:
                self._tenant_seqs.setdefault(
                    tenant, collections.deque()
                ).append(self._seq)

    def log(self, level: str, event: str, **fields: Any) -> None:
        if _LEVELS.get(level, 20) < _LEVELS.get(self.level, 20):
            return
        rec = {
            "ts": time.time(),
            "level": level,
            "logger": self.name,
            "event": event,
            **fields,
        }
        self._remember(rec)
        line = json.dumps(rec, default=float)
        if self.path is not None:
            p = Path(self.path)
            p.parent.mkdir(parents=True, exist_ok=True)
            with p.open("a") as f:
                f.write(line + "\n")
        out = self.stream or (sys.stderr if self.echo else None)
        if out is not None:
            out.write(line + "\n")

    def debug(self, event: str, **fields: Any) -> None:
        self.log("debug", event, **fields)

    def info(self, event: str, **fields: Any) -> None:
        self.log("info", event, **fields)

    def warn(self, event: str, **fields: Any) -> None:
        self.log("warn", event, **fields)

    def error(self, event: str, **fields: Any) -> None:
        self.log("error", event, **fields)

    @property
    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records.values())


_loggers: dict[str, StructuredLogger] = {}


def get_logger(name: str = "krt", **kwargs: Any) -> StructuredLogger:
    if name not in _loggers:
        _loggers[name] = StructuredLogger(name=name, **kwargs)
    return _loggers[name]
