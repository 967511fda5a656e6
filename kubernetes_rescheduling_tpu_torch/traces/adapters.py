"""Adapters: external trace layouts → the native ``ClusterTrace`` form — the
port of ``kubernetes_rescheduling_tpu.traces.adapters``.

- **Alibaba cluster-trace-style** (Lu et al., IEEE CAL'17; the
  cluster-trace-v2018 table shapes): a machine table and a container table,
  both timestamped CSVs::

      machines:   machine_id,time_stamp,cpu_num,mem_size,status
      containers: container_id,machine_id,time_stamp,app_du,cpu_request,
                  cpu_util_percent,mem_size

  ``cpu_num`` / ``cpu_request`` in cores, ``mem_size`` in GB,
  ``cpu_util_percent`` of the container's request. ``app_du`` (the
  deployment unit) is the service; ``status`` other than ``USING`` marks
  the machine dead.

- **Borg-ClusterData-style** (Verma et al., EuroSys'15; the Google
  clusterdata-2011 table shapes, headered)::

      machine_events: time,machine_id,event_type,cpus,memory
      task_usage:     start_time,end_time,job_id,task_index,machine_id,
                      cpu_rate,canonical_memory_usage

  Capacities and usage are normalized; ``cpu_unit_m`` / ``mem_unit_b``
  scale them. ``event_type`` 1 (REMOVE) marks the machine dead. Pod =
  ``j<job>-<task_index>``, service = ``j<job>``.

- **the loop's own rounds.jsonl** (:func:`rounds_to_trace`): per-node
  traffic shares (the attribution's ingress + egress) as node-usage
  records, in traffic-share units (the source tag says so), plus one
  ``placement`` event per applied move. It carries no pod records, so it
  is input for the schema tooling, not for replay.

Malformed CSV rows are quarantined and counted through the corpus counter
(``trace_rows_quarantined_total{reason}``), like native rows.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Iterable

from kubernetes_rescheduling_tpu_torch.traces.corpus import (
    REASON_MISSING_FIELD,
    ClusterTrace,
    count_quarantine,
    load_trace_jsonl,
)

GB = float(1024**3)


def _read_csv(path: str | Path) -> list[dict]:
    with Path(path).open(newline="") as f:
        return list(csv.DictReader(f))


def _f(row: dict, key: str) -> float:
    """Float field; raises KeyError / ValueError for the caller's
    quarantine accounting."""
    v = row.get(key)
    if v is None or v == "":
        raise KeyError(key)
    return float(v)


def _sorted_records(records: list[dict]) -> list[dict]:
    """Stable sort by timestamp (the schema's monotonicity); within a
    timestamp node records precede edges, pods and placements (capacity
    before usage), input order kept otherwise."""
    kind_rank = {"node": 0, "edge": 1, "pod": 2, "placement": 3}
    return sorted(records, key=lambda r: (r["t"], kind_rank.get(r["kind"], 9)))


class _Quarantine:
    """One adapter's bad-row tally: every malformed row is a
    ``missing_field`` row, counted in the trace and the registry."""

    def __init__(self, registry) -> None:
        self.registry = registry
        self.counts: dict[str, int] = {}

    def __call__(self) -> None:
        self.counts[REASON_MISSING_FIELD] = self.counts.get(REASON_MISSING_FIELD, 0) + 1
        count_quarantine(self.registry, REASON_MISSING_FIELD)


def load_alibaba_csv(machines: str | Path, containers: str | Path, *,
                     registry=None) -> ClusterTrace:
    """Alibaba cluster-trace-style CSVs → ``ClusterTrace``."""
    records: list[dict] = []
    bad = _Quarantine(registry)
    for row in _read_csv(machines):
        try:
            records.append({
                "kind": "node",
                "t": _f(row, "time_stamp"),
                "node": row["machine_id"],
                "cpu_cap_m": _f(row, "cpu_num") * 1000.0,
                "mem_cap_b": _f(row, "mem_size") * GB,
                "alive": (row.get("status") or "USING") == "USING",
            })
        except (KeyError, ValueError):
            bad()
    for row in _read_csv(containers):
        try:
            req_m = _f(row, "cpu_request") * 1000.0
            util = _f(row, "cpu_util_percent")
            records.append({
                "kind": "pod",
                "t": _f(row, "time_stamp"),
                "pod": row["container_id"],
                "service": row["app_du"],
                "node": row.get("machine_id") or None,
                "cpu_m": req_m * util / 100.0,
                "mem_b": _f(row, "mem_size") * GB,
            })
        except (KeyError, ValueError):
            bad()
    return ClusterTrace(records=_sorted_records(records), quarantined=bad.counts,
                        source=f"alibaba:{machines}")


def load_borg_csv(machine_events: str | Path, task_usage: str | Path, *,
                  cpu_unit_m: float = 32_000.0, mem_unit_b: float = 64.0 * GB,
                  registry=None) -> ClusterTrace:
    """Borg-ClusterData-style CSVs → ``ClusterTrace``. The normalized
    capacities and usages scale by ``cpu_unit_m`` / ``mem_unit_b`` (the
    biggest machine is 1.0 in the public trace)."""
    records: list[dict] = []
    bad = _Quarantine(registry)
    for row in _read_csv(machine_events):
        try:
            records.append({
                "kind": "node",
                "t": _f(row, "time"),
                "node": row["machine_id"],
                "cpu_cap_m": _f(row, "cpus") * cpu_unit_m,
                "mem_cap_b": _f(row, "memory") * mem_unit_b,
                "alive": int(_f(row, "event_type")) != 1,  # 1 = REMOVE
            })
        except (KeyError, ValueError):
            bad()
    for row in _read_csv(task_usage):
        try:
            job, task = row["job_id"], row["task_index"]
            if not job or task is None or task == "":
                raise KeyError("job_id/task_index")
            records.append({
                "kind": "pod",
                "t": _f(row, "start_time"),
                "pod": f"j{job}-{task}",
                "service": f"j{job}",
                "node": row.get("machine_id") or None,
                "cpu_m": _f(row, "cpu_rate") * cpu_unit_m,
                "mem_b": _f(row, "canonical_memory_usage") * mem_unit_b,
            })
        except (KeyError, ValueError):
            bad()
    return ClusterTrace(records=_sorted_records(records), quarantined=bad.counts,
                        source=f"borg:{task_usage}")


def rounds_to_trace(paths: Iterable[str | Path], *, node_cpu_cap_m: float = 0.0
                    ) -> ClusterTrace:
    """Recorded ``rounds.jsonl`` soaks → a usage and placement trace.

    Per attributed round: one ``node`` record per node carrying its traffic
    share (ingress + egress: cost units, not millicores), plus one
    ``placement`` event per applied move (service-granular: the pod field
    carries the moved service's name). ``node_cpu_cap_m`` > 0 stamps a
    uniform capacity so the trace also loads as a percent-scale series."""
    from kubernetes_rescheduling_tpu_torch.forecast.dataset import load_rounds

    records: list[dict] = []
    for i, rec in enumerate(load_rounds(paths)):
        t = float(rec.get("round", i))
        attr = rec.get("attribution")
        if isinstance(attr, dict):
            ingress = attr.get("ingress") or {}
            egress = attr.get("egress") or {}
            for node in sorted(set(ingress) | set(egress)):
                records.append({
                    "kind": "node",
                    "t": t,
                    "node": node,
                    "cpu_cap_m": node_cpu_cap_m,
                    "mem_cap_b": 0.0,
                    "cpu_used_m": float(ingress.get(node, 0.0)) + float(egress.get(node, 0.0)),
                    "mem_used_b": 0.0,
                    "alive": True,
                })
        for mv in rec.get("applied_moves") or ():
            try:
                service, landed = mv[0], mv[1]
            except (TypeError, IndexError, KeyError):
                continue
            records.append({"kind": "placement", "t": t, "pod": str(service),
                            "node": str(landed)})
    # sorted like the CSV adapters: multi-file input restarts the round
    # numbers (the t axis) per file
    return ClusterTrace(records=_sorted_records(records),
                        source="rounds.jsonl:traffic-share-units")


def load_shadow_trace(path: str | Path, *, fmt: str = "auto", registry=None,
                      logger=None) -> ClusterTrace:
    """The CLI's loader: a native ``.jsonl`` file, or a directory holding
    one external-format table pair.

    ``fmt="auto"`` detects: a file → native JSONL; a directory → borg when
    ``machine_events*.csv`` + ``task_usage*.csv`` are present, alibaba when
    ``*machines*.csv`` + ``*containers*.csv`` are, native when a ``*.jsonl``
    is."""
    p = Path(path)
    if fmt not in ("auto", "native", "alibaba", "borg"):
        raise ValueError(f"unknown trace format {fmt!r}")
    if p.is_file():
        if fmt in ("auto", "native"):
            return load_trace_jsonl(p, registry=registry, logger=logger)
        raise ValueError(
            f"format {fmt!r} needs a directory with its CSV table pair, got a file: {p}")
    if not p.is_dir():
        raise FileNotFoundError(f"no such trace: {p}")

    def one(pattern: str) -> Path | None:
        hits = sorted(p.glob(pattern))
        return hits[0] if hits else None

    borg = (one("machine_events*.csv"), one("task_usage*.csv"))
    alibaba = (one("*machines*.csv"), one("*containers*.csv"))
    native = one("*.jsonl")
    if fmt == "borg" or (fmt == "auto" and all(borg)):
        if not all(borg):
            raise FileNotFoundError(
                f"borg-style trace needs machine_events*.csv + task_usage*.csv under {p}")
        return load_borg_csv(borg[0], borg[1], registry=registry)
    if fmt == "alibaba" or (fmt == "auto" and all(alibaba)):
        if not all(alibaba):
            raise FileNotFoundError(
                f"alibaba-style trace needs *machines*.csv + *containers*.csv under {p}")
        return load_alibaba_csv(alibaba[0], alibaba[1], registry=registry)
    if native is not None and fmt in ("auto", "native"):
        return load_trace_jsonl(native, registry=registry, logger=logger)
    raise FileNotFoundError(
        f"no recognizable trace under {p} (native *.jsonl, alibaba "
        f"*machines*/*containers* CSVs, or borg machine_events/task_usage CSVs)")
