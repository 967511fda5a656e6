"""Append-only performance ledger with rolling-window regression detection.

Every benchmark reading so far died in its own artifact: the bench
harness's ``summary.json`` per session, the benchmark's ``BENCH_r*.json``
snapshots per round — no trend view, no gate, a perf cliff between runs
invisible until someone eyeballs JSON. The ledger is the one
append-only JSONL file they all land in:

- one record per measurement, keyed by
  ``(metric, scenario, device_kind, config_digest)`` — the series key:
  readings only ever compare against readings of the same thing on the
  same kind of device under the same config;
- per-file monotone ``seq`` numbers (the schema checker's invariant —
  an interleaved or rewritten ledger is corrupt, not merely stale);
- ``better`` records the metric's direction (``"lower"`` for
  latencies, ``"higher"`` for decisions/sec), so the detector never
  needs a side table of metric semantics.

:func:`detect` is the rolling-window regression detector: the newest
reading of each series against the median (or best) of the window of
prior readings, with a configurable threshold fraction. Its verdicts —
``improved`` / ``flat`` / ``regressed`` — feed the ``telemetry perf``
trend table, the SLO watchdog's ``perf_regression`` rule
(``perf_regressions_total{metric}``), and ``/healthz``.

:func:`ingest_bench_file` converts the historical benchmark snapshots
(``BENCH_r*.json`` — a ``parsed`` headline block — and
``MULTICHIP_r*.json`` — a dry-run pass/fail) into ledger entries, so
five rounds of existing history become the first window.

The port's copy of ``kubernetes_rescheduling_tpu.telemetry.perf_ledger``
(plain JSON bookkeeping). The port's own readings carry ``device_kind`` =
the card's name (``torch.cuda.get_device_name``) or ``"cpu"``, so they
never share a series with the ingested TPU and forced-CPU history.
"""

from __future__ import annotations

import hashlib
import json
import math
import threading
from pathlib import Path
from typing import Any, Iterable

LEDGER_SCHEMA = 1

#: keys every ledger record must carry (the schema checker's contract)
REQUIRED_KEYS: tuple[str, ...] = (
    "schema",
    "seq",
    "metric",
    "value",
    "unit",
    "scenario",
    "device_kind",
    "config_digest",
    "better",
)


def config_digest(config: Any) -> str:
    """Short stable digest of a config mapping — the ledger's "same
    config" key. Key order never matters; unserializable values stringify."""
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def series_key(rec: dict[str, Any]) -> tuple[str, str, str, str]:
    return (
        str(rec.get("metric")),
        str(rec.get("scenario")),
        str(rec.get("device_kind")),
        str(rec.get("config_digest")),
    )


def validate_entry(rec: dict[str, Any]) -> list[str]:
    """Schema violations of one record (empty = valid)."""
    out = []
    for key in REQUIRED_KEYS:
        if key not in rec:
            out.append(f"missing key {key!r}")
    v = rec.get("value")
    if isinstance(v, (int, float)):
        if isinstance(v, float) and not math.isfinite(v):
            out.append(f"non-finite value {v!r}")
    elif "value" in rec:
        out.append(f"value must be a number, got {type(v).__name__}")
    if rec.get("better") not in (None, "lower", "higher"):
        out.append(f"better must be 'lower'|'higher', got {rec.get('better')!r}")
    seq = rec.get("seq")
    if "seq" in rec and (not isinstance(seq, int) or seq < 0):
        out.append(f"seq must be a non-negative int, got {seq!r}")
    return out


class PerfLedger:
    """One append-only JSONL ledger file.

    ``append`` assigns the next monotone ``seq`` (resuming from the file's
    current tail, so sessions appending to a shared ledger keep the
    invariant), validates the record, and fsync-appends one line."""

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        self._lock = threading.Lock()
        self._next_seq: int | None = None

    def _tail_seq(self) -> int:
        if not self.path.is_file():
            return -1
        last = -1
        for rec in self.entries():
            if isinstance(rec.get("seq"), int):
                last = max(last, rec["seq"])
        return last

    def append(
        self,
        *,
        metric: str,
        value: float,
        unit: str = "",
        scenario: str = "default",
        device_kind: str = "unknown",
        config: Any = None,
        digest: str | None = None,
        better: str = "lower",
        ts: float | None = None,
        **extra: Any,
    ) -> dict[str, Any]:
        """Append one reading; returns the record written."""
        with self._lock:
            if self._next_seq is None:
                self._next_seq = self._tail_seq() + 1
            rec = {
                "schema": LEDGER_SCHEMA,
                "seq": self._next_seq,
                "metric": metric,
                "value": float(value),
                "unit": unit,
                "scenario": scenario,
                "device_kind": device_kind,
                "config_digest": (
                    digest if digest is not None else config_digest(config)
                ),
                "better": better,
            }
            if ts is not None:
                rec["ts"] = ts
            if extra:
                rec["extra"] = extra
            bad = validate_entry(rec)
            if bad:
                raise ValueError(f"invalid ledger entry: {bad}")
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with self.path.open("a") as f:
                f.write(json.dumps(rec, default=float) + "\n")
            self._next_seq += 1
            return rec

    def entries(self) -> list[dict[str, Any]]:
        if not self.path.is_file():
            return []
        return load_entries(self.path)


def load_entries(path: str | Path) -> list[dict[str, Any]]:
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line:
            out.append(json.loads(line))
    return out


# ---------------- historical-snapshot ingestion ----------------


def ingest_bench_file(path: str | Path) -> list[dict[str, Any]]:
    """One benchmark snapshot → ledger-shaped records (seq assigned by the
    caller/ledger). ``BENCH_r*.json`` carries a ``parsed`` headline
    ``{metric, value, unit, extra}``; ``MULTICHIP_r*.json`` is either a
    legacy dry-run verdict (r01–r05) or, from r06, a measured record —
    headline plus nested ``*_reading`` series, all keyed by the mesh
    identity (``device_kind`` × ``n_devices``) so forced-host CPU and
    real-slice runs never share a series. Anything else yields no
    records."""
    p = Path(path)
    try:
        doc = json.loads(p.read_text())
    except (OSError, json.JSONDecodeError):
        return []
    if not isinstance(doc, dict):
        return []
    # MULTICHIP records FIRST: a measured record (r06+) carries both the
    # benchmark's {n_devices, ok} envelope AND a parsed headline, and must
    # NOT fall into the generic BENCH branch below — that branch keys by
    # first device name and hardcodes better="lower", which would let a
    # forced-host CPU run share a trend series with a real slice (and
    # read a rounds/sec gain as a regression). The mesh identity
    # (device_kind × n_devices) is part of the series key here.
    n_devices = doc.get("n_devices")
    if n_devices is not None and "ok" in doc:
        parsed = doc.get("parsed")
        if (
            isinstance(parsed, dict)
            and "metric" in parsed
            and "value" in parsed
        ):
            kind = str(doc.get("device_kind") or f"unknownx{n_devices}")
            digest = config_digest({"n_devices": n_devices})

            def _rec(block: dict) -> dict[str, Any]:
                extra = block.get("extra") or {}
                return {
                    "schema": LEDGER_SCHEMA,
                    "seq": 0,
                    "metric": str(block["metric"]),
                    "value": float(block["value"]),
                    "unit": str(block.get("unit", "")),
                    "scenario": str(extra.get("scenario", "multichip")),
                    "device_kind": kind,
                    "config_digest": digest,
                    "better": str(block.get("better", "higher")),
                    "extra": {
                        "source": p.name,
                        "n_devices": n_devices,
                        "vs_baseline": block.get("vs_baseline"),
                    },
                }

            recs = [_rec(parsed)]
            for k, v in parsed.items():
                if (
                    k.endswith("_reading")
                    and isinstance(v, dict)
                    and "metric" in v
                    and "value" in v
                ):
                    recs.append(_rec(v))
            return recs
        # legacy dryrun receipt (r01–r05): unchanged shape
        return [
            {
                "schema": LEDGER_SCHEMA,
                "seq": 0,
                "metric": "multichip_dryrun_ok",
                "value": 1.0 if doc.get("ok") else 0.0,
                "unit": "bool",
                "scenario": f"n{doc.get('n_devices')}",
                "device_kind": "mesh",
                "config_digest": config_digest(
                    {"n_devices": doc.get("n_devices")}
                ),
                "better": "higher",
                "extra": {"source": p.name, "rc": doc.get("rc")},
            }
        ]
    parsed = doc.get("parsed")
    if isinstance(parsed, dict) and "metric" in parsed and "value" in parsed:
        extra = parsed.get("extra") or {}
        devices = extra.get("devices") or []
        return [
            {
                "schema": LEDGER_SCHEMA,
                "seq": 0,
                "metric": str(parsed["metric"]),
                "value": float(parsed["value"]),
                "unit": str(parsed.get("unit", "")),
                "scenario": str(extra.get("scenario", "bench")),
                "device_kind": str(devices[0]) if devices else "unknown",
                # deliberately CONSTANT: the benchmark's headline snapshots are
                # one evolving series per metric — digesting their drifting
                # knob set would shatter the history into singletons
                "config_digest": "bench-history",
                "better": "lower",  # headline benches are latencies (ms)
                "extra": {"source": p.name, "vs_baseline": parsed.get("vs_baseline")},
            }
        ]
    return []


def ingest_history(
    paths: Iterable[str | Path], ledger: PerfLedger | None = None
) -> list[dict[str, Any]]:
    """Ingest benchmark snapshots in order; appended to ``ledger`` when given
    (seq re-assigned by the ledger), else returned with sequential seq."""
    records: list[dict[str, Any]] = []
    for p in paths:
        records.extend(ingest_bench_file(p))
    if ledger is None:
        for i, rec in enumerate(records):
            rec["seq"] = i
        return records
    out = []
    for rec in records:
        out.append(
            ledger.append(
                metric=rec["metric"],
                value=rec["value"],
                unit=rec["unit"],
                scenario=rec["scenario"],
                device_kind=rec["device_kind"],
                digest=rec["config_digest"],
                better=rec["better"],
                **rec.get("extra", {}),
            )
        )
    return out


# ---------------- regression detection ----------------


def detect(
    entries: Iterable[dict[str, Any]],
    *,
    window: int = 5,
    threshold_frac: float = 0.2,
    baseline: str = "median",
    min_history: int = 2,
) -> dict[str, dict[str, Any]]:
    """Rolling-window verdict per series.

    For each series (same metric/scenario/device/config), the NEWEST
    reading is judged against the ``median`` (or ``best``) of up to
    ``window`` prior readings. A series with fewer than ``min_history``
    prior readings yields ``"fresh"`` — no judgement, never a false
    alarm on the first run of a new cell. Direction comes from the
    entries' ``better`` field.

    Returns ``{display_key: verdict}`` where the verdict carries
    ``status`` (improved|flat|regressed|fresh), current, baseline,
    ratio, and the series identity."""
    if baseline not in ("median", "best"):
        raise ValueError(f"baseline must be 'median'|'best', got {baseline!r}")
    series: dict[tuple, list[dict[str, Any]]] = {}
    for rec in entries:
        series.setdefault(series_key(rec), []).append(rec)
    # display keys: metric@scenario alone while unambiguous; when several
    # series share it (same cell on two device kinds, or across a config
    # change), qualify with device kind + digest so no verdict is silently
    # overwritten — a lost "regressed" would defeat the whole gate
    base_count: dict[str, int] = {}
    for metric, scenario, _, _ in series:
        base = f"{metric}@{scenario}"
        base_count[base] = base_count.get(base, 0) + 1
    out: dict[str, dict[str, Any]] = {}
    for key, recs in series.items():
        recs = sorted(recs, key=lambda r: r.get("seq", 0))
        metric, scenario, device_kind, digest = key
        display = f"{metric}@{scenario}"
        if base_count[display] > 1:
            display = f"{display}@{device_kind}#{digest[:6]}"
        current = float(recs[-1]["value"])
        better = recs[-1].get("better", "lower")
        prior = [float(r["value"]) for r in recs[:-1]][-window:]
        verdict: dict[str, Any] = {
            "metric": metric,
            "scenario": scenario,
            "device_kind": device_kind,
            "config_digest": digest,
            "better": better,
            "current": current,
            "n": len(recs),
        }
        if len(prior) < min_history:
            verdict.update(status="fresh", baseline=None, ratio=None)
            out[display] = verdict
            continue
        if baseline == "median":
            s = sorted(prior)
            mid = len(s) // 2
            base = (
                s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])
            )
        else:
            base = min(prior) if better == "lower" else max(prior)
        ratio = current / base if base else math.inf if current else 1.0
        # normalize to "bigger ratio = worse" whatever the direction
        worse = ratio if better == "lower" else (1.0 / ratio if ratio else math.inf)
        if worse > 1.0 + threshold_frac:
            status = "regressed"
        elif worse < 1.0 - threshold_frac:
            status = "improved"
        else:
            status = "flat"
        verdict.update(status=status, baseline=base, ratio=ratio)
        out[display] = verdict
    return out


def regressions(verdicts: dict[str, dict[str, Any]]) -> dict[str, dict[str, Any]]:
    return {k: v for k, v in verdicts.items() if v.get("status") == "regressed"}


# ---------------- rendering ----------------


def render_table(verdicts: dict[str, dict[str, Any]]) -> list[str]:
    """The ``telemetry perf`` trend table, one row per series."""
    if not verdicts:
        return ["  (no perf series)"]
    rows = [
        (
            k,
            v["device_kind"][:24],
            str(v["n"]),
            f"{v['current']:.4g}",
            "-" if v.get("baseline") is None else f"{v['baseline']:.4g}",
            "-" if v.get("ratio") is None else f"{v['ratio']:.3f}",
            v["status"].upper() if v["status"] == "regressed" else v["status"],
        )
        for k, v in sorted(verdicts.items())
    ]
    header = ("series", "device", "n", "current", "baseline", "ratio", "verdict")
    widths = [
        max(len(header[i]), *(len(r[i]) for r in rows)) for i in range(len(header))
    ]
    fmt = "  " + "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*header)]
    lines.extend(fmt.format(*r) for r in rows)
    bad = regressions(verdicts)
    lines.append(
        f"  regressed: {len(bad)}/{len(verdicts)}"
        + (f" — {', '.join(sorted(bad))}" if bad else "")
    )
    return lines


def device_kind(device) -> str:
    """The ledger's ``device_kind`` of a port reading on ``device``: the
    card's name for a CUDA device, else the device type (``"cpu"``)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type
