"""Human-readable summaries of a run's telemetry artifacts — the port of
``kubernetes_rescheduling_tpu_torch.telemetry.report``.

Backs the ``telemetry`` command: point it at the files a run produced
(``--metrics-out`` dumps, ``StructuredLogger`` event logs, a manifest,
flight-recorder bundles, ``rounds.jsonl``, perf ledgers) and it prints what
an operator wants to know — rounds, moves, cost trajectory, latency
percentiles, capture counts — without jq archaeology. Input kind is
detected per file from the record shape. The renderings are the JAX
package's line for line; a manifest names torch, CUDA and the card where
the JAX one names jax.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any


def _read_jsonl(path: Path) -> list[dict[str, Any]]:
    records = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if line:
            records.append(json.loads(line))
    return records


def _fmt_hist(rec: dict[str, Any]) -> str:
    count = rec.get("count", 0)
    if not count:
        return "count=0"
    mean = rec["sum"] / count
    return (
        f"count={count} mean={mean * 1e3:.3f}ms "
        f"min={rec['min'] * 1e3:.3f}ms max={rec['max'] * 1e3:.3f}ms"
    )


def _labels_str(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"


def _scan_plane_lines(latest: dict[tuple, dict[str, Any]]) -> list[str]:
    """The scan-plane digest an operator reads before the raw series: block
    size, blocks dispatched, and the drain/tripwire breakdowns — only when
    the run actually scanned (``scan_blocks_total`` present)."""
    blocks = block = None
    drains: dict[str, float] = {}
    trips: dict[str, float] = {}
    for (metric, _), rec in latest.items():
        labels = rec.get("labels") or {}
        if metric == "scan_blocks_total":
            blocks = rec.get("value")
        elif metric == "scan_rounds_per_dispatch":
            block = rec.get("value")
        elif metric == "scan_drains_total":
            drains[str(labels.get("reason"))] = rec.get("value", 0)
        elif metric in ("scan_tripwires_total", "fleet_scan_tripwires_total"):
            key = str(labels.get("rule") or labels.get("tenant"))
            trips[key] = trips.get(key, 0) + (rec.get("value") or 0)
    if blocks is None:
        return []
    out = [f"  scan plane: blocks={blocks:g}" + (
        f" block_rounds={block:g}" if block is not None else ""
    )]
    if drains:
        out.append(
            "    drains: "
            + ", ".join(f"{k}×{v:g}" for k, v in sorted(drains.items()))
        )
    if trips:
        out.append(
            "    tripwires: "
            + ", ".join(f"{k}×{v:g}" for k, v in sorted(trips.items()))
        )
    return out


def _hist_quantile(rec: dict[str, Any], q: float) -> float | None:
    """Approximate a quantile from a snapshot histogram record's
    per-bucket counts (linear interpolation inside the covering bucket;
    the +Inf bucket answers with the recorded max)."""
    count = rec.get("count") or 0
    if not count:
        return None
    target = q * count
    buckets = rec.get("buckets") or {}
    edges = sorted((float(ub), n) for ub, n in buckets.items())
    cum = 0.0
    lo = rec.get("min") or 0.0
    for ub, n in edges:
        if cum + n >= target and n > 0:
            frac = (target - cum) / n
            return lo + frac * (ub - lo)
        cum += n
        lo = ub
    return rec.get("max")


def _serving_plane_lines(
    latest: dict[tuple, dict[str, Any]], records: list[dict[str, Any]]
) -> list[str]:
    """The serving-plane digest: outcome totals, end-to-end latency
    percentiles interpolated from the total-stage histogram, the shed
    breakdown, and the batch-size distribution — only when the run
    actually served (``serving_placements_total`` present). Placement
    rate needs a time axis, so it renders only when the dump appended
    >= 2 snapshots (their ``ts`` stamps are the axis)."""
    outcomes: dict[str, float] = {}
    shed: dict[str, float] = {}
    total_hist = None
    batch_hist = None
    inflight = None
    for (metric, _), rec in latest.items():
        labels = rec.get("labels") or {}
        if metric == "serving_placements_total":
            outcomes[str(labels.get("outcome"))] = rec.get("value", 0)
        elif metric == "serving_shed_total":
            shed[str(labels.get("reason"))] = rec.get("value", 0)
        elif (
            metric == "serving_request_seconds"
            and labels.get("stage") == "total"
        ):
            total_hist = rec
        elif metric == "serving_batch_size":
            batch_hist = rec
        elif metric == "serving_inflight":
            inflight = rec.get("value")
    if not outcomes:
        return []
    out = [
        "  serving plane: "
        + " ".join(f"{k}={v:g}" for k, v in sorted(outcomes.items()))
        + (f" inflight={inflight:g}" if inflight is not None else "")
    ]
    if total_hist is not None and total_hist.get("count"):
        p50 = _hist_quantile(total_hist, 0.50)
        p95 = _hist_quantile(total_hist, 0.95)
        p99 = _hist_quantile(total_hist, 0.99)
        mean = total_hist["sum"] / total_hist["count"]
        out.append(
            f"    latency(total): p50={p50 * 1e3:.2f}ms "
            f"p95={p95 * 1e3:.2f}ms p99={p99 * 1e3:.2f}ms "
            f"mean={mean * 1e3:.2f}ms count={total_hist['count']}"
        )
    # rate needs a time axis: diff the first/last appended snapshot of
    # the total-stage count over their dump timestamps
    snaps = [
        r
        for r in records
        if r.get("metric") == "serving_request_seconds"
        and (r.get("labels") or {}).get("stage") == "total"
    ]
    if len(snaps) >= 2:
        dt = (snaps[-1].get("ts") or 0) - (snaps[0].get("ts") or 0)
        dc = (snaps[-1].get("count") or 0) - (snaps[0].get("count") or 0)
        if dt > 0 and dc >= 0:
            out.append(f"    placements/sec: {dc / dt:.2f} (over {dt:.2f}s)")
    if shed:
        out.append(
            "    shed: "
            + ", ".join(f"{k}×{v:g}" for k, v in sorted(shed.items()))
        )
    if batch_hist is not None and batch_hist.get("count"):
        dist = ", ".join(
            f"≤{float(ub):g}×{n:g}"
            for ub, n in sorted(
                (batch_hist.get("buckets") or {}).items(),
                key=lambda kv: float(kv[0]),
            )
            if n
        )
        if batch_hist.get("inf"):
            dist += f", +Inf×{batch_hist['inf']:g}"
        out.append(f"    batch sizes: {dist} (count={batch_hist['count']})")
    return out


def summarize_metrics(records: list[dict[str, Any]]) -> list[str]:
    """Registry-dump JSONL (``MetricsRegistry.dump_jsonl``) → text lines.
    When a run appended several snapshots, the LAST sample per series
    wins (values are cumulative)."""
    latest: dict[tuple, dict[str, Any]] = {}
    for rec in records:
        key = (rec["metric"], tuple(sorted((rec.get("labels") or {}).items())))
        latest[key] = rec
    lines = _scan_plane_lines(latest)
    lines += _serving_plane_lines(latest, records)
    for (metric, _), rec in sorted(latest.items()):
        labels = _labels_str(rec.get("labels") or {})
        if rec.get("type") == "histogram":
            lines.append(f"  {metric}{labels}  {_fmt_hist(rec)}")
        else:
            lines.append(f"  {metric}{labels} = {rec.get('value')}")
    return lines


def summarize_events(records: list[dict[str, Any]]) -> list[str]:
    """StructuredLogger JSONL → text lines; per-round ``round`` events get
    the full trajectory treatment, everything else a count by event."""
    rounds = [r for r in records if r.get("event") == "round"]
    by_event: dict[str, int] = {}
    for r in records:
        by_event[r.get("event", "?")] = by_event.get(r.get("event", "?"), 0) + 1
    lines = [
        f"  events: "
        + ", ".join(f"{k}×{v}" for k, v in sorted(by_event.items()))
    ]
    if rounds:
        moved = sum(1 for r in rounds if r.get("moved"))
        costs = [
            r["communication_cost"]
            for r in rounds
            if r.get("communication_cost") is not None
        ]
        lats = sorted(
            r["decision_latency_s"]
            for r in rounds
            if r.get("decision_latency_s") is not None
        )
        lines.append(f"  rounds: {len(rounds)}  moved: {moved}")
        if costs:
            lines.append(
                f"  communication_cost: {costs[0]:.2f} -> {costs[-1]:.2f}"
            )
        if lats:
            def pct(q):
                return lats[min(int(q / 100 * len(lats)), len(lats) - 1)]

            lines.append(
                f"  decision latency: p50={pct(50) * 1e3:.2f}ms "
                f"p90={pct(90) * 1e3:.2f}ms max={lats[-1] * 1e3:.2f}ms"
            )
    # resilience: breaker transitions, skipped/degraded rounds, boundary
    # failures — the degraded-mode trajectory an operator reads first when
    # a run looks wrong
    transitions = [r for r in records if r.get("event") == "breaker"]
    if transitions:
        arrows = ", ".join(
            f"{t.get('from', '?')}->{t.get('to', '?')}@r{t.get('round', '?')}"
            for t in transitions
        )
        lines.append(f"  breaker: {arrows}")
    skipped = by_event.get("round_skipped", 0)
    degraded = sum(1 for r in rounds if r.get("degraded"))
    failures = sum(1 for r in records if r.get("event") == "boundary_failure")
    if skipped or degraded or failures:
        lines.append(
            f"  resilience: skipped={skipped} degraded={degraded} "
            f"boundary_failures={failures}"
        )
    trips = [r for r in records if r.get("event") == "scan_tripwire"]
    if trips:
        lines.append(
            "  scan tripwires: "
            + ", ".join(
                f"r{t.get('round', '?')} "
                f"({'+'.join(t.get('rules') or ()) or '?'})"
                for t in trips
            )
        )
    return lines


def summarize_manifest(m: dict[str, Any]) -> list[str]:
    tc = m.get("torch") or {}
    git = m.get("git") or {}
    names = sorted({d.get("name", "?") for d in tc.get("devices") or ()})
    lines = [
        f"  run: {m.get('timestamp')}  host: {m.get('hostname')}",
        f"  argv: {' '.join(m.get('argv') or [])}",
        f"  python {m.get('python')}  torch {tc.get('version', '?')} "
        f"(cuda {tc.get('cuda', '?')}; {', '.join(names) or 'no card'} "
        f"×{len(tc.get('devices') or ())})",
    ]
    if git:
        rev = git.get("rev", "?")[:12]
        lines.append(f"  git: {rev}{' (dirty)' if git.get('dirty') else ''}")
    return lines


def summarize_bundle(bundle: dict[str, Any]) -> list[str]:
    """Flight-recorder bundle → text: trigger, ring contents, and the
    explain-consistency verdict over every recorded decision."""
    from kubernetes_rescheduling_tpu_torch.telemetry.explain import (
        check_decisions,
        iter_decisions,
    )

    rounds = bundle.get("rounds") or []
    executed = [r for r in rounds if not r.get("skipped")]
    skipped = len(rounds) - len(executed)
    lines = [
        f"  flight-recorder bundle: reason={bundle.get('reason')}"
        + (f" ({bundle.get('error')})" if bundle.get("error") else ""),
        f"  rounds ringed: {len(rounds)} ({len(executed)} executed, "
        f"{skipped} skipped)",
    ]
    for r in executed:
        rec = r.get("record") or {}
        lines.append(
            f"    r{r.get('round')}: digest={r.get('digest')} "
            f"moved={rec.get('moved')} breaker={rec.get('breaker_state')} "
            f"cost={rec.get('communication_cost'):.4g}"
            if rec.get("communication_cost") is not None
            else f"    r{r.get('round')}: digest={r.get('digest')}"
        )
    decisions = iter_decisions(rounds)
    checked, bad = check_decisions(decisions)
    lines.append(
        f"  decisions: {checked} recorded, "
        f"{checked - len(bad)} explain-consistent"
        + ("" if not bad else f" — {len(bad)} INCONSISTENT")
    )
    from kubernetes_rescheduling_tpu_torch.telemetry.attribution import (
        check_attribution,
    )

    a_checked, a_bad = check_attribution(rounds)
    if a_checked:
        lines.append(
            f"  attribution: {a_checked} recorded, "
            f"{a_checked - len(a_bad)} sum-consistent"
            + ("" if not a_bad else f" — {len(a_bad)} INCONSISTENT")
        )
    metrics = bundle.get("metrics") or []
    lines.append(f"  metrics snapshot: {len(metrics)} series")
    manifest = bundle.get("manifest") or {}
    if manifest:
        lines.append(
            f"  from: {manifest.get('hostname')} pid {manifest.get('pid')} "
            f"at {manifest.get('timestamp')}"
        )
    return lines


def summarize_file(path: str | Path) -> str:
    """Detect the artifact kind from its record shape and summarize."""
    p = Path(path)
    if not p.is_file():
        return f"{p}: not a file"
    header = [f"== {p} =="]
    text = p.read_text().strip()
    if not text:
        return "\n".join(header + ["  (empty)"])
    if text.startswith("{") and "\n" not in text.split("}")[0] or p.suffix == ".json":
        # whole-file JSON: a manifest, a Chrome trace, or a bundle
        try:
            obj = json.loads(text)
        except json.JSONDecodeError:
            obj = None
        if isinstance(obj, dict):
            if obj.get("kind") == "flight_recorder_bundle":
                return "\n".join(header + summarize_bundle(obj))
            if "traceEvents" in obj:
                return "\n".join(
                    header + [f"  chrome trace: {len(obj['traceEvents'])} spans"]
                )
            if "argv" in obj or "torch" in obj:
                return "\n".join(header + summarize_manifest(obj))
    records = _read_jsonl(p)
    if records and "metric" in records[0]:
        return "\n".join(header + summarize_metrics(records))
    if records and "event" in records[0]:
        return "\n".join(header + summarize_events(records))
    return "\n".join(header + [f"  {len(records)} records (unknown schema)"])


def report(paths: list[str]) -> str:
    return "\n".join(summarize_file(p) for p in paths)


def report_explain(paths: list[str]) -> str:
    """The ``telemetry explain`` report: decision explanations (from
    ``decision`` events or a bundle's ring), re-derived and rendered."""
    from kubernetes_rescheduling_tpu_torch.telemetry.explain import (
        load_decisions,
        summarize_decisions,
    )

    out = []
    for p in paths:
        out.append(f"== {p} ==")
        out.extend(summarize_decisions(load_decisions(p)))
    return "\n".join(out)


def report_perf(
    paths: list[str],
    *,
    window: int = 5,
    threshold_frac: float = 0.2,
    baseline: str = "median",
) -> str:
    """The ``telemetry perf`` report: load perf-ledger JSONL files and/or
    historical benchmark snapshots (``BENCH_r*.json`` / ``MULTICHIP_r*.json``
    — auto-detected and ingested), judge every series with the
    rolling-window detector, and render the trend table with per-metric
    verdicts."""
    from kubernetes_rescheduling_tpu_torch.telemetry import perf_ledger as pl

    ledger_recs: list[dict[str, Any]] = []
    history: list[dict[str, Any]] = []
    loaded: list[str] = []
    for p in paths:
        path = Path(p)
        if not path.is_file():
            loaded.append(f"  {p}: not a file")
            continue
        ingested = pl.ingest_bench_file(path)
        if ingested:
            history.extend(ingested)
            loaded.append(f"  {p}: {len(ingested)} snapshot record(s)")
            continue
        try:
            records = _read_jsonl(path)
        except json.JSONDecodeError:
            loaded.append(f"  {p}: not JSONL")
            continue
        recs = [
            r
            for r in records
            if isinstance(r, dict) and "metric" in r and "seq" in r
        ]
        if recs:
            ledger_recs.extend(recs)
            loaded.append(f"  {p}: {len(recs)} ledger record(s)")
        else:
            loaded.append(f"  {p}: no perf records")
    # ingested snapshots are HISTORY by definition: rank them (in CLI arg
    # order) strictly before every ledger record via negative seqs, so a
    # ledger that shares a series with the snapshots (BENCH_LEDGER) is
    # judged today-against-history, never history-against-today
    for i, rec in enumerate(history):
        rec["seq"] = i - len(history)
    entries = history + ledger_recs
    out = ["== perf ledger =="] + loaded
    verdicts = pl.detect(
        entries, window=window, threshold_frac=threshold_frac,
        baseline=baseline,
    )
    out.extend(pl.render_table(verdicts))
    return "\n".join(out)


def _topo_rounds(path: Path) -> list[dict[str, Any]]:
    """Round records (dicts carrying `attribution`) from a rounds.jsonl
    file or a flight-recorder bundle's ring."""
    text = path.read_text().strip()
    if not text:
        return []
    if text.startswith("{") and path.suffix == ".json":
        try:
            obj = json.loads(text)
        except json.JSONDecodeError:
            return []
        if isinstance(obj, dict) and obj.get("kind") == "flight_recorder_bundle":
            return list(obj.get("rounds") or ())
        return [obj] if isinstance(obj, dict) else []
    return _read_jsonl(path)


def report_topo(paths: list[str]) -> str:
    """The ``telemetry topo`` report: cost attribution & topology — the
    latest round's edge-attribution table and node-pair heatmap, the
    placement/provenance trail over all rounds, and the sum-consistency
    verdict (per-edge contributions re-derive the recorded cost scalar;
    per-move deltas re-derive the objective delta)."""
    from kubernetes_rescheduling_tpu_torch.telemetry.attribution import (
        check_attribution,
        iter_attributions,
        render_edges,
        render_heatmap,
        render_provenance,
        render_residency,
        residency_from_rounds,
    )

    out = []
    for p in paths:
        out.append(f"== {p} ==")
        path = Path(p)
        if not path.is_file():
            out.append("  not a file")
            continue
        rounds = _topo_rounds(path)
        attrs = iter_attributions(rounds)
        if not attrs:
            out.append("  no attribution records (was obs.attribution off?)")
            continue
        latest = attrs[-1][0]
        rnd = latest.get("round", "?")
        total = latest.get("total")
        out.append(
            f"  rounds with attribution: {len(attrs)}; latest r{rnd} "
            f"total cost {total:.4g}"
        )
        out.extend(render_edges(latest))
        out.extend(render_heatmap(latest))
        out.append("  residency (service -> node over rounds):")
        out.extend(
            f"  {ln}" for ln in render_residency(residency_from_rounds(rounds))
        )
        out.append("  move provenance:")
        out.extend(render_provenance(rounds))
        checked, bad = check_attribution(rounds)
        out.append(
            f"  consistency: {checked - len(bad)}/{checked} rounds re-derive "
            f"their cost scalar and move deltas from the recorded attribution"
        )
        for a in bad:
            out.append(
                f"    INCONSISTENT: r{a.get('round', '?')} total="
                f"{a.get('total')} does not re-derive from its parts"
            )
    return "\n".join(out)


def report_shadow(paths: list[str]) -> str:
    """The ``telemetry shadow`` report: the head-to-head table of a
    shadow run — per scored round, our counterfactual cost vs the
    trace's actual scheduler, the running win-rate, and the edges where
    we beat it — from ``rounds.jsonl`` files or flight-recorder
    bundles."""
    out = []
    for p in paths:
        out.append(f"== {p} ==")
        path = Path(p)
        if not path.is_file():
            out.append("  not a file")
            continue
        rounds = _topo_rounds(path)
        blocks = []
        for r in rounds:
            rec = r.get("record") if isinstance(r.get("record"), dict) else r
            if isinstance(rec, dict) and isinstance(rec.get("shadow"), dict):
                blocks.append(rec["shadow"])
        if not blocks:
            out.append("  no shadow records (was this a --shadow run?)")
            continue
        out.append(
            "  round  recd  cost_actual  cost_shadow      delta  win"
        )
        for b in blocks:
            out.append(
                f"  {b.get('round', '?'):>5}  {b.get('recommended', 0):>4}"
                f"  {b.get('cost_actual', float('nan')):>11.4g}"
                f"  {b.get('cost_shadow', float('nan')):>11.4g}"
                f"  {b.get('cost_delta', float('nan')):>+9.4g}"
                f"  {'WIN' if b.get('win') else 'loss'}"
            )
        last = blocks[-1]
        deltas = [
            b["cost_delta"] for b in blocks if b.get("cost_delta") is not None
        ]
        mean_delta = sum(deltas) / len(deltas) if deltas else float("nan")
        out.append(
            f"  scored {last.get('scored', len(blocks))} rounds: "
            f"win_rate {last.get('win_rate', float('nan')):.3f}, "
            f"mean delta {mean_delta:+.4g} "
            f"(positive = we beat the cluster's actual scheduler)"
        )
        winning = [
            e
            for b in blocks
            for e in (b.get("edges_delta") or ())
            if e.get("delta", 0.0) > 0
        ]
        if winning:
            best: dict[tuple, float] = {}
            for e in winning:
                key = (e.get("src_service"), e.get("dst_service"))
                best[key] = max(best.get(key, 0.0), float(e["delta"]))
            top = sorted(best.items(), key=lambda kv: kv[1], reverse=True)[:5]
            out.append(
                "  edges where we win: "
                + ", ".join(f"{a}~{b} {d:+.4g}" for (a, b), d in top)
            )
    return "\n".join(out)


def _fleet_rollup_events(path: Path) -> list[dict[str, Any]]:
    """``fleet_rollup`` events from a structured-event JSONL file or a
    flight-recorder bundle (ring events + the breaker-open dump's
    top-level ``fleet_rollup`` payload)."""
    rounds = _topo_rounds(path)
    out: list[dict[str, Any]] = []
    for r in rounds:
        if r.get("event") == "fleet_rollup":
            out.append(r)
        for e in r.get("events") or ():
            if isinstance(e, dict) and e.get("event") == "fleet_rollup":
                out.append(e)
    if not out and path.suffix == ".json":
        try:
            obj = json.loads(path.read_text())
        except json.JSONDecodeError:
            obj = None
        if isinstance(obj, dict) and isinstance(
            obj.get("fleet_rollup"), dict
        ):
            out.append(obj["fleet_rollup"])
    return out


def report_fleet(paths: list[str]) -> str:
    """The ``telemetry fleet`` report: the bounded fleet-observability
    plane rendered from recorded ``fleet_rollup`` events (a fleet run's
    event JSONL, or flight-recorder bundles) — the per-dimension
    quantile trend across rounds, the latest fleet totals, and the
    offender table (which tenants kept landing in the worst-k, by
    dimension) that replaces scrolling O(T) per-tenant series."""
    out = []
    for p in paths:
        out.append(f"== {p} ==")
        path = Path(p)
        if not path.is_file():
            out.append("  not a file")
            continue
        evs = _fleet_rollup_events(path)
        if not evs:
            out.append(
                "  no fleet_rollup events (was this a fleet run with "
                "obs.fleet_rollup on?)"
            )
            continue
        first, last = evs[0], evs[-1]
        out.append(
            f"  fleet rollups: {len(evs)} rounds "
            f"(r{first.get('round', '?')} -> r{last.get('round', '?')}, "
            f"top_k={last.get('top_k', '?')})"
        )
        out.append(
            "  dim              p50 first->last      p99 first->last"
            "      max first->last"
        )
        for dim in ("cost", "load_std", "drift"):
            fq = (first.get("quantiles") or {}).get(dim) or {}
            lq = (last.get("quantiles") or {}).get(dim) or {}
            cells = "".join(
                f"  {fq.get(q, float('nan')):>8.4g} -> {lq.get(q, float('nan')):<8.4g}"
                for q in ("p50", "p99", "max")
            )
            out.append(f"  {dim:<15}{cells}")
        sums = last.get("sums") or {}
        out.append(
            f"  latest fleet totals: degraded={sums.get('degraded', 0):g} "
            f"skipped={sums.get('skipped', 0):g} "
            f"drift_pods={sums.get('drift', 0):g}"
        )
        # offender table: appearances in the worst-k across all rounds
        seen: dict[str, dict[str, list[float]]] = {}
        for ev in evs:
            for row in ev.get("worst") or ():
                tenant = str(row.get("tenant"))
                seen.setdefault(tenant, {}).setdefault(
                    str(row.get("dim")), []
                ).append(float(row.get("value", 0.0)))
        ranked = sorted(
            seen.items(),
            key=lambda kv: sum(len(v) for v in kv[1].values()),
            reverse=True,
        )[:10]
        if ranked:
            out.append("  worst offenders (appearances in the top-k):")
            for tenant, dims in ranked:
                cells = " ".join(
                    f"{dim}×{len(vals)} (max {max(vals):.4g})"
                    for dim, vals in sorted(dims.items())
                )
                out.append(f"    {tenant:<16} {cells}")
    return "\n".join(out)


_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(values: list[float]) -> str:
    """Unicode sparkline scaled to the series' own max (a flat zero
    series renders all-low — exactly what a clean soak should show)."""
    if not values:
        return ""
    top = max(values)
    if top <= 0:
        return _SPARK[0] * len(values)
    return "".join(
        _SPARK[min(int(v / top * (len(_SPARK) - 1) + 0.5), len(_SPARK) - 1)]
        for v in values
    )


def report_slo(paths: list[str]) -> str:
    """The ``telemetry slo`` report: the error-budget table plus burn
    sparklines. Feeds on either artifact kind — a metrics dump JSONL
    (``slo_budget_remaining_frac``/``slo_burn_rate`` samples, sparklines
    over the appended snapshots in file order) or an events JSONL
    (burn-rule ``slo_violation``/``slo_recovered`` entries)."""
    out = []
    for p in paths:
        out.append(f"== {p} ==")
        path = Path(p)
        if not path.is_file():
            out.append("  not a file")
            continue
        try:
            records = _read_jsonl(path)
        except (OSError, json.JSONDecodeError) as e:
            out.append(f"  unreadable: {e}")
            continue
        # metrics-dump shape: budget gauges + burn-rate history
        budgets: dict[str, float] = {}
        burns: dict[tuple[str, str], list[float]] = {}
        for rec in records:
            metric = rec.get("metric")
            labels = rec.get("labels") or {}
            if metric == "slo_budget_remaining_frac":
                budgets[str(labels.get("slo"))] = rec.get("value", 0.0)
            elif metric == "slo_burn_rate":
                burns.setdefault(
                    (str(labels.get("slo")), str(labels.get("window"))), []
                ).append(rec.get("value", 0.0))
        if budgets:
            out.append(
                "  slo                      budget     burn(fast)  burn(slow)"
            )
            for slo in sorted(budgets):
                fast = burns.get((slo, "fast")) or [0.0]
                slow = burns.get((slo, "slow")) or [0.0]
                out.append(
                    f"  {slo:<24} {budgets[slo] * 100:>7.2f}%  "
                    f"{fast[-1]:>9.2f}  {slow[-1]:>9.2f}"
                )
            for (slo, window), vals in sorted(burns.items()):
                out.append(
                    f"    burn {slo}/{window}: {_sparkline(vals[-64:])} "
                    f"(last {vals[-1]:.2f})"
                )
            continue
        # events shape: the burn rules' violation/recovery trail
        burn_events = [
            r
            for r in records
            if r.get("event") in ("slo_violation", "slo_recovered")
            and str(r.get("rule", "")).startswith("slo_")
        ]
        if not burn_events:
            out.append(
                "  no slo samples or burn events (was this run started "
                "with --slo?)"
            )
            continue
        for ev in burn_events:
            if ev.get("event") == "slo_violation":
                out.append(
                    f"  VIOLATION {ev.get('rule')} slo={ev.get('slo', '?')} "
                    f"burn={ev.get('burn_rate', '?')} over "
                    f"{ev.get('window', '?')}t "
                    f"(budget {float(ev.get('budget_remaining_frac', 0)) * 100:.1f}% left)"
                )
            else:
                out.append(f"  recovered {ev.get('rule')}")
    return "\n".join(out)


def report_bundle(paths: list[str]) -> str:
    """The ``telemetry bundle`` report: summarize flight-recorder bundles."""
    out = []
    for p in paths:
        out.append(f"== {p} ==")
        try:
            obj = json.loads(Path(p).read_text())
        except (OSError, json.JSONDecodeError) as e:
            out.append(f"  unreadable: {e}")
            continue
        if not isinstance(obj, dict) or obj.get("kind") != "flight_recorder_bundle":
            out.append("  not a flight-recorder bundle")
            continue
        out.extend(summarize_bundle(obj))
    return "\n".join(out)
