"""Human-readable summaries of a run's telemetry — the part of
``kubernetes_rescheduling_tpu.telemetry.report`` the port carries so far:
:func:`report_shadow`, the head-to-head table of a shadow run. The other
reports and the ``telemetry`` command wait with ROADMAP Queue 1 item 4.4.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any


def _read_jsonl(path: Path) -> list[dict[str, Any]]:
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def _round_records(path: Path) -> list[dict[str, Any]]:
    """Round records from a rounds.jsonl file or a flight-recorder bundle's
    ring."""
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


def report_shadow(paths: list[str]) -> str:
    """The head-to-head table of a shadow run: per scored round, our
    counterfactual cost against the trace's recorded scheduler, the running
    win rate, and the edges where we beat it — from ``rounds.jsonl`` files
    or flight-recorder bundles."""
    out = []
    for p in paths:
        out.append(f"== {p} ==")
        path = Path(p)
        if not path.is_file():
            out.append("  not a file")
            continue
        blocks = []
        for r in _round_records(path):
            rec = r.get("record") if isinstance(r.get("record"), dict) else r
            if isinstance(rec, dict) and isinstance(rec.get("shadow"), dict):
                blocks.append(rec["shadow"])
        if not blocks:
            out.append("  no shadow records (was this a --shadow run?)")
            continue
        out.append("  round  recd  cost_actual  cost_shadow      delta  win")
        for b in blocks:
            out.append(
                f"  {b.get('round', '?'):>5}  {b.get('recommended', 0):>4}"
                f"  {b.get('cost_actual', float('nan')):>11.4g}"
                f"  {b.get('cost_shadow', float('nan')):>11.4g}"
                f"  {b.get('cost_delta', float('nan')):>+9.4g}"
                f"  {'WIN' if b.get('win') else 'loss'}"
            )
        last = blocks[-1]
        deltas = [b["cost_delta"] for b in blocks if b.get("cost_delta") is not None]
        mean_delta = sum(deltas) / len(deltas) if deltas else float("nan")
        out.append(
            f"  scored {last.get('scored', len(blocks))} rounds: "
            f"win_rate {last.get('win_rate', float('nan')):.3f}, "
            f"mean delta {mean_delta:+.4g} "
            f"(positive = we beat the cluster's actual scheduler)"
        )
        best: dict[tuple, float] = {}
        for b in blocks:
            for e in b.get("edges_delta") or ():
                if e.get("delta", 0.0) > 0:
                    key = (e.get("src_service"), e.get("dst_service"))
                    best[key] = max(best.get(key, 0.0), float(e["delta"]))
        if best:
            top = sorted(best.items(), key=lambda kv: kv[1], reverse=True)[:5]
            out.append("  edges where we win: "
                       + ", ".join(f"{a}~{b} {d:+.4g}" for (a, b), d in top))
    return "\n".join(out)
