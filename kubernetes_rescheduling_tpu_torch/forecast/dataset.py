"""Training datasets from the loop's own telemetry (numpy only) — the port
of ``kubernetes_rescheduling_tpu.forecast.dataset``.

Every soak already records what a learned scheduling plane needs:
``rounds.jsonl`` carries one record per executed round with its attribution
bundle — per-node ingress/egress shares of the communication cost and the
top-k service-edge costs. This module turns recorded soaks into supervised
lag-feature datasets:

- **per-node load series** — each node's total traffic share (ingress +
  egress) per round; a node absent from a round's attribution (drained,
  padded, not yet deployed) is MASKED, not zero-filled;
- **per-edge traffic series** — each recorded service edge's cost per round,
  keyed ``src->dst``; an edge outside a round's top-k is masked (truncation
  is censoring, not a zero reading).

``difference_windows`` (:mod:`oracle.forecast`) yields the model-form
supervision both the numpy fit and ``forecast.model`` consume. The
``telemetry dataset`` mode (:func:`report_dataset`) extracts, fits the numpy
ridge on both families and reports MAE against the persistence baseline.
:func:`load_rounds` also feeds ``traces.adapters.rounds_to_trace``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterable

import numpy as np

from kubernetes_rescheduling_tpu_torch.oracle.forecast import (
    difference_windows,
    eval_forecast_np,
    lag_windows,
)

__all__ = [
    "load_rounds",
    "node_load_series",
    "edge_traffic_series",
    "lag_windows",
    "difference_windows",
    "build_dataset",
    "report_dataset",
]


def load_rounds(paths: Iterable[str | Path]) -> list[dict[str, Any]]:
    """Round records from ``rounds.jsonl`` files (or flight-recorder
    bundle JSONs, whose ring nests each record under ``"record"``),
    in file order then line order."""
    out: list[dict[str, Any]] = []
    for path in paths:
        p = Path(path)
        text = p.read_text()
        if p.suffix == ".json":
            doc = json.loads(text)
            ring = doc.get("ring") if isinstance(doc, dict) else None
            for entry in ring or ():
                rec = entry.get("record") if isinstance(entry, dict) else None
                if isinstance(rec, dict):
                    out.append(rec)
            continue
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if isinstance(rec, dict):
                out.append(rec)
    return out


def _attributions(rounds: Iterable[dict[str, Any]]) -> list[dict[str, Any]]:
    return [
        r["attribution"]
        for r in rounds
        if isinstance(r.get("attribution"), dict)
    ]


def node_load_series(
    rounds: Iterable[dict[str, Any]],
) -> tuple[list[str], np.ndarray, np.ndarray]:
    """Per-node traffic-load series from the attribution records.

    Returns ``(names, series, mask)``: series f64[T, B] of
    ingress+egress per node per attributed round, mask bool[T, B] —
    False where the node carried no reading that round (churned away or
    not yet present). Node order is first-appearance order.
    """
    attrs = _attributions(rounds)
    names: list[str] = []
    index: dict[str, int] = {}
    for a in attrs:
        for n in list(a.get("ingress") or ()) + list(a.get("egress") or ()):
            if n not in index:
                index[n] = len(names)
                names.append(n)
    t = len(attrs)
    series = np.zeros((t, len(names)))
    mask = np.zeros((t, len(names)), dtype=bool)
    for i, a in enumerate(attrs):
        ing = a.get("ingress") or {}
        egr = a.get("egress") or {}
        for n in set(ing) | set(egr):
            j = index[n]
            series[i, j] = float(ing.get(n, 0.0)) + float(egr.get(n, 0.0))
            mask[i, j] = True
    return names, series, mask


def edge_traffic_series(
    rounds: Iterable[dict[str, Any]],
) -> tuple[list[str], np.ndarray, np.ndarray]:
    """Per-service-edge traffic series from the attribution top-k rows.

    Returns ``(keys, series, mask)`` with keys ``"src->dst"``; an edge
    missing from a round's recorded top-k is masked (censored by
    truncation), never read as zero traffic.
    """
    attrs = _attributions(rounds)
    keys: list[str] = []
    index: dict[str, int] = {}
    for a in attrs:
        for e in a.get("edges") or ():
            k = f"{e.get('src_service')}->{e.get('dst_service')}"
            if k not in index:
                index[k] = len(keys)
                keys.append(k)
    t = len(attrs)
    series = np.zeros((t, len(keys)))
    mask = np.zeros((t, len(keys)), dtype=bool)
    for i, a in enumerate(attrs):
        for e in a.get("edges") or ():
            k = f"{e.get('src_service')}->{e.get('dst_service')}"
            j = index[k]
            series[i, j] = float(e.get("cost", 0.0))
            mask[i, j] = True
    return keys, series, mask


def build_dataset(
    rounds: Iterable[dict[str, Any]], *, lags: int = 4
) -> dict[str, Any]:
    """Both target families as supervised lag-window arrays.

    Returns ``{"node_load": {...}, "edge_traffic": {...}}`` where each
    family carries ``names``, ``series``/``mask`` (time-major), and the
    ``X``/``y``/``w`` window triples ready for either fitter.
    """
    rounds = list(rounds)
    out: dict[str, Any] = {"lags": lags, "rounds": len(rounds)}
    for family, extract in (
        ("node_load", node_load_series),
        ("edge_traffic", edge_traffic_series),
    ):
        names, series, mask = extract(rounds)
        X, y_delta, base, w = difference_windows(series, mask, lags)
        out[family] = {
            "names": names,
            "series": series,
            "mask": mask,
            "X": X,
            "y_delta": y_delta,
            "base": base,
            "w": w,
        }
    return out


def report_dataset(
    paths: Iterable[str | Path], *, lags: int = 4, ridge: float = 1e-3
) -> str:
    """The ``telemetry dataset`` renderer: extract both families from
    recorded soaks, fit the numpy oracle ridge, and report MAE vs the
    persistence baseline per family."""
    rounds = load_rounds(paths)
    attributed = len(_attributions(rounds))
    lines = [
        "forecast dataset",
        f"  rounds: {len(rounds)} ({attributed} with attribution)",
        f"  lags: {lags}  ridge: {ridge}",
    ]
    if attributed == 0:
        lines.append(
            "  no attribution records — run the soak with obs.attribution "
            "on and a logger/ops plane attached (OBSERVABILITY.md)"
        )
        return "\n".join(lines)
    for family, extract in (
        ("node_load", node_load_series),
        ("edge_traffic", edge_traffic_series),
    ):
        names, series, mask = extract(rounds)
        stats = eval_forecast_np(series, mask, lags=lags, ridge=ridge)
        verdict = (
            "beats persistence"
            if stats["skill"] > 0
            else "does NOT beat persistence"
        )
        lines.append(
            f"  {family}: {len(names)} series, {stats['windows']} windows | "
            f"mae model {stats['mae_model']:.4f} vs persistence "
            f"{stats['mae_persistence']:.4f} | skill {stats['skill']:+.3f} "
            f"({verdict})"
        )
    return "\n".join(lines)
