"""Decision explanations, the host half — the port of
``kubernetes_rescheduling_tpu.telemetry.explain`` (pure host code, copied).

The controller's rounds record WHY each move happened: which node was
hazardous, which targets were considered, what each scored, and why the
winner won. The device side (``solver.round_loop.decide_explain``) ships
one compact f32 bundle per decision; this module turns that bundle into a
``DecisionExplanation`` dict and can RE-DERIVE the chosen move as the
argmax of the recorded candidate scores (:func:`explanation_consistent`):
an explanation that cannot reproduce its own decision is a bug.

Explanations are plain dicts (JSONL-safe) with a ``kind`` discriminator:

- ``greedy`` — one per decide: hazard top-k, candidate top-k with
  primary/tie-break scores and margins, chosen target.
- ``global`` / ``pod`` — one per solver round: the applied moves as
  candidates scored by their individual objective gain (global) or
  replicas relocated (pod), plus the solver's before/after objectives.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Iterable

_NEG_INF = float("-inf")


def _finite(v: float) -> float | None:
    return None if v is None or not math.isfinite(v) else float(v)


def greedy_explanation(
    bundle,
    node_names: list[str],
    *,
    round: int,
    seq: int,
    policy: str,
    service: str | None,
    hazard_node: str | None,
    chosen: str | None,
) -> dict[str, Any]:
    """Build the ``greedy`` DecisionExplanation from the pulled device
    bundle (f32[6, k] — see ``decide_explain``). ``chosen`` is the node
    the decision picked (None on a no-op path)."""
    hz_i, hz_v, c_i, c_k1, c_k2, c_ok = (list(map(float, row)) for row in bundle)
    n = len(node_names)
    hazard = [
        {"node": node_names[int(i)], "cpu_pct": v}
        for i, v in zip(hz_i, hz_v)
        if math.isfinite(v) and 0 <= int(i) < n
    ]
    chosen_score = None
    candidates = []
    for i, s, t, ok in zip(c_i, c_k1, c_k2, c_ok):
        if not ok or not (0 <= int(i) < n) or not math.isfinite(s):
            continue
        name = node_names[int(i)]
        candidates.append(
            {
                "node": name,
                "node_index": int(i),
                "score": float(s),
                "tiebreak": _finite(t),
            }
        )
        if name == chosen:
            chosen_score = float(s)
    for c in candidates:
        c["margin"] = (
            chosen_score - c["score"] if chosen_score is not None else None
        )
    if chosen is None:
        if hazard_node is None:
            why = "no node at/over the hazard threshold"
        elif not candidates:
            why = "every valid node is hazardous — move skipped"
        else:
            why = "hazard node has no movable pod"
    else:
        runner = next(
            (c for c in candidates if c["node"] != chosen), None
        )
        margin = (
            chosen_score - runner["score"]
            if runner is not None and chosen_score is not None
            else None
        )
        why = (
            f"drain {service!r} from {hazard_node}: {policy} scored "
            f"{chosen} highest"
            + (f" (margin {margin:.4g} over {runner['node']})" if margin is not None else "")
        )
    return {
        "kind": "greedy",
        "round": round,
        "seq": seq,
        "policy": policy,
        "service": service,
        "hazard_node": hazard_node,
        "hazard": hazard,
        "candidates": candidates,
        "chosen": chosen,
        "why": why,
    }


def solver_explanation(
    *,
    kind: str,
    round: int,
    policy: str,
    candidates: list[dict[str, Any]],
    objective_before: float | None,
    objective_after: float | None,
    applied: int,
    proposed: int,
) -> dict[str, Any]:
    """The ``global``/``pod`` round explanation: applied moves as scored
    candidates (individual objective gain, or replicas relocated), chosen
    = the top-scored one."""
    best = None
    for c in candidates:
        if best is None or (
            c["score"],
            -(c.get("node_index") or 0),
        ) > (best["score"], -(best.get("node_index") or 0)):
            best = c
    chosen = best["node"] if best is not None else None
    obj = ""
    if objective_before is not None and objective_after is not None:
        obj = f"; objective {objective_before:.4g} -> {objective_after:.4g}"
    return {
        "kind": kind,
        "round": round,
        "policy": policy,
        "service": best.get("service") if best is not None else None,
        "candidates": candidates,
        "chosen": chosen,
        "objective_before": objective_before,
        "objective_after": objective_after,
        "why": f"batched solve proposed {proposed} moves, applied {applied}{obj}",
    }


def explanation_consistent(expl: dict[str, Any]) -> bool:
    """Re-derive the chosen move as the argmax of the recorded candidate
    scores — the audit invariant. A no-move explanation (``chosen`` None)
    is vacuously consistent; otherwise the chosen entry must exist among
    the candidates and dominate them under (score, tiebreak, lowest node
    index) — exactly the device kernel's masked lexicographic argmax
    order for ``greedy``, plain max-score for solver rounds."""
    chosen = expl.get("chosen")
    if chosen is None:
        return True
    candidates = expl.get("candidates") or []
    if not any(c.get("node") == chosen for c in candidates):
        return False

    def rank(c: dict[str, Any]):
        tb = c.get("tiebreak")
        return (
            c.get("score", _NEG_INF),
            _NEG_INF if tb is None else tb,
            -(c.get("node_index") or 0),
        )

    best = max(candidates, key=rank)
    return best.get("node") == chosen


def iter_decisions(records: Iterable[dict[str, Any]]) -> list[dict[str, Any]]:
    """Decision explanations from a mixed record stream: structured
    ``decision`` events, flight-recorder round entries, or bare
    explanation dicts (``kind`` + ``candidates``)."""
    out = []
    for r in records:
        if r.get("event") == "decision" or (
            "kind" in r and "candidates" in r
        ):
            out.append(r)
        for d in r.get("decisions") or ():
            out.append(d)
        rec = r.get("record")
        if isinstance(rec, dict):
            for d in rec.get("explanations") or ():
                out.append(d)
    return out


def check_decisions(
    decisions: Iterable[dict[str, Any]],
) -> tuple[int, list[dict[str, Any]]]:
    """(checked, inconsistent) over a decision stream — the bundle
    summarizer's and the acceptance test's shared verdict."""
    checked = 0
    bad = []
    for d in decisions:
        checked += 1
        if not explanation_consistent(d):
            bad.append(d)
    return checked, bad


def summarize_decisions(decisions: list[dict[str, Any]]) -> list[str]:
    """Human-readable ``telemetry explain`` rendering."""
    if not decisions:
        return ["  no decision records"]
    lines = []
    for d in decisions:
        head = (
            f"  r{d.get('round', '?')}"
            + (f".{d['seq']}" if d.get("seq") is not None else "")
            + f" [{d.get('kind', '?')}/{d.get('policy', '?')}]"
        )
        lines.append(f"{head} {d.get('why', '')}")
        for c in d.get("candidates") or []:
            mark = "->" if c.get("node") == d.get("chosen") else "  "
            margin = c.get("margin")
            lines.append(
                f"      {mark} {c.get('node')}"
                + (f" service={c['service']}" if c.get("service") else "")
                + f" score={c.get('score'):.6g}"
                + (f" margin={margin:.4g}" if margin not in (None, 0.0) else "")
            )
    checked, bad = check_decisions(decisions)
    lines.append(
        f"  consistency: {checked - len(bad)}/{checked} decisions re-derive "
        f"their chosen move from the recorded scores"
    )
    for d in bad:
        lines.append(
            f"    INCONSISTENT: r{d.get('round')}.{d.get('seq')} chose "
            f"{d.get('chosen')} but recorded scores argmax elsewhere"
        )
    return lines


def load_decisions(path: str | Path) -> list[dict[str, Any]]:
    """Decisions from an events JSONL file or a flight-recorder bundle."""
    p = Path(path)
    text = p.read_text().strip()
    if not text:
        return []
    if text.startswith("{") and p.suffix == ".json":
        bundle = json.loads(text)
        return iter_decisions(bundle.get("rounds") or [])
    records = [json.loads(ln) for ln in text.splitlines() if ln.strip()]
    return iter_decisions(records)
