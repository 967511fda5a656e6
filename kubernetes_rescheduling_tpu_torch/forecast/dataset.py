"""Recorded round files — the part of
``kubernetes_rescheduling_tpu.forecast.dataset`` the port carries so far:
:func:`load_rounds`, which ``traces.adapters.rounds_to_trace`` reads the
loop's own telemetry with. The lag-feature datasets and the ``telemetry
dataset`` report wait with ROADMAP Queue 1 item 4.4.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterable


def load_rounds(paths: Iterable[str | Path]) -> list[dict[str, Any]]:
    """Round records from ``rounds.jsonl`` files (or flight-recorder bundle
    JSONs, whose ring nests each record under ``"record"``), in file order
    then line order."""
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
