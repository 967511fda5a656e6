"""Metric sinks — the port of ``kubernetes_rescheduling_tpu.bench.sinks``.

CSV files keep the reference's exact schemas so existing analysis tooling
works unchanged: ``node_std.csv`` with ``timestamp,cpu_std`` (reference
nodemonitor.py:59-73) and ``communication_cost.csv`` with ``timestamp,cost``
(reference communicationcost.py:52-64). JSONL is the structured superset.
"""

from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Any


@dataclass
class CsvSink:
    """Append-only CSV with a header row on first write (reference
    nodemonitor.py:63-73 semantics)."""

    path: str | Path
    columns: tuple[str, ...] = ("timestamp", "value")

    def append(self, *values: Any) -> None:
        p = Path(self.path)
        p.parent.mkdir(parents=True, exist_ok=True)
        exists = p.is_file()
        with p.open("a", newline="") as f:
            w = csv.writer(f)
            if not exists:
                w.writerow(self.columns)
            ts = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
            w.writerow([ts, *values])


@dataclass
class JsonlSink:
    """One JSON object per line."""

    path: str | Path

    def append(self, record: dict[str, Any]) -> None:
        p = Path(self.path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with p.open("a") as f:
            f.write(json.dumps(record, default=float) + "\n")


def node_std_sink(directory: str | Path) -> CsvSink:
    return CsvSink(Path(directory) / "node_std.csv", ("timestamp", "cpu_std"))


def communication_cost_sink(directory: str | Path) -> CsvSink:
    return CsvSink(Path(directory) / "communication_cost.csv", ("timestamp", "cost"))
