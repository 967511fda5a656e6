"""Structured logging — the port of
``kubernetes_rescheduling_tpu.utils.logging`` (pure host code).

One JSON object per event, to a file, a stream, or only the in-memory ring
of the newest ``max_records`` events (a controller logs one event per round
forever; the file and stream sinks see every event). The JAX package's
per-tenant ring shares belong to its fleet loop, which the port does not
carry yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import collections
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import IO, Any

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}


@dataclass
class StructuredLogger:
    """JSONL event logger with an optional echo to stderr."""

    name: str = "krt"
    path: str | Path | None = None
    stream: IO | None = None
    level: str = "info"
    echo: bool = False
    max_records: int = 4096

    _records: collections.deque = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self._records = collections.deque(maxlen=max(self.max_records, 0))

    def log(self, level: str, event: str, **fields: Any) -> None:
        if _LEVELS.get(level, 20) < _LEVELS.get(self.level, 20):
            return
        rec = {"ts": time.time(), "level": level, "logger": self.name, "event": event,
               **fields}
        self._records.append(rec)
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
        return list(self._records)


_loggers: dict[str, StructuredLogger] = {}


def get_logger(name: str = "krt", **kwargs: Any) -> StructuredLogger:
    if name not in _loggers:
        _loggers[name] = StructuredLogger(name=name, **kwargs)
    return _loggers[name]
