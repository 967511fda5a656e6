"""The profiler gate behind ``POST /profile`` and ``--profile-rounds`` — the
port of ``ProfilerGate`` from ``kubernetes_rescheduling_tpu.telemetry.mesh``
(with ``ProfilerBusy`` / ``ProfilerExhausted``): bounded on-demand
``torch.profiler`` captures into the flight-recorder bundle directory.

The rest of that module — the mesh and device plane (``MeshPlane``,
``DeviceSeries``, the ``mesh_imbalance`` feed behind ``GET /devices``) —
runs with the dp fleet planes, ROADMAP Queue 1 item 5; until a mesh plane
binds, ``GET /devices`` answers 404 as in the JAX package.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any

from kubernetes_rescheduling_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    get_registry,
)
from kubernetes_rescheduling_tpu_torch.telemetry.spans import start_profiler, stop_profiler


class ProfilerBusy(RuntimeError):
    """A capture is already armed or in flight (one at a time)."""


class ProfilerExhausted(RuntimeError):
    """The process's ``profile_max_captures`` hard cap is spent."""


class ProfilerGate:
    """On-demand ``torch.profiler`` capture with hard caps.

    ``request(rounds)`` arms the gate (``POST /profile`` and
    ``--profile-rounds`` both land here); the run loop calls
    ``maybe_start`` at a capture boundary and ``advance`` after each
    committed round, so a capture covers exactly one scan block or N
    per-round fleet rounds. Caps are HARD: one capture armed-or-active
    at a time (:class:`ProfilerBusy`), at most ``max_captures`` per
    process (:class:`ProfilerExhausted`), and artifacts over ``max_mb``
    are DELETED, not kept (a runaway trace must not fill the bundle
    dir). Every finished capture counts
    ``profile_captures_total{status}`` and dumps a ``profile_capture``
    flight-recorder bundle referencing the artifact."""

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        *,
        artifact_dir: str,
        max_captures: int = 4,
        max_mb: float = 256.0,
        recorder=None,
        logger=None,
    ) -> None:
        self.registry = registry if registry is not None else get_registry()
        self.artifact_dir = str(artifact_dir)
        self.max_captures = int(max_captures)
        self.max_mb = float(max_mb)
        self.recorder = recorder
        self.logger = logger
        self.captures: list[dict[str, Any]] = []
        self._pending = 0
        self._active: dict[str, Any] | None = None
        self._seq = 0
        self._prof = None
        self._lock = threading.Lock()

    # seams for the capture backend — tests monkeypatch these; the run
    # path uses the real torch.profiler
    def _start_backend(self, log_dir: str) -> None:
        self._prof = (start_profiler(), log_dir)

    def _stop_backend(self) -> None:
        prof, log_dir = self._prof
        self._prof = None
        stop_profiler(prof, log_dir)

    def request(self, rounds: int = 1) -> dict[str, Any]:
        """Arm the next capture for ``rounds`` rounds (a scan block
        rounds this up to the block). Raises on a busy gate or a spent
        cap — the HTTP front maps both to 409."""
        rounds = int(rounds)
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        with self._lock:
            if self._pending or self._active is not None:
                raise ProfilerBusy(
                    "a profiler capture is already armed or in flight "
                    "(one at a time)"
                )
            if self._seq >= self.max_captures:
                raise ProfilerExhausted(
                    f"profile_max_captures={self.max_captures} captures "
                    "already taken this process"
                )
            self._pending = rounds
            return {
                "armed": True,
                "rounds": rounds,
                "capture": self._seq,
                "captures_left": self.max_captures - self._seq,
            }

    def maybe_start(
        self,
        *,
        label: str,
        rounds: int | None = None,
        round: int | None = None,
    ) -> bool:
        """Start the armed capture, if any. ``rounds`` overrides the
        requested span when the capture boundary is coarser (a scan
        block is atomic — the capture covers the whole block)."""
        with self._lock:
            if not self._pending or self._active is not None:
                return False
            span = int(rounds) if rounds is not None else self._pending
            self._pending = 0
            seq = self._seq
            self._seq += 1
        log_dir = os.path.join(self.artifact_dir, f"profile_{seq:03d}")
        os.makedirs(log_dir, exist_ok=True)
        try:
            self._start_backend(log_dir)
        except Exception as e:  # noqa: BLE001 — profiler is optional
            self._record(
                {
                    "capture": seq,
                    "label": label,
                    "dir": log_dir,
                    "rounds": span,
                    "start_round": round,
                    "bytes": 0,
                    "status": "error",
                    "error": f"{type(e).__name__}: {e}",
                }
            )
            return False
        with self._lock:
            self._active = {
                "capture": seq,
                "label": label,
                "dir": log_dir,
                "rounds": span,
                "rounds_left": span,
                "start_round": round,
                "t0": time.perf_counter(),
            }
        return True

    def advance(self, rounds: int = 1) -> None:
        """Count ``rounds`` committed rounds against the active capture;
        finishes it when the span is covered."""
        with self._lock:
            a = self._active
            if a is None:
                return
            a["rounds_left"] -= int(rounds)
            if a["rounds_left"] > 0:
                return
            self._active = None
        self._finish(a)

    def _finish(self, a: dict[str, Any]) -> None:
        wall_s = time.perf_counter() - a.pop("t0")
        a.pop("rounds_left", None)
        try:
            self._stop_backend()
            size = _dir_bytes(a["dir"])
            status = "ok"
            if size / 2**20 > self.max_mb:
                # hard size cap: an artifact the bundle dir cannot
                # afford is evidence lost, loudly — never disk filled
                shutil.rmtree(a["dir"], ignore_errors=True)
                status = "oversize"
        except Exception as e:  # noqa: BLE001
            size = 0
            status = "error"
            a["error"] = f"{type(e).__name__}: {e}"
        self._record(
            {**a, "bytes": size, "status": status, "wall_s": round(wall_s, 4)}
        )

    def _record(self, summary: dict[str, Any]) -> None:
        self.registry.counter(
            "profile_captures_total",
            "on-demand torch.profiler captures finished, by status "
            "(ok | oversize — artifact exceeded profile_max_mb and was "
            "deleted | error)",
            labelnames=("status",),
        ).labels(status=summary["status"]).inc()
        self.captures.append(summary)
        if self.logger is not None:
            self.logger.info("profile_capture", **summary)
        if self.recorder is not None:
            # the bundle is the reference: an operator finding the
            # flight-recorder dir sees which profile_NNN dir belongs to
            # which capture, and whether it survived the size cap
            self.recorder.dump("profile_capture", profile=dict(summary))

    def status(self) -> dict[str, Any]:
        with self._lock:
            return {
                "pending_rounds": self._pending,
                "active": (
                    {
                        k: v
                        for k, v in self._active.items()
                        if k != "t0"
                    }
                    if self._active is not None
                    else None
                ),
                "captures": [dict(c) for c in self.captures],
                "max_captures": self.max_captures,
                "max_mb": self.max_mb,
            }


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total
