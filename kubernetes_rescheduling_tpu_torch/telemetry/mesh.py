"""The mesh and device plane — the port of
``kubernetes_rescheduling_tpu.telemetry.mesh``: per-device telemetry over
the dp fleet planes (``parallel/fleet.py``, ``bench/multichip.py``), the
device-axis rollup, and the profiler gate behind ``POST /profile`` and
``--profile-rounds``.

- :func:`attribute_dispatch`: a host-measured quantity (the fenced
  dispatch wall, the pulled bundle's bytes) attributed across the dp
  devices by each device's share of a per-tenant weight column that rides
  the round-end read already (tenants map to dp ranks in blocks). An
  attribution, not a per-device clock, and no new transfer.
- :func:`device_rollup_matrix` / :func:`decode_device_rollup`: the tenant
  rollup's layout on the device axis (nearest-rank quantiles with
  ``fleet_rollup._quantile_positions``, sums, worst-k), in numpy on the
  host — the matrix is ``[n_devices, 3]``. Published as bounded families
  (:func:`publish_device_rollup`); device names ride events
  (:func:`device_rollup_event`) and ``GET /devices``, never label keys.
- :class:`DeviceSeries`: the budget-gated gateway of the ``device``-labeled
  families (``TenantSeries`` on the device axis).
- :class:`MeshPlane`: the per-run accumulator the fleet loop and
  ``bench_multichip`` feed once a round or block; it serves the
  ``/healthz`` ``mesh`` stanza, ``/devices`` and the ``mesh_imbalance``
  rule. Its HBM column is each card's allocated memory
  (``costmodel.sample_device_memory``, host bookkeeping): a rank reads its
  own card (:func:`rank_hbm_mb`) and the others' values arrive in the dp
  plane's gather, one f32 a rank.
- :class:`ProfilerGate` (with ``ProfilerBusy`` / ``ProfilerExhausted``):
  bounded on-demand ``torch.profiler`` captures into the flight-recorder
  bundle directory.

Until a mesh plane binds, ``GET /devices`` answers 404, as in the JAX
package.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any

import numpy as np

from kubernetes_rescheduling_tpu_torch.telemetry import costmodel
from kubernetes_rescheduling_tpu_torch.telemetry.fleet_rollup import _quantile_positions
from kubernetes_rescheduling_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    get_registry,
)
from kubernetes_rescheduling_tpu_torch.telemetry.spans import start_profiler, stop_profiler

# the device rollup's dimensions, in matrix-column order: per device, this
# round's attributed step time, attributed round-end transfer volume, and
# allocated card memory (0 without a card)
DEVICE_DIMS: tuple[str, ...] = ("step_ms", "transfer_mb", "hbm_mb")
NUM_DEVICE_DIMS = len(DEVICE_DIMS)
# quantile points, shared with the tenant rollup (nearest-rank)
DEVICE_QUANTS: tuple[str, ...] = ("p50", "p90", "p99", "max")
NUM_DEVICE_QUANTS = len(DEVICE_QUANTS)


def device_rollup_size(worst_k: int) -> int:
    """Flat length of one device rollup vector: per dimension, the quantile
    points, one sum, and worst-k (value, device-index) pairs."""
    return NUM_DEVICE_DIMS * (NUM_DEVICE_QUANTS + 1 + 2 * worst_k)


def device_rollup_matrix(matrix: np.ndarray, *, worst_k: int) -> np.ndarray:
    """``f32[n_devices, NUM_DEVICE_DIMS]`` → one flat rollup vector
    (quantiles, sums, worst-k values, worst-k device indices, each
    dimension-major), nearest-rank quantiles and ties to the lower device
    index. ``worst_k`` must already be clamped to ``<= n_devices``."""
    m = np.asarray(matrix, dtype=np.float32)
    if m.ndim != 2 or m.shape[1] != NUM_DEVICE_DIMS:
        raise ValueError(f"device rollup needs [n_devices, {NUM_DEVICE_DIMS}], got {m.shape}")
    n = m.shape[0]
    if not (1 <= worst_k <= n):
        raise ValueError(f"worst_k must be in [1, {n}], got {worst_k}")
    pos = list(_quantile_positions(n))
    quants = np.empty((NUM_DEVICE_DIMS, NUM_DEVICE_QUANTS), np.float32)
    vals = np.empty((NUM_DEVICE_DIMS, worst_k), np.float32)
    idx = np.empty((NUM_DEVICE_DIMS, worst_k), np.float32)
    for d in range(NUM_DEVICE_DIMS):
        col = m[:, d]
        quants[d] = np.sort(col)[pos]
        order = np.argsort(-col, kind="stable")[:worst_k]
        vals[d] = col[order]
        idx[d] = order.astype(np.float32)
    sums = m.sum(axis=0, dtype=np.float32)
    return np.concatenate([quants.ravel(), sums, vals.ravel(), idx.ravel()])


def decode_device_rollup(flat, *, worst_k: int) -> dict[str, Any]:
    """One device rollup vector as the structured dict the publisher, the
    ``mesh_imbalance`` rule and the events read."""
    flat = np.asarray(flat, dtype=np.float32)
    if flat.size != device_rollup_size(worst_k):
        raise ValueError(
            f"device rollup vector of {flat.size} values does not decode at "
            f"worst_k={worst_k} (expected {device_rollup_size(worst_k)})")
    nq = NUM_DEVICE_DIMS * NUM_DEVICE_QUANTS
    quants = flat[:nq].reshape(NUM_DEVICE_DIMS, NUM_DEVICE_QUANTS)
    sums = flat[nq:nq + NUM_DEVICE_DIMS]
    off = nq + NUM_DEVICE_DIMS
    vals = flat[off:off + NUM_DEVICE_DIMS * worst_k].reshape(NUM_DEVICE_DIMS, worst_k)
    idx = flat[off + NUM_DEVICE_DIMS * worst_k:].reshape(NUM_DEVICE_DIMS, worst_k)
    idx = idx.astype(np.int64)
    return {
        "worst_k": worst_k,
        "dims": {
            dim: {
                "quantiles": {q: float(quants[d, j]) for j, q in enumerate(DEVICE_QUANTS)},
                "sum": float(sums[d]),
                "worst": [{"device": int(idx[d, r]), "value": float(vals[d, r])}
                          for r in range(worst_k)],
            }
            for d, dim in enumerate(DEVICE_DIMS)
        },
    }


def attribute_dispatch(total: float, weights, *, n: int) -> np.ndarray:
    """``total`` (a host-measured wall or byte count) attributed across
    ``n`` dp devices by the blockwise sums of the per-tenant ``weights``
    (tenant block ``j`` runs on device ``j``). Degenerate weights —
    absent, of a length ``n`` does not divide, non-finite, negative, or
    summing to zero — split evenly, so the rollup is always defined."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    out = np.full(n, float(total) / n, dtype=np.float64)
    if weights is None:
        return out
    w = np.asarray(weights, dtype=np.float64).ravel()
    if w.size < n or w.size % n:
        return out
    if not np.all(np.isfinite(w)) or np.any(w < 0):
        return out
    shard = w.reshape(n, -1).sum(axis=1)
    s = float(shard.sum())
    if s <= 0.0:
        return out
    return float(total) * shard / s


def publish_device_rollup(registry: MetricsRegistry, rollup: dict[str, Any], *,
                          n_devices: int) -> float:
    """The rollup as bounded families (quantiles, worst-k values, the
    imbalance ratio, the device count); returns the imbalance ratio
    (worst/median attributed step time, 0 while the median is 0)."""
    dims = rollup["dims"]
    quantile_gauges = (
        ("step_ms", registry.gauge(
            "mesh_step_ms_quantile",
            "per-device attributed step-time quantile across the dp mesh for the most "
            "recent fleet round (q = p50|p90|p99|max; dispatch-wall attribution, not a "
            "per-device clock)", labelnames=("q",))),
        ("transfer_mb", registry.gauge(
            "mesh_transfer_mb_quantile",
            "per-device attributed round-end transfer-volume quantile across the dp mesh "
            "(q = p50|p90|p99|max)", labelnames=("q",))),
        ("hbm_mb", registry.gauge(
            "mesh_hbm_mb_quantile",
            "per-device allocated card-memory quantile across the dp mesh "
            "(q = p50|p90|p99|max; 0 without a card)", labelnames=("q",))),
    )
    for dim, g in quantile_gauges:
        for q, v in dims[dim]["quantiles"].items():
            g.labels(q=q).set(v)
    worst = registry.gauge(
        "mesh_worst_device",
        "metric value of the rank-th worst device per rollup dimension "
        "(dim = step_ms|transfer_mb|hbm_mb); device NAMES ride the device_rollup event "
        "payload and /devices, never label keys", labelnames=("rank", "dim"))
    for dim in DEVICE_DIMS:
        for rank, row in enumerate(dims[dim]["worst"]):
            worst.labels(rank=str(rank), dim=dim).set(row["value"])
    step = dims["step_ms"]["quantiles"]
    median = step["p50"]
    ratio = step["max"] / median if median > 0 else 0.0
    registry.gauge(
        "mesh_imbalance_ratio",
        "worst/median attributed device step time for the most recent fleet round — the "
        "mesh_imbalance watchdog rule's input (0 until a round is observed or while the "
        "median is 0)").set(ratio)
    registry.gauge(
        "mesh_devices",
        "devices carrying the dp fleet plane (cardinality bound for every device-labeled "
        "family)").set(float(n_devices))
    return ratio


def device_rollup_event(rollup: dict[str, Any], device_names, *,
                        round: int | None = None) -> dict[str, Any]:
    """The JSON-able ``device_rollup`` event: quantiles and sums per
    dimension and the worst-k rows with device names attached."""
    dims = rollup["dims"]
    return {
        **({"round": round} if round is not None else {}),
        "worst_k": rollup["worst_k"],
        "quantiles": {dim: dict(dims[dim]["quantiles"]) for dim in DEVICE_DIMS},
        "sums": {dim: dims[dim]["sum"] for dim in DEVICE_DIMS},
        "worst": [
            {"dim": dim, "rank": rank,
             "device": (str(device_names[row["device"]])
                        if 0 <= row["device"] < len(device_names) else str(row["device"])),
             "value": row["value"]}
            for dim in DEVICE_DIMS
            for rank, row in enumerate(dims[dim]["worst"])
        ],
    }


def rank_hbm_mb(device) -> float:
    """This rank's card's allocated memory in MB, from
    ``costmodel.sample_device_memory`` (0.0 on the CPU)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return 0.0
    label = f"cuda:{dev.index if dev.index is not None else torch.cuda.current_device()}"
    for s in costmodel.sample_device_memory():
        if s["device"] == label and s.get("bytes_in_use") is not None:
            return float(s["bytes_in_use"]) / 2**20
    return 0.0


class DeviceSeries:
    """THE budget-gated gateway of device-labeled families — ``TenantSeries``
    on the device axis. At or under ``budget`` devices (None: unlimited)
    the per-device families emit; over it every update is suppressed and
    counted ``device_series_suppressed_total{family}``."""

    def __init__(self, registry, *, devices: int, budget: int | None):
        self.registry = registry
        self.devices = int(devices)
        self.budget = budget
        self.enabled = budget is None or self.devices <= int(budget)

    def _suppress(self, family: str) -> None:
        self.registry.counter(
            "device_series_suppressed_total",
            "per-device metric series updates suppressed by the "
            "ObsConfig.device_label_budget cardinality gate — the mesh is over budget; "
            "read the bounded mesh rollup families (mesh_*_quantile, mesh_worst_device) "
            "instead", labelnames=("family",)).labels(family=family).inc()

    def counter_inc(self, name: str, help: str, device: str, amount: float = 1.0) -> None:
        if self.enabled:
            self.registry.counter(name, help, labelnames=("device",)).labels(
                device=device).inc(amount)
        else:
            self._suppress(name)

    def gauge_set(self, name: str, help: str, device: str, value: float) -> None:
        if self.enabled:
            self.registry.gauge(name, help, labelnames=("device",)).labels(
                device=device).set(value)
        else:
            self._suppress(name)


class MeshPlane:
    """The device plane's per-run accumulator.

    Fed once a fleet round (or scan block) with host values that exist
    already — the fenced dispatch wall, the pulled bundles' bytes, the
    per-tenant cost column of the round end, and with a dp plane the
    gathered per-rank HBM — it attributes them across the dp devices,
    publishes the bounded rollup and the budget-gated per-device series,
    and holds the latest rollup for ``/healthz``, ``/devices`` and the
    ``mesh_imbalance`` rule. Reads are thread-safe (the ops server walks it
    from request threads)."""

    def __init__(self, registry: MetricsRegistry | None = None, *, device_names,
                 budget: int | None = None, worst_k: int = 3,
                 sample_memory: bool = True) -> None:
        self.registry = registry if registry is not None else get_registry()
        self.device_names = tuple(str(d) for d in device_names)
        if not self.device_names:
            raise ValueError("MeshPlane needs at least one device name")
        n = len(self.device_names)
        self.worst_k = max(1, min(int(worst_k), n))
        self.series = DeviceSeries(self.registry, devices=n, budget=budget)
        self.sample_memory = sample_memory
        self.rounds = 0
        self.blocks = 0
        self._step_ms = np.zeros(n, np.float64)
        self._transfer_mb_total = np.zeros(n, np.float64)
        self._hbm_mb = np.zeros(n, np.float64)
        self._latest: dict[str, Any] | None = None
        self._latest_event: dict[str, Any] | None = None
        self._imbalance = 0.0
        self._lock = threading.Lock()

    @property
    def n_devices(self) -> int:
        return len(self.device_names)

    def _sample_hbm_mb(self) -> np.ndarray:
        """This process's view of each named card's allocated memory (the
        cards it allocates on; the others read 0)."""
        out = np.zeros(self.n_devices, np.float64)
        if not self.sample_memory:
            return out
        by_name = {s["device"]: s for s in costmodel.sample_device_memory(self.registry)}
        for i, name in enumerate(self.device_names):
            s = by_name.get(name)
            if s and s.get("bytes_in_use") is not None:
                out[i] = float(s["bytes_in_use"]) / 2**20
        return out

    def observe_block(self, *, dispatch_s: float, transfer_bytes: float, weights=None,
                      rounds: int = 1, round: int | None = None,
                      hbm_mb=None) -> tuple[dict[str, Any], dict[str, Any]]:
        """One round-end observation: attribute the block's dispatch wall and
        transfer bytes across the mesh, roll up, publish. ``hbm_mb`` is the
        per-device memory the dp plane gathered (sampled here when None).
        Returns ``(summary, event)``: the watchdog feed and ``/healthz``
        stanza, and the named event."""
        n = self.n_devices
        rounds = max(1, int(rounds))
        step_ms = attribute_dispatch(dispatch_s, weights, n=n) / rounds * 1e3
        transfer_mb = attribute_dispatch(transfer_bytes, weights, n=n) / 2**20
        if hbm_mb is not None and self.sample_memory:
            hbm_mb = np.asarray(hbm_mb, dtype=np.float64).reshape(n)
        else:
            hbm_mb = self._sample_hbm_mb()
        matrix = np.stack([step_ms, transfer_mb, hbm_mb], axis=1)
        rollup = decode_device_rollup(device_rollup_matrix(matrix, worst_k=self.worst_k),
                                      worst_k=self.worst_k)
        ratio = publish_device_rollup(self.registry, rollup, n_devices=n)
        for i, name in enumerate(self.device_names):
            self.series.gauge_set(
                "mesh_device_step_ms",
                "attributed per-round step time of one dp device for the most recent fleet "
                "round (budget-gated; over ObsConfig.device_label_budget read the mesh_* "
                "rollups)", name, float(step_ms[i]))
            self.series.counter_inc(
                "mesh_device_transfer_mb_total",
                "round-end transfer volume attributed to one dp device (budget-gated twin "
                "of device_transfer_bytes_total's site-keyed totals)", name,
                float(transfer_mb[i]))
        worst_i = int(np.argmax(step_ms))
        event = device_rollup_event(rollup, self.device_names, round=round)
        summary = {
            **({"round": round} if round is not None else {}),
            "n_devices": n,
            "ratio": float(ratio),
            "worst_device": self.device_names[worst_i],
            "step_ms_p50": rollup["dims"]["step_ms"]["quantiles"]["p50"],
            "step_ms_max": rollup["dims"]["step_ms"]["quantiles"]["max"],
        }
        with self._lock:
            self.rounds += rounds
            self.blocks += 1
            self._step_ms = step_ms
            self._transfer_mb_total += transfer_mb
            self._hbm_mb = hbm_mb
            self._latest = rollup
            self._latest_event = event
            self._imbalance = float(ratio)
        return summary, event

    def health_block(self) -> dict[str, Any]:
        """The ``/healthz`` ``mesh`` stanza: bounded whatever the mesh size."""
        with self._lock:
            out: dict[str, Any] = {"devices": self.n_devices, "rounds": self.rounds,
                                   "blocks": self.blocks,
                                   "imbalance_ratio": round(self._imbalance, 4)}
            if self._latest is not None:
                out["step_ms"] = {q: round(v, 4) for q, v in
                                  self._latest["dims"]["step_ms"]["quantiles"].items()}
                out["worst_device"] = self.device_names[int(np.argmax(self._step_ms))]
            return out

    def overview(self) -> dict[str, Any]:
        """The ``/devices`` drill-down: one named row a device."""
        with self._lock:
            return {
                "devices": [
                    {"device": name, "step_ms": round(float(self._step_ms[i]), 4),
                     "transfer_mb_total": round(float(self._transfer_mb_total[i]), 4),
                     "hbm_mb": round(float(self._hbm_mb[i]), 4)}
                    for i, name in enumerate(self.device_names)
                ],
                "rounds": self.rounds,
                "blocks": self.blocks,
                "imbalance_ratio": round(self._imbalance, 4),
                "budget_enabled": self.series.enabled,
                "rollup": self._latest_event,
            }


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
