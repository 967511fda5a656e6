"""Checkpoint/resume for multi-round runs — the port of
``kubernetes_rescheduling_tpu.utils.checkpoint``, in the same on-disk
format: ``<path>.npz`` holds the ``ClusterState`` arrays (``_ARRAY_FIELDS``,
each in its numpy dtype: f32 loads and capacities, bool masks, i32 indices)
and ``<path>.json`` the name tuples and the caller's ``extra``. A checkpoint
either package writes loads in the other.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState
from kubernetes_rescheduling_tpu_torch.telemetry.accounting import pull_arrays
from kubernetes_rescheduling_tpu_torch.telemetry.registry import MetricsRegistry

CHECKPOINT_SITE = "checkpoint"

_ARRAY_FIELDS = (
    "node_cpu_cap",
    "node_mem_cap",
    "node_base_cpu",
    "node_base_mem",
    "node_valid",
    "node_lex_rank",
    "pod_node",
    "pod_service",
    "pod_cpu",
    "pod_mem",
    "pod_valid",
)


def save_state(state: ClusterState, path: str | Path, extra: dict | None = None, *,
               registry: MetricsRegistry | None = None) -> None:
    """Write ``<path>.npz`` (arrays) + ``<path>.json`` (names, extra). The
    arrays come home in one counted transfer (``site="checkpoint"``).

    Extensions are appended, never substituted. Each file is written to a
    temporary name, fsynced and moved into place with ``os.replace``, the
    ``.json`` before the ``.npz`` (which is what :meth:`CheckpointManager.latest`
    looks for), so a kill at any point leaves no torn checkpoint."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp_npz = Path(f"{p}.tmp.npz")  # numpy insists on the .npz extension
    with open(tmp_npz, "wb") as f:
        np.savez_compressed(f, **pull_arrays({a: getattr(state, a) for a in _ARRAY_FIELDS},
                                             CHECKPOINT_SITE, registry))
        f.flush()
        os.fsync(f.fileno())
    meta = {
        "node_names": list(state.node_names),
        "pod_names": list(state.pod_names),
        "extra": extra or {},
    }
    tmp_json = Path(f"{p}.json.tmp")
    with open(tmp_json, "w") as f:
        f.write(json.dumps(meta, default=float))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_json, f"{p}.json")
    os.replace(tmp_npz, f"{p}.npz")


def _read(path: str | Path) -> tuple[dict[str, np.ndarray], dict]:
    """The host half of :func:`load_state`: the arrays and the metadata."""
    p = Path(path)
    with np.load(f"{p}.npz") as arrays:
        host = {f: arrays[f] for f in _ARRAY_FIELDS}
    return host, json.loads(Path(f"{p}.json").read_text())


def _upload(host: dict[str, np.ndarray], meta: dict, device: torch.device
            ) -> tuple[ClusterState, dict]:
    state = ClusterState(
        **{f: torch.as_tensor(a, device=device) for f, a in host.items()},
        node_names=tuple(meta["node_names"]),
        pod_names=tuple(meta["pod_names"]),
    )
    return state, meta.get("extra", {})


def load_state(path: str | Path, device: str | torch.device | None = DEFAULT_DEVICE
               ) -> tuple[ClusterState, dict]:
    """Inverse of :func:`save_state`; returns ``(state, extra)`` with the
    state's tensors on ``device`` (the card unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    return _upload(*_read(path), dev)


@dataclass
class CheckpointManager:
    """Per-round checkpoints (``round_NNNNNN``) with latest-resume; the
    newest ``keep`` survive."""

    directory: str | Path
    keep: int = 5

    def save(self, round_num: int, state: ClusterState, extra: dict | None = None, *,
             registry: MetricsRegistry | None = None) -> Path:
        d = Path(self.directory)
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"round_{round_num:06d}"
        save_state(state, path, extra={"round": round_num, **(extra or {})}, registry=registry)
        self._gc()
        return path

    def latest(self, device: str | torch.device | None = DEFAULT_DEVICE
               ) -> tuple[int, ClusterState, dict] | None:
        """The most recent loadable checkpoint, or None (start from round
        1). One a crash left unreadable is skipped for the one before it;
        a failure to place the state on ``device`` is raised, not skipped."""
        dev = resolve_device(device)
        for r in reversed(self._rounds()):
            try:
                host, meta = _read(Path(self.directory) / f"round_{r:06d}")
            except Exception:  # noqa: BLE001 — a torn file falls back a round
                continue
            return (r, *_upload(host, meta, dev))
        return None

    def _rounds(self) -> list[int]:
        d = Path(self.directory)
        if not d.is_dir():
            return []
        return sorted(
            int(f.stem.split("_")[1])
            for f in d.glob("round_*.npz")
            if not f.stem.endswith(".tmp")  # half-written leftovers
        )

    def _gc(self) -> None:
        d = Path(self.directory)
        rounds = self._rounds()
        for r in rounds[: -self.keep] if self.keep > 0 else []:
            for suffix in (".npz", ".json"):
                (d / f"round_{r:06d}{suffix}").unlink(missing_ok=True)
        # leftovers of a crash between the writes and the renames
        for tmp in (*d.glob("round_*.tmp.npz"), *d.glob("round_*.json.tmp")):
            tmp.unlink(missing_ok=True)
        live = {f"round_{r:06d}" for r in rounds}
        for meta in d.glob("round_*.json"):
            if meta.stem not in live:
                meta.unlink(missing_ok=True)
