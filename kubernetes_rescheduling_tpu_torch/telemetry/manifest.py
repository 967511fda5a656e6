"""Per-run provenance manifest: config, devices, versions, git rev — the
port of ``kubernetes_rescheduling_tpu.telemetry.manifest``.

A metrics dump without the run that produced it is noise; the manifest
makes every ``--metrics-out``/``--trace-out`` artifact and every
flight-recorder bundle self-describing — what command ran, on which card,
with which torch and CUDA, from which commit. Where the JAX package
records jax's devices, the port records torch's and the CUDA devices'
facts; ``device_costs`` holds the port's compiled-cost book
(``costmodel.py``: one snapshot a captured graph) and the allocator's live
memory sample.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path
from typing import Any


def _git_rev(cwd: str | None = None) -> dict[str, Any] | None:
    try:
        rev = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5, cwd=cwd,
        )
        if rev.returncode != 0:
            return None
        dirty = subprocess.run(
            ["git", "status", "--porcelain"],
            capture_output=True, text=True, timeout=5, cwd=cwd,
        )
        return {
            "rev": rev.stdout.strip(),
            "dirty": bool(dirty.stdout.strip()) if dirty.returncode == 0 else None,
        }
    except Exception:
        return None


def _torch_info() -> dict[str, Any]:
    """torch, CUDA and the card: version, the build's CUDA, and per device
    its name, capability, memory and SM count (none when no card)."""
    import torch

    info: dict[str, Any] = {
        "version": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "devices": [],
    }
    try:
        for i in range(torch.cuda.device_count() if info["cuda_available"] else 0):
            p = torch.cuda.get_device_properties(i)
            info["devices"].append({
                "index": i,
                "name": p.name,
                "capability": f"{p.major}.{p.minor}",
                "total_memory_mb": round(p.total_memory / 2**20, 1),
                "multi_processor_count": p.multi_processor_count,
            })
    except Exception as e:  # noqa: BLE001 — provenance must not fail the run
        info["error"] = str(e)
    return info


def _device_costs() -> dict[str, Any]:
    """The compiled-cost book (``costmodel.CostBook``: one snapshot a
    captured fn) and a live sample of each CUDA device's allocator counters
    (no device work), into a scratch registry so that writing a manifest
    leaves the process registry's gauges alone."""
    from kubernetes_rescheduling_tpu_torch.telemetry.costmodel import (
        get_costbook,
        sample_device_memory,
    )
    from kubernetes_rescheduling_tpu_torch.telemetry.registry import MetricsRegistry

    try:
        return {"kernels": get_costbook().as_dict(),
                "device_memory": sample_device_memory(MetricsRegistry())}
    except Exception:  # noqa: BLE001 — provenance must not fail the run
        return {"kernels": {}, "device_memory": []}


def _attribution_book() -> dict[str, Any]:
    """Latest per-algorithm cost-attribution summary (where the
    communication cost sits: total, top edge, moves tracked) — the
    topology-plane half of the provenance; best-effort."""
    from kubernetes_rescheduling_tpu_torch.telemetry.attribution import (
        get_attribution_book,
    )

    try:
        return get_attribution_book().as_dict()
    except Exception:  # noqa: BLE001 — provenance must not fail the run
        return {}


def run_manifest(config: dict[str, Any] | None = None) -> dict[str, Any]:
    import numpy as np

    return {
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "argv": list(sys.argv),
        "config": config,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "hostname": platform.node(),
        "pid": os.getpid(),
        "numpy": np.__version__,
        "torch": _torch_info(),
        "device_costs": _device_costs(),
        "attribution": _attribution_book(),
        "git": _git_rev(cwd=str(Path(__file__).resolve().parent)),
    }


def write_manifest(
    path: str | Path, config: dict[str, Any] | None = None
) -> dict[str, Any]:
    m = run_manifest(config)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(m, indent=2, default=str))
    return m
