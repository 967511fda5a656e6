"""Transfer and backend-call accounting — the port of the host half of
``kubernetes_rescheduling_tpu.telemetry.accounting``.

:func:`pull` is the one way the control loop reads the device: it copies a
tensor to the host and counts the transfer as
``device_transfers_total{site=...}``; :func:`pull_arrays` packs several
tensors of mixed dtypes into one such transfer. :func:`timed_call` and
:func:`count_reconcile` instrument the backends, and
:func:`publish_round_telemetry` surfaces a ``run_rounds`` record. The JAX package's
``instrument_jit`` counts compilations as ``jax_traces_total{fn=...}``;
the port's counterpart is ``cuda_graph_captures_total{fn=...}``, counted
by the capture cache of ``solver/compiled.py`` once per captured solve
shape.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch.telemetry.registry import MetricsRegistry, get_registry


def pull(x: torch.Tensor, site: str = "unnamed",
         registry: MetricsRegistry | None = None) -> np.ndarray:
    """Materialize a tensor on the host (one device→host copy, which waits
    for the work that produces it) and count it as
    ``device_transfers_total{site=...}`` and its bytes."""
    reg = registry if registry is not None else get_registry()
    reg.counter(
        "device_transfers_total",
        "device->host pulls through telemetry.pull",
        labelnames=("site",),
    ).labels(site=site).inc()
    out = x.detach().cpu().numpy()
    reg.counter(
        "device_transfer_bytes_total",
        "bytes pulled device->host through telemetry.pull",
        labelnames=("site",),
    ).labels(site=site).inc(float(out.nbytes))
    return out


def pull_arrays(parts: dict[str, torch.Tensor], site: str,
                registry: MetricsRegistry | None = None) -> dict[str, np.ndarray]:
    """Several tensors of any dtypes and shapes read back as ONE counted
    transfer (:func:`pull`): their bytes are packed into one buffer on the
    device and split on the host, so every value comes back exactly, in its
    own dtype and shape."""
    flat = torch.cat([p.detach().contiguous().reshape(-1).view(torch.uint8)
                      for p in parts.values()])
    host = pull(flat, site=site, registry=registry)
    out, off = {}, 0
    for name, p in parts.items():
        n = p.numel() * p.element_size()
        dtype = torch.empty((), dtype=p.dtype).numpy().dtype
        out[name] = host[off:off + n].copy().view(dtype).reshape(tuple(p.shape))
        off += n
    return out


@contextlib.contextmanager
def timed_call(backend: str, call: str, registry: MetricsRegistry | None = None):
    """Count one backend API call and observe its latency
    (``backend_calls_total`` / ``backend_call_seconds``)."""
    reg = registry if registry is not None else get_registry()
    reg.counter(
        "backend_calls_total", "backend API calls", labelnames=("backend", "call"),
    ).labels(backend=backend, call=call).inc()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        reg.histogram(
            "backend_call_seconds", "backend API call latency", labelnames=("backend", "call"),
        ).labels(backend=backend, call=call).observe(time.perf_counter() - t0)


def count_reconcile(backend: str, pods: int, registry: MetricsRegistry | None = None) -> None:
    """One reconcile wave (a Deployment re-create) that restarted ``pods``
    pods."""
    reg = registry if registry is not None else get_registry()
    reg.counter(
        "backend_reconciles_total", "reconcile waves applied by a backend",
        labelnames=("backend",),
    ).labels(backend=backend).inc()
    reg.counter(
        "backend_pods_restarted_total", "pods restarted by reconcile waves",
        labelnames=("backend",),
    ).labels(backend=backend).inc(max(int(pods), 0))


def publish_round_telemetry(tel, *, algorithm: str = "unknown",
                            registry: MetricsRegistry | None = None) -> dict[str, float]:
    """Surface a ``solver.round_loop.RoundTelemetry`` (one round, or
    :func:`~kubernetes_rescheduling_tpu_torch.solver.round_loop.run_rounds`'
    stacked rounds) through the registry: ``rounds_total`` and
    ``moves_total`` grow by its rounds and moves, the ``communication_cost``
    and ``load_std`` gauges take its last round's values. One counted host
    read (``site="round_telemetry"``) for the whole record; returns the
    summary it published."""
    reg = registry if registry is not None else get_registry()
    host = pull_arrays({"moved": tel.moved, "communication_cost": tel.communication_cost,
                        "load_std": tel.load_std}, site="round_telemetry", registry=reg)
    moved = host["moved"]
    cost = host["communication_cost"].astype(np.float64).reshape(-1)
    lstd = host["load_std"].astype(np.float64).reshape(-1)
    rounds, moves = int(moved.size), int(np.sum(moved))
    reg.counter("rounds_total", "rescheduling rounds executed",
                labelnames=("algorithm",)).labels(algorithm=algorithm).inc(rounds)
    reg.counter("moves_total", "rounds that moved a deployment",
                labelnames=("algorithm",)).labels(algorithm=algorithm).inc(moves)
    reg.gauge("communication_cost", "communication cost after the most recent round",
              labelnames=("algorithm",)).labels(algorithm=algorithm).set(float(cost[-1]))
    reg.gauge("load_std", "node CPU-% standard deviation after the most recent round",
              labelnames=("algorithm",)).labels(algorithm=algorithm).set(float(lstd[-1]))
    return {"rounds": rounds, "moves": moves, "communication_cost": float(cost[-1]),
            "load_std": float(lstd[-1])}
