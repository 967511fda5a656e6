"""Transfer and backend-call accounting — the port of the host half of
``kubernetes_rescheduling_tpu.telemetry.accounting``.

:func:`pull` is the one way the control loop reads the device: it copies a
tensor to the host and counts the transfer as
``device_transfers_total{site=...}``; :func:`pull_arrays` packs several
tensors of mixed dtypes into one such transfer. :func:`timed_call` and
:func:`count_reconcile` instrument the backends. The JAX package's
``instrument_jit`` counts compilations; the port compiles nothing, so it
has no counterpart (a counter of CUDA-graph captures comes with the
compiled round).
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
