"""Single-transfer round ends for the control loop — the port of
``kubernetes_rescheduling_tpu.bench.round_end``.

- :func:`round_end_metrics`: ``[communication_cost, load_std]`` of a
  snapshot as one f32 device tensor (the edge-list cost when an edge list is
  given).
- :class:`RoundCloser`: the round's device-resident pieces (the metrics,
  the solver's objectives) and host callbacks, pulled in ONE counted
  transfer (``device_transfers_total{site="round_end"}``) by
  :meth:`RoundCloser.flush`, then decoded in registration order.
- :func:`fence`: the apply boundary — decision tensors read back to the
  host as ONE batched copy of a stacked tensor, never element by element.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch.objectives.metrics import (
    communication_cost,
    communication_cost_edges,
    load_std,
)
from kubernetes_rescheduling_tpu_torch.telemetry.accounting import pull
from kubernetes_rescheduling_tpu_torch.telemetry.registry import MetricsRegistry

ROUND_END_SITE = "round_end"
FENCE_SITE = "fence"

# layout of the metrics head inside the round-end vector
METRIC_COST = 0
METRIC_LOAD_STD = 1


def round_end_metrics(state, graph, *, edges=None) -> torch.Tensor:
    """f32[2] ``[communication_cost, load_std]`` of ``state``, the cost over
    ``edges`` (``objectives.metrics.comm_edge_list``) when given, else the
    dense quadratic form."""
    if edges is None:
        cost = communication_cost(state, graph)
    else:
        cost = communication_cost_edges(state, graph.num_services, edges)
    return torch.stack([cost.float(), load_std(state).float()])


def dispatch_round_end(state, graph, *, edges=None) -> torch.Tensor:
    """Queue the round-end metrics on the device (no host sync)."""
    return round_end_metrics(state, graph, edges=edges)


def fence(parts: Sequence[torch.Tensor], registry: MetricsRegistry | None = None
          ) -> list[np.ndarray]:
    """The apply boundary: the integer or boolean tensors ``parts`` read
    back to the host as ONE copy of their concatenation, returned as numpy
    arrays of their own shapes (booleans as ``bool``, the rest as i64)."""
    flat = torch.cat([p.reshape(-1).long() for p in parts])
    host = pull(flat, site=FENCE_SITE, registry=registry)
    out, off = [], 0
    for p in parts:
        piece = host[off:off + p.numel()].reshape(tuple(p.shape))
        off += p.numel()
        out.append(piece.astype(bool) if p.dtype == torch.bool else piece)
    return out


class RoundCloser:
    """One per round: device-resident diagnostics in, ONE transfer out.

    ``defer(t, decode)`` registers a tensor and a callback receiving it as
    a numpy array of its shape (carried as f32); ``defer_host(decode)`` a
    callback with no payload. :meth:`flush` pulls every tensor piece in one
    counted transfer and runs the callbacks in registration order."""

    def __init__(self, registry: MetricsRegistry | None = None) -> None:
        self.registry = registry
        self._pieces: list[tuple[torch.Tensor | None, tuple, Callable]] = []
        self.flushed = False

    def defer(self, t: torch.Tensor, decode: Callable[[np.ndarray], None]) -> None:
        if self.flushed:
            raise RuntimeError("RoundCloser already flushed")
        self._pieces.append((t.reshape(-1).float(), tuple(t.shape), decode))

    def defer_host(self, decode: Callable[[], None]) -> None:
        if self.flushed:
            raise RuntimeError("RoundCloser already flushed")
        self._pieces.append((None, (), decode))

    def flush(self) -> None:
        """Close the round: one pull for every tensor piece (none when the
        round has only host callbacks), then the callbacks in order."""
        if self.flushed:
            raise RuntimeError("RoundCloser already flushed")
        self.flushed = True
        dev = [p for p, _, _ in self._pieces if p is not None]
        flat = (pull(torch.cat(dev), site=ROUND_END_SITE, registry=self.registry)
                if dev else None)
        off = 0
        for piece, shape, decode in self._pieces:
            if piece is None:
                decode()
                continue
            n = piece.numel()
            decode(flat[off:off + n].reshape(shape))
            off += n
