"""Fleet mode, forecast plane: every tenant's forecaster in one body — the
port of ``kubernetes_rescheduling_tpu.forecast.fleet``.

The per-tenant state stacks to ``[T, ...]`` (:func:`init_fleet_forecast_state`).
:func:`fleet_forecast_step` runs the solo ``forecast_step`` once per tenant,
one after another, each on its own copy of its rows, so every tenant's
state, delta and diag are the solo step's bit for bit (the way
``solver.fleet_global`` runs solo solve bodies). On the card the body is one
replay of a graph captured per shape (``cuda_graph_captures_total{fn=
"fleet_forecast"}`` == 1 + promotions).

A masked tenant (``tenant_mask`` False: an open breaker or a dark backend)
is a select after the step: it keeps its old state and gives a zero delta
and a zero diag, so a skipped tenant round never trains its model, as the
solo loop's skipped rounds never reach its plane.

The diag matrix (f32[T, DIAG_SIZE]) stays on the device and rides the fleet
round's one decision read (``bench/fleet.py``), where ``forecast.plane.
decode_diag`` turns a read row into the tenant's ``RoundRecord.forecast``
block. ``repad_forecast_state`` grows a stacked state's node axis too.
"""

from __future__ import annotations

import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch.forecast.model import (
    FORECAST_FIELDS,
    ForecastState,
    forecast_params,
    init_forecast_state,
    repad_forecast_state,
    step_with_params,
)
from kubernetes_rescheduling_tpu_torch.solver.compiled import CACHE
from kubernetes_rescheduling_tpu_torch.solver.fleet import tenant_view
from kubernetes_rescheduling_tpu_torch.solver.global_solver import state_from_inputs, state_inputs


def init_fleet_forecast_state(lags: int, tenants: int, num_nodes: int,
                              device: str | torch.device | None = DEFAULT_DEVICE
                              ) -> ForecastState:
    """A fresh all-cold forecaster per tenant, stacked ``[T, ...]``."""
    if tenants < 1:
        raise ValueError(f"tenants must be >= 1, got {tenants}")
    f0 = init_forecast_state(lags, num_nodes, device=device)
    return ForecastState(**{k: torch.stack([getattr(f0, k)] * tenants)
                            for k in FORECAST_FIELDS})


def _fleet_body(t: dict, tenants: int) -> dict:
    states = state_from_inputs(t)
    fstates = ForecastState.from_tensors(t, "f:")
    mask, params = t["mask"], t["params"]
    kept, deltas, diags = [], [], []
    for i in range(tenants):
        old = tenant_view(fstates, i)
        new, delta, diag = step_with_params(tenant_view(states, i), old, params)
        active = mask[i]
        kept.append(ForecastState(**{k: torch.where(active, getattr(new, k), getattr(old, k))
                                     for k in FORECAST_FIELDS}))
        deltas.append(torch.where(active, delta, 0.0))
        diags.append(torch.where(active, diag, 0.0))
    out = {f"f:{k}": torch.stack([getattr(s, k) for s in kept]) for k in FORECAST_FIELDS}
    return {**out, "deltas": torch.stack(deltas), "diag": torch.stack(diags)}


def fleet_forecast_step(states, fstates: ForecastState, tenant_mask: torch.Tensor,
                        params: torch.Tensor):
    """One fleet forecast round over the stacked ``states`` (``solver.fleet.
    stack_tenants``): ``(fstates', deltas f32[T, N], diag f32[T,
    DIAG_SIZE])``, one replay on the card (``fn="fleet_forecast"``)."""
    T = int(tenant_mask.shape[0])
    inputs = {**state_inputs(states), **fstates.tensors("f:"),
              "mask": tenant_mask.to(states.device, torch.bool), "params": params}
    out = CACHE.run("fleet_forecast", (T,), inputs, lambda: lambda t: _fleet_body(t, T))
    return ForecastState.from_tensors(out, "f:"), out["deltas"], out["diag"]


class FleetForecastPlane:
    """One per proactive fleet run, on ``device`` (the card unless the
    caller passes ``device="cpu"``): the stacked per-tenant state across
    rounds, re-padded on a bucket promotion."""

    def __init__(self, config, tenants: int, *,
                 device: str | torch.device | None = DEFAULT_DEVICE) -> None:
        self.config = config.validate()
        self.tenants = int(tenants)
        self.device = resolve_device(device)
        self.fstates: ForecastState | None = None
        self._params = forecast_params(config, self.device)

    def observe_and_predict(self, states, tenant_mask: torch.Tensor):
        """Fold every active tenant's observed loads into its model: returns
        ``(deltas f32[T, N], diag f32[T, DIAG_SIZE])`` on the device (the diag
        rides the fleet round's decision read, never a read of its own)."""
        n = int(states.node_valid.shape[-1])
        if self.fstates is None:
            self.fstates = init_fleet_forecast_state(self.config.lags, self.tenants, n,
                                                     device=self.device)
        elif self.fstates.num_nodes != n:
            self.fstates = repad_forecast_state(self.fstates, n)
        self.fstates, deltas, diag = fleet_forecast_step(states, self.fstates, tenant_mask,
                                                         self._params)
        return deltas, diag
