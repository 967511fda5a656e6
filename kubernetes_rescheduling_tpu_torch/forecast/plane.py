"""The controller's handle on the online forecaster — the port of
``kubernetes_rescheduling_tpu.forecast.plane``.

:class:`ForecastPlane` owns the :class:`~forecast.model.ForecastState`
across rounds and re-pads its node axis on a bucket promotion. On the card a
round's step is one replay of a CUDA graph captured per state shape
(``solver/compiled.py``, ``cuda_graph_captures_total{fn=
"controller_forecast"}`` == 1 + promotions); on the CPU, and under
``compiled.eager()``, the same body runs op by op. Its diagnostic vector
rides the round's one ``round_end`` read (``RoundCloser.defer``), or without
a closer is its own counted read (``site="forecast"``).

Metric families: ``forecast_mae{target}`` and ``forecast_skill{target}``
gauges, and ``forecast_rounds_total{mode}`` — ``cold`` (warming up,
persistence applied), ``predictive`` (the model steers the decision) and
``degraded`` (trained but losing to persistence: the gate zeroed the
delta and the round is reactive). :meth:`ForecastPlane.round_info` is the
record's ``forecast`` block.
"""

from __future__ import annotations

import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch.forecast.model import (
    DIAG_FRAC_MODEL,
    DIAG_MAE_MODEL,
    DIAG_MAE_PERSIST,
    DIAG_ROUNDS,
    DIAG_SKILL,
    DIAG_TRAINED,
    ForecastState,
    forecast_params,
    init_forecast_state,
    repad_forecast_state,
    step_with_params,
)
from kubernetes_rescheduling_tpu_torch.solver.compiled import CACHE
from kubernetes_rescheduling_tpu_torch.solver.global_solver import state_from_inputs, state_inputs
from kubernetes_rescheduling_tpu_torch.telemetry.accounting import pull

FORECAST_SITE = "forecast"


def _step_body(t: dict) -> dict:
    new, delta, diag = step_with_params(state_from_inputs(t), ForecastState.from_tensors(t, "f:"),
                                        t["params"])
    return {**new.tensors("f:"), "delta": delta, "diag": diag}


def captured_step(state, fstate: ForecastState, params: torch.Tensor):
    """``forecast_step`` as one replay of the graph captured for this state
    shape (``fn="controller_forecast"``), eagerly on the CPU or under
    ``compiled.eager()``. Returns ``(fstate', delta, diag)``."""
    inputs = {**state_inputs(state), **fstate.tensors("f:"), "params": params}
    out = CACHE.run("controller_forecast", (), inputs, lambda: _step_body)
    return ForecastState.from_tensors(out, "f:"), out["delta"], out["diag"]


def decode_diag(d) -> dict:
    """A read diag vector -> the record's ``forecast`` block."""
    trained = bool(d[DIAG_TRAINED] > 0)
    frac = float(d[DIAG_FRAC_MODEL])
    mode = "cold" if not trained else ("predictive" if frac > 0 else "degraded")
    return {
        "skill": float(d[DIAG_SKILL]),
        "mae_model": float(d[DIAG_MAE_MODEL]),
        "mae_persistence": float(d[DIAG_MAE_PERSIST]),
        "scored_weight": float(d[DIAG_ROUNDS]),
        "model_node_frac": frac,
        "trained": trained,
        "mode": mode,
        "target": "node_load",
    }


def publish_forecast(registry, block: dict, *, skill_gauge: bool = True) -> None:
    """The forecast families of one round's block (``skill_gauge`` off: the
    fleet publishes skill per tenant through its label budget instead)."""
    lab = {"target": "node_load"}
    if skill_gauge:
        registry.gauge(
            "forecast_mae",
            "running mean absolute one-step forecast error (model vs observed), by target "
            "family",
            labelnames=("target",),
        ).labels(**lab).set(block["mae_model"])
        registry.gauge(
            "forecast_skill",
            "1 - mae_model/mae_persistence: >0 means the learned forecaster beats the "
            "persistence baseline",
            labelnames=("target",),
        ).labels(**lab).set(block["skill"])
    registry.counter(
        "forecast_rounds_total",
        "proactive rounds by forecast path (cold = warming up, predictive = model "
        "steering, degraded = skill gate fell back to reactive)",
        labelnames=("mode",),
    ).labels(mode=block["mode"]).inc()


class ForecastPlane:
    """One per proactive run, on ``device`` (the card unless the caller
    passes ``device="cpu"``); never shared across tenants."""

    def __init__(self, config, *, registry=None,
                 device: str | torch.device | None = DEFAULT_DEVICE) -> None:
        self.config = config.validate()
        self.registry = registry
        self.device = resolve_device(device)
        self.fstate: ForecastState | None = None
        self._last: dict | None = None
        self._params = forecast_params(config, self.device)

    def observe_and_predict(self, state, *, closer=None) -> torch.Tensor:
        """Fold ``state``'s observed node loads into the model and return the
        predicted-load ``delta`` (f32[N], on the device) for this round's
        decision. A new node count (a bucket promotion) re-pads the state
        first. With ``closer`` the diag vector rides the round's one
        ``round_end`` read and is decoded at its flush; without it, it is
        read at once as its own counted ``forecast`` transfer."""
        n = state.num_nodes
        if self.fstate is None:
            self.fstate = init_forecast_state(self.config.lags, n, device=self.device)
        elif self.fstate.num_nodes != n:
            self.fstate = repad_forecast_state(self.fstate, n)
        self.fstate, delta, diag = captured_step(state, self.fstate, self._params)
        if closer is not None:
            closer.defer(diag, self._decode)
        else:
            self._decode(pull(diag, site=FORECAST_SITE, registry=self.registry))
        return delta

    def _decode(self, d) -> None:
        self._last = decode_diag(d)

    def round_info(self) -> dict | None:
        """The latest round's forecast block (``RoundRecord.forecast``)."""
        return dict(self._last) if self._last is not None else None

    def publish(self, registry) -> None:
        """One metric sample set per proactive round."""
        if self._last is not None:
            publish_forecast(registry, self._last)
