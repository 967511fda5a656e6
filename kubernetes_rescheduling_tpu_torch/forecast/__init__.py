"""The forecast plane: predictive scheduling trained on the loop's own
snapshots — the port of ``kubernetes_rescheduling_tpu.forecast``.

- :mod:`model` — the online per-node lag-feature ridge forecaster, its
  persistence baseline and skill gate;
- :mod:`plane` — :class:`ForecastPlane`, the controller's handle (one
  captured step a round, the diag riding the round-end read, the forecast
  metric families);
- :mod:`fleet` — :class:`FleetForecastPlane`, every tenant's step in one
  captured body.

The numpy twin is :mod:`oracle.forecast`; the ``proactive`` algorithm that
consumes the predictions is :mod:`policies.proactive` and the controller.
:mod:`dataset` turns recorded rounds into supervised lag-feature
datasets (the ``telemetry dataset`` mode).
"""

from kubernetes_rescheduling_tpu_torch.forecast.fleet import FleetForecastPlane
from kubernetes_rescheduling_tpu_torch.forecast.model import (
    ForecastState,
    fit_ridge,
    forecast_step,
    init_forecast_state,
    node_loads,
    repad_forecast_state,
    ridge_predict,
)
from kubernetes_rescheduling_tpu_torch.forecast.plane import FORECAST_SITE, ForecastPlane

__all__ = [
    "FORECAST_SITE",
    "FleetForecastPlane",
    "ForecastPlane",
    "ForecastState",
    "fit_ridge",
    "forecast_step",
    "init_forecast_state",
    "node_loads",
    "repad_forecast_state",
    "ridge_predict",
]
