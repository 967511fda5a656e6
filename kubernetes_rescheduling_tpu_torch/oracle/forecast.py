"""Numpy twin of the forecaster (``forecast/model.py``) — the port's own
copy of ``kubernetes_rescheduling_tpu.oracle.forecast``.

An independent host-side re-derivation of the batched masked ridge fit, the
lag-feature prediction and the persistence baseline and skill, which the
tests hold the forecaster to within f32 tolerance. Plain numpy.
"""

from __future__ import annotations

import numpy as np


def lag_windows(series: np.ndarray, mask: np.ndarray | None, lags: int
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Supervised one-step windows from per-series history: ``series``
    f[T, B] (one column a series), ``mask`` bool[T, B] observation validity
    (None = all observed). Returns ``(X, y, w)``: X f32[B, T-L, L+1] lag
    features (+bias), y f32[B, T-L] targets, w f32[B, T-L] sample weights
    — a window counts only when every lag AND the target were observed."""
    series = np.asarray(series, dtype=np.float64)
    if series.ndim != 2:
        raise ValueError(f"series must be [T, B], got shape {series.shape}")
    t, b = series.shape
    if lags < 1:
        raise ValueError(f"lags must be >= 1, got {lags}")
    if t <= lags:
        return (np.zeros((b, 0, lags + 1), np.float32), np.zeros((b, 0), np.float32),
                np.zeros((b, 0), np.float32))
    m = np.ones((t, b), dtype=bool) if mask is None else np.asarray(mask, dtype=bool)
    n_win = t - lags
    X = np.ones((b, n_win, lags + 1), dtype=np.float64)
    w = np.ones((b, n_win), dtype=bool)
    for k in range(lags):
        X[:, :, k] = series[k:k + n_win].T
        w &= m[k:k + n_win].T
    y = series[lags:].T
    w &= m[lags:].T
    return X.astype(np.float32), y.astype(np.float32), w.astype(np.float32)


def difference_windows(series: np.ndarray, mask: np.ndarray | None, lags: int
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The model-form windows: the next DELTA regressed on the last ``lags``
    deltas (+ bias), predicting ``ŷ_{t+1} = y_t + w·φ``. Returns ``(X,
    y_delta, base, w)``: X f32[B, T-L-1, L+1] difference features, the target
    deltas, the levels ``y_t`` persistence carries forward, and the window
    validity (every level in the window AND the target observed)."""
    series = np.asarray(series, dtype=np.float64)
    if series.ndim != 2:
        raise ValueError(f"series must be [T, B], got shape {series.shape}")
    t, b = series.shape
    if lags < 1:
        raise ValueError(f"lags must be >= 1, got {lags}")
    n_win = t - lags - 1
    if n_win <= 0:
        z = np.zeros((b, 0), np.float32)
        return np.zeros((b, 0, lags + 1), np.float32), z, z, z
    m = np.ones((t, b), dtype=bool) if mask is None else np.asarray(mask, dtype=bool)
    diffs = series[1:] - series[:-1]
    X = np.ones((b, n_win, lags + 1), dtype=np.float64)
    w = np.ones((b, n_win), dtype=bool)
    for k in range(lags):
        X[:, :, k] = diffs[k:k + n_win].T
        w &= m[k:k + n_win].T
    w &= m[lags:lags + n_win].T
    w &= m[lags + 1:lags + 1 + n_win].T
    base = series[lags:lags + n_win].T
    y_delta = series[lags + 1:].T - base
    return (X.astype(np.float32), y_delta.astype(np.float32), base.astype(np.float32),
            w.astype(np.float32))


def fit_ridge_np(X: np.ndarray, y: np.ndarray, mask: np.ndarray, ridge: float) -> np.ndarray:
    """Per-series masked ridge fit, the twin of ``forecast.model.fit_ridge``:
    ``W[i] = (X_iᵀ diag(w_i) X_i + λI)⁻¹ X_iᵀ diag(w_i) y_i``, f64[B, F]."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    w = np.asarray(mask, dtype=np.float64)
    b_series, _, feat = X.shape
    eye = np.eye(feat)
    W = np.zeros((b_series, feat))
    for i in range(b_series):
        Xw = X[i] * w[i][:, None]
        W[i] = np.linalg.solve(Xw.T @ X[i] + ridge * eye, Xw.T @ y[i])
    return W


def predict_np(W: np.ndarray, X: np.ndarray) -> np.ndarray:
    """Per-series weights over window arrays: [B, F] × [B, T, F] → [B, T]
    (or [B, F] × [B, F] → [B])."""
    X = np.asarray(X, np.float64)
    W = np.asarray(W, np.float64)
    if X.ndim == W.ndim:
        return np.einsum("bf,bf->b", X, W)
    return np.einsum("btf,bf->bt", X, W)


def eval_forecast_np(series: np.ndarray, mask: np.ndarray | None, *, lags: int,
                     ridge: float = 1e-3) -> dict:
    """Fit and score one target family offline: masked MAEs of the model
    prediction and of persistence against the observed next levels, and
    ``skill = 1 − mae_model/mae_persistence``."""
    X, y_delta, _base, w = difference_windows(series, mask, lags)
    n = float(w.sum())
    if n == 0:
        return {"series": int(X.shape[0]), "windows": 0, "mae_model": 0.0,
                "mae_persistence": 0.0, "skill": 0.0}
    W = fit_ridge_np(X, y_delta, w, ridge)
    mae_model = float(np.sum(np.abs(predict_np(W, X) - y_delta) * w) / n)
    mae_pers = float(np.sum(np.abs(y_delta) * w) / n)
    skill = 1.0 - mae_model / mae_pers if mae_pers > 1e-12 else 0.0
    return {"series": int(X.shape[0]), "windows": int(n), "mae_model": mae_model,
            "mae_persistence": mae_pers, "skill": skill}
