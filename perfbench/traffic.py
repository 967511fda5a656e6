"""The traffic generators the cells' parameters drive.

Drift: every call pair's weight is its call rate under the deployment's
load model (``cluster.pair_rates``) times a lognormal, mean-one
multiplier, so total traffic holds steady while single edges heat and
cool. Each pair's log-multiplier follows its own AR(1) walk: correlated
``rho`` from one round to the next, with the stationary spread ``sigma``
from the first round on, so a round's solve moves what the last rounds'
drift moved and not a fresh draw. The pool is drawn in set-up from the
traffic's own seed and keyed to the call graph's own pairs, so every run
sees the same drift, on services its seed relabels; rounds past its end
wrap around.
"""

from __future__ import annotations

import numpy as np

from perfbench.cluster import stream


def drift_pool(base: np.ndarray, index: np.ndarray, rounds: int, sigma: float, rho: float,
               seed: int) -> np.ndarray:
    """f32[rounds, edges]: ``base`` times ``exp(sigma·z_t − sigma²/2)``,
    ``z_0 ~ N(0, 1)`` and ``z_t = rho·z_{t−1} + sqrt(1 − rho²)·ε_t``, the
    walk of edge ``e`` being the ``index[e]``-th of those ``seed`` draws."""
    rng = stream(seed, 2)
    eps = rng.standard_normal(size=(rounds, base.shape[0]), dtype=np.float32)
    keep, fresh = np.float32(rho), np.float32(np.sqrt(1.0 - rho * rho))
    for t in range(1, rounds):
        eps[t] = keep * eps[t - 1] + fresh * eps[t]
    mult = np.exp(eps[:, index] * np.float32(sigma) - np.float32(0.5 * sigma * sigma))
    return mult * base.astype(np.float32)[None, :]


def sample_rounds(count: int, k: int, seed: int) -> list[int]:
    """``k`` distinct round indices of ``range(count)`` drawn from the seed,
    sorted."""
    if count <= k:
        return list(range(count))
    return sorted(int(i) for i in stream(seed, 4).choice(count, size=k, replace=False))
