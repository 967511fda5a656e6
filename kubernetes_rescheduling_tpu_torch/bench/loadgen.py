"""Open-loop arrivals — the part of ``kubernetes_rescheduling_tpu.bench.
loadgen`` the serving soak drives (the rest of loadgen waits for the
experiment plane, ROADMAP Queue 1 item 4.4; its ``RateProfile`` is
``elastic/rates.py``)."""

from __future__ import annotations

import numpy as np


def open_loop_arrivals(rate_rps: float, n: int, seed: int = 0) -> np.ndarray:
    """Seeded open-loop arrival offsets: ``n`` cumulative exponential
    inter-arrival gaps at mean rate ``rate_rps`` (a Poisson process), f64[n]
    seconds from stream start. Open loop: arrivals are drawn independently
    of completions, so a slow server faces a growing queue — the regime
    where tail latency and counted shedding mean something."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / float(rate_rps), size=int(n)))
