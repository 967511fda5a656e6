"""Per-service request-rate series — the port of ``RateProfile`` and
``service_rate_series`` from ``kubernetes_rescheduling_tpu.bench.loadgen``,
the signal the ``diurnal-autoscale`` churn profile follows. Host code
(numpy), value for value the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np

from kubernetes_rescheduling_tpu_torch.core.workmodel import Workmodel, propagate_entry_rate


@dataclass(frozen=True)
class RateProfile:
    """Per-service offered request-rate series over a run's horizon —
    the signal the elastic autoscaler consumes (Autopilot-style: replica
    targets follow traffic, not the other way around).

    ``base_rps`` is each service's steady-state rate from the SAME
    directed-call-graph propagation the simulator's CPU-load model uses
    (``backends.sim.LoadModel.service_rps``), so autoscaling and offered
    load agree on which services are hot. ``shape`` is a multiplicative
    time profile sampled at ``len(shape)`` points across the horizon;
    ``phase_offsets`` de-synchronizes services (seeded) so a mesh does
    not autoscale in lockstep.

    **Resampled, not truncated**: the series is indexed by *phase
    fraction* (``round_i / num_rounds``) with linear interpolation over
    the shape — a 30-round run over an 8-point shape sweeps the WHOLE
    profile, and a mid-run horizon change re-stretches it. The older
    array-indexing idiom (``shape[:rounds]``) silently played only the
    profile's head.
    """

    names: tuple[str, ...]
    base_rps: np.ndarray          # f32[S] steady per-service total rate
    shape: np.ndarray             # f32[T] multiplicative profile
    phase_offsets: np.ndarray     # f32[S] per-service phase shift in [0, 1)

    def _factor_at(self, phase: np.ndarray) -> np.ndarray:
        """Linear interpolation of ``shape`` at wrapped phases — the
        resampling rule (never an array slice)."""
        t = np.mod(np.asarray(phase, dtype=np.float64), 1.0)
        grid = np.linspace(0.0, 1.0, len(self.shape), endpoint=False)
        # wrap-around interpolation: append the first point at phase 1.0
        xs = np.concatenate([grid, [1.0]])
        ys = np.concatenate([self.shape, self.shape[:1]])
        return np.interp(t, xs, ys)

    def factors(self, round_i: int, num_rounds: int) -> dict[str, float]:
        """Per-service rate factor (1.0 = steady) for one round."""
        phase = (round_i - 1) / max(num_rounds, 1) + self.phase_offsets
        f = self._factor_at(phase)
        return {name: float(f[i]) for i, name in enumerate(self.names)}

    def at(self, round_i: int, num_rounds: int) -> dict[str, float]:
        """Per-service TOTAL offered rate (rps) for one round."""
        phase = (round_i - 1) / max(num_rounds, 1) + self.phase_offsets
        f = self._factor_at(phase)
        return {
            name: float(self.base_rps[i] * f[i])
            for i, name in enumerate(self.names)
        }

    def per_replica(
        self, round_i: int, num_rounds: int, replicas: Mapping[str, int]
    ) -> dict[str, float]:
        """Per-REPLICA rate under the CURRENT live replica counts: the
        total series divides by whatever is deployed right now, so a
        mid-run scale-up halves per-pod rate instead of replaying a
        stale fixed-replica series (the truncation bug class this
        profile exists to avoid)."""
        total = self.at(round_i, num_rounds)
        return {
            name: rate / max(int(replicas.get(name, 1)), 1)
            for name, rate in total.items()
        }


def service_rate_series(
    workmodel: Workmodel,
    *,
    entry_rps: float = 100.0,
    fanout_frac: float = 1.0,
    entry_service: str = "s0",
    amplitude: float = 2.0,
    steps: int = 48,
    phase_jitter: float = 0.15,
    seed: int = 0,
) -> RateProfile:
    """Build the per-service request-rate series for a workmodel.

    Base rates propagate ``entry_rps`` through the cycle-broken directed
    call graph (one source of truth with the sim's CPU model:
    :func:`core.workmodel.kahn_traversal`); the time shape is a diurnal
    sinusoid swinging ×1/amplitude–×amplitude across the horizon, with a
    small seeded per-service phase offset.
    """
    if amplitude <= 0:
        raise ValueError(f"amplitude must be > 0, got {amplitude}")
    names = workmodel.names
    rng = np.random.default_rng(seed)
    # ONE propagation rule with the simulator's CPU-load model
    # (core.workmodel.propagate_entry_rate — LoadModel.service_rps calls
    # the same function): autoscaling can never disagree with offered
    # load about which services are hot
    rps = propagate_entry_rate(
        workmodel,
        entry_service=entry_service,
        entry_rps=entry_rps,
        fanout_frac=fanout_frac,
    )
    base = np.asarray([rps[n] for n in names], dtype=np.float64)
    t = np.linspace(0.0, 1.0, max(int(steps), 2), endpoint=False)
    shape = np.power(float(amplitude), np.sin(2.0 * np.pi * t))
    offsets = rng.uniform(0.0, max(phase_jitter, 0.0), size=len(names))
    return RateProfile(
        names=tuple(names),
        base_rps=base,
        shape=shape,
        phase_offsets=offsets,
    )
