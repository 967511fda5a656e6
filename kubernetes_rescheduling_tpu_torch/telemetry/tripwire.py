"""In-block tripwires: device-side health detection for the scanned
schedule — the solo half of ``kubernetes_rescheduling_tpu.telemetry.tripwire``.

The scanned schedule (``bench/scan.py``) reads the device once per block, so
every health signal the loop reacts to would be seen K rounds late. This
module judges each round INSIDE the block, after its apply, against the
round's new state and metrics. Four rules, one bit each in the round's
rule mask:

- ``non_finite`` (bit 1): a non-finite value in the valid slots of the
  state, or a non-finite cost or load reading (always armed while the
  plane is on);
- ``cost_regression`` (bit 2): the communication cost rising more than a
  configured fraction above the block-start baseline;
- ``load_std_spike`` (bit 4): the load std above a configured factor of
  the block-start baseline;
- ``hazard_streak`` (bit 8): the same node most-hazardous for a configured
  number of consecutive rounds.

The thresholds ride a device f32 vector (:func:`trip_config_array`), an
input of the captured block, so tuning one reuses the capture. Once a rule
trips, the carry LATCHES: the scan body masks every later round's decision
to the apply's ``-1`` no-op with ``torch.where`` — never a host branch —
so the rest of the block is identity rounds. The per-round bits and the
final ``(trip round, trip mask)`` append to the block's one bundle
(:func:`split_tripwire` strips them), and the host truncates the replay at
the trip round, drains it under ``scan_drains_total{reason="tripwire"}``
and counts :func:`count_tripwire`. In the fleet scan every tenant has its
own lane (:func:`fleet_tripwire_step`): per-tenant latches, baselines and
streaks, so one bad tenant freezes only its own rounds, and
:func:`split_fleet_tripwire` strips the per-tenant trail.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# rule bits, in mask order (TRIPWIRE_RULES[i] <-> bit 1 << i)
TRIP_NON_FINITE = 1
TRIP_COST_REGRESSION = 2
TRIP_LOAD_STD_SPIKE = 4
TRIP_HAZARD_STREAK = 8
TRIPWIRE_RULES: tuple[str, ...] = ("non_finite", "cost_regression", "load_std_spike",
                                   "hazard_streak")
# the config vector's layout (f32[3]): a zero disables its rule
CFG_COST_FRAC, CFG_LOAD_FACTOR, CFG_HAZARD_STREAK = range(3)


def rules_from_mask(mask: int) -> tuple[str, ...]:
    """A rule bitmask as rule names, in bit order."""
    return tuple(name for i, name in enumerate(TRIPWIRE_RULES) if mask & (1 << i))


def trip_config_array(config, device=None) -> torch.Tensor:
    """The f32[3] threshold vector of a config's tripwire fields."""
    return torch.tensor([float(getattr(config, "tripwire_cost_frac", 0.0)),
                         float(getattr(config, "tripwire_load_factor", 0.0)),
                         float(getattr(config, "tripwire_hazard_streak", 0))],
                        dtype=torch.float32, device=device)


def _finite_state(st) -> torch.Tensor:
    """True while every VALID slot of the state is finite: padded slots
    never trip the wire."""
    pod = torch.where(st.pod_valid, st.pod_cpu + st.pod_mem, 0.0)
    node = torch.where(st.node_valid,
                       st.node_cpu_cap + st.node_mem_cap + st.node_base_cpu + st.node_base_mem,
                       0.0)
    return torch.isfinite(pod).all() & torch.isfinite(node).all()


def tripwire_init(cost0, load0) -> tuple:
    """The carry at block start: unlatched, no trip recorded, the
    block-start (cost, load std) baselines, no hazard streak."""
    cost0 = torch.as_tensor(cost0, dtype=torch.float32)
    dev = cost0.device
    z = torch.zeros(cost0.shape, dtype=torch.int32, device=dev)
    return (
        torch.zeros(cost0.shape, dtype=torch.bool, device=dev),   # latched
        z - 1,                                                    # trip round (block-relative)
        z,                                                        # trip rule mask
        cost0,                                                    # baseline cost
        torch.as_tensor(load0, dtype=torch.float32, device=dev),  # baseline load std
        z - 1,                                                    # previous most-hazard
        z,                                                        # hazard streak length
        z,                                                        # block-relative index
    )


def tripwire_step(carry, st, cost, load_std, most, cfg) -> tuple[tuple, torch.Tensor]:
    """One round's evaluation, after its apply: a newly tripped round
    records its block-relative index and rule mask and sets the latch that
    the body reads NEXT round (the trip round itself executed; truncating
    the replay is the host's job). A latched round evaluates nothing (bits
    0). Returns ``(new_carry, bits)``, ``bits`` the round's i32 rule
    mask."""
    latched, trip_rnd, trip_mask, base_cost, base_load, prev, streak, idx = carry
    i32 = torch.int32
    finite = _finite_state(st) & torch.isfinite(cost) & torch.isfinite(load_std)
    bits = torch.where(finite, 0, TRIP_NON_FINITE).to(i32)
    cost_frac = cfg[CFG_COST_FRAC]
    bits = bits | torch.where((cost_frac > 0) & (base_cost > 0)
                              & (cost > (1.0 + cost_frac) * base_cost),
                              TRIP_COST_REGRESSION, 0).to(i32)
    load_factor = cfg[CFG_LOAD_FACTOR]
    bits = bits | torch.where((load_factor > 0) & (base_load > 0)
                              & (load_std > load_factor * base_load),
                              TRIP_LOAD_STD_SPIKE, 0).to(i32)
    # a valid most-hazard equal to last round's extends the streak, a
    # different one restarts it, none clears it
    most = torch.as_tensor(most).to(i32)
    new_streak = torch.where(most >= 0, torch.where(most == prev, streak + 1, 1), 0).to(i32)
    hz = cfg[CFG_HAZARD_STREAK]
    bits = bits | torch.where((hz > 0) & (new_streak >= hz.to(i32)),
                              TRIP_HAZARD_STREAK, 0).to(i32)
    bits = torch.where(latched, 0, bits).to(i32)
    tripped = bits != 0
    return (
        (latched | tripped, torch.where(tripped, idx, trip_rnd),
         torch.where(tripped, bits, trip_mask), base_cost, base_load, most, new_streak,
         idx + 1),
        bits,
    )


def fleet_tripwire_step(carry, states, metrics, most, cfg) -> tuple[tuple, torch.Tensor]:
    """The fleet composition: :func:`tripwire_step` per tenant lane, each
    carry field ``[T]``; ``states`` one state a tenant, ``metrics`` the
    round's ``f32[T, 2]`` (cost, load_std), ``most`` ``[T]``. Returns the
    new carry and the round's bits ``i32[T]``."""
    lanes, bits = [], []
    for i, st in enumerate(states):
        c, b = tripwire_step(tuple(x[i] for x in carry), st, metrics[i, 0], metrics[i, 1],
                             most[i], cfg)
        lanes.append(c)
        bits.append(b)
    return tuple(torch.stack(field) for field in zip(*lanes)), torch.stack(bits)


# ---------------- host half: decode and accounting ----------------


@dataclass(frozen=True)
class TripReport:
    """One block's decoded verdict; ``trip_round`` is block-relative (-1:
    the block ran clean). In the fleet variant the fields are per-tenant
    arrays and :attr:`tripped` means ANY tenant tripped."""

    bits: np.ndarray                 # i64[K] (solo) / i64[K, T] (fleet)
    trip_round: int | np.ndarray
    trip_mask: int | np.ndarray

    @property
    def tripped(self) -> bool:
        return bool(np.any(np.asarray(self.trip_round) >= 0))

    @property
    def rules(self) -> tuple[str, ...]:
        """Rule names in the (for the fleet: union) trip mask."""
        mask = int(np.bitwise_or.reduce(np.atleast_1d(np.asarray(self.trip_mask, np.int64))))
        return rules_from_mask(mask)


def split_tripwire(flat: np.ndarray, *, rounds: int) -> tuple[np.ndarray, TripReport]:
    """Strip the appended tripwire block — bits ``[K]`` and the final
    ``(trip_round, trip_mask)`` — off a scan bundle, returning the untouched
    core for ``decode_block``."""
    flat = np.asarray(flat, dtype=np.float32)
    tail = rounds + 2
    if flat.size <= tail:
        raise ValueError(
            f"scan bundle of {flat.size} values has no tripwire block at rounds={rounds}"
        )
    trail = flat[-tail:]
    return flat[:-tail], TripReport(bits=trail[:rounds].astype(np.int64),
                                    trip_round=int(trail[rounds]),
                                    trip_mask=int(trail[rounds + 1]))


def split_fleet_tripwire(flat: np.ndarray, *, rounds: int, tenants: int
                         ) -> tuple[np.ndarray, TripReport]:
    """The fleet twin of :func:`split_tripwire`: bits ``[K, T]`` and the
    per-tenant ``trip_round[T]`` / ``trip_mask[T]`` trail the bundle."""
    flat = np.asarray(flat, dtype=np.float32)
    tail = rounds * tenants + 2 * tenants
    if flat.size <= tail:
        raise ValueError(
            f"fleet scan bundle of {flat.size} values has no tripwire block at "
            f"rounds={rounds}, tenants={tenants}"
        )
    trail = flat[-tail:]
    n_bits = rounds * tenants
    return flat[:-tail], TripReport(
        bits=trail[:n_bits].reshape(rounds, tenants).astype(np.int64),
        trip_round=trail[n_bits:n_bits + tenants].astype(np.int64),
        trip_mask=trail[n_bits + tenants:].astype(np.int64),
    )


def count_tripwire(registry, rules) -> None:
    """A tripped block's accounting: each rule of its mask counts once in
    ``scan_tripwires_total{rule}``."""
    fam = registry.counter(
        "scan_tripwires_total",
        "scan blocks tripped by the in-block tripwire plane, by rule (a block tripping "
        "on several rules counts once per rule)",
        labelnames=("rule",),
    )
    for rule in rules:
        fam.labels(rule=rule).inc()
