"""The rescheduling run's configuration — the port of
``kubernetes_rescheduling_tpu.config.RescheduleConfig`` as far as the
sequential control loop on the simulator reads it.

Fields of the JAX package's nested blocks are flat here, named after
their block (``reconcile_admission`` is ``reconcile.admission``,
``pipeline_depth`` is ``controller.depth``, ``elastic_seed`` is
``elastic.seed``, the tripwire fields are ``obs.*``), with the JAX
package's defaults, and :meth:`RescheduleConfig.validate` refuses what the
JAX package refuses, for the same reasons. The config also carries planes
this port does not have yet: each keeps a field whose default is off, and
``validate`` refuses it, naming the ROADMAP item that brings it — a run
never quietly does something else.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_NAMES
from kubernetes_rescheduling_tpu_torch.utils.retry import RetryPolicy

ALGORITHMS: tuple[str, ...] = POLICY_NAMES + ("global",)

# greedy policies whose placement mechanism PINS the landing node: the
# scanned schedule replays their moves knowing where they land.
# kubescheduling is absent: its affinityOnly landing is the scheduler's,
# and a block must not bet K decisions on an f32 twin of the simulator's
# f64 choice
SCAN_POLICIES: tuple[str, ...] = ("spread", "binpack", "random", "communication")

# the named churn profiles of elastic/events.py
ELASTIC_PROFILES: tuple[str, ...] = ("steady", "diurnal-autoscale", "deploy-waves", "node-flap")


@dataclass(frozen=True)
class RescheduleConfig:
    """One config object for a rescheduling run."""

    # policy & loop — reference semantics
    algorithm: str = "communication"       # reference main.py:118-125
    hazard_threshold_pct: float = 30.0     # reference harzard_detect.py:7
    max_rounds: int = 10                   # reference main.py:28
    sleep_after_action_s: float = 15.0     # reference main.py:27
    # Deployments moved per greedy round: 1 = reference-faithful; k = up
    # to k victims drained from the hazard node; "all" = the round goes
    # through the global solver whatever the algorithm
    moves_per_round: int | str = 1
    # global rounds apply every changed service ("all") or, with an int k,
    # the wave cap: at most k strictly improving moves a round
    global_moves_cap: int | str = "all"

    backend: str = "sim"
    # global solver
    enforce_capacity: bool = False         # reference never checks capacity
    capacity_frac: float = 1.0             # packing budget as a fraction of capacity
    global_solver_iters: int = 9           # best-response sweeps per solve
    balance_weight: float = 0.0            # λ for the load-balance term
    move_cost: float = 0.0                 # comm-weight units per restarted pod
    solver_restarts: int = 1
    solver_tp: int = 1
    solver_backend: str = "dense"          # "dense" | "sparse"
    placement_unit: str = "service"        # "service" | "pod" (global only)
    seed: int = 0

    # resilience: every controller→backend call goes through the retry
    # boundary; the breaker opens after this many CONSECUTIVE failures
    # (0 disables it), stays open `breaker_cooldown_rounds` counted skips,
    # then probes its way closed; `failure_budget_per_round` freezes a
    # round's remaining moves once spent (0 = unlimited)
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    max_consecutive_failures: int = 5
    breaker_cooldown_rounds: int = 2
    failure_budget_per_round: int = 0

    # the reconciliation and admission planes (reconcile.*): every monitor
    # snapshot passes the admission guard (quarantine or reject), and the
    # intent ledger diffs each admitted snapshot against the controller's
    # own moves, repairing up to `repair_budget_per_round` pods a round
    # (0 = detect and count only)
    reconcile_admission: bool = True
    reconcile_enabled: bool = True
    repair_budget_per_round: int = 2
    max_quarantine_frac: float = 0.5

    # decision explanations (obs.explain, obs.explain_top_k): recorded when
    # on AND a logger is attached to the run
    explain: bool = True
    explain_top_k: int = 3

    # the schedules (controller.*): the software-pipelined loop (depth 2
    # only), or K steady-state rounds a scan block (0 = off); exclusive
    pipeline: bool = False
    pipeline_depth: int = 2
    scan_block: int = 0

    # in-block tripwires of the scanned schedule (obs.*): the plane (its
    # non_finite rule always armed) and the threshold rules (0 = rule off)
    scan_tripwires: bool = True
    tripwire_cost_frac: float = 0.0
    tripwire_load_factor: float = 0.0
    tripwire_hazard_streak: int = 0

    # elastic churn (elastic.*): the profile applied between rounds, its
    # seed, and the floor of the shape buckets
    elastic: str = "none"
    elastic_seed: int = 0
    bucket_floor: int = 8

    # planes of the JAX package that this port does not carry yet
    chaos: str = "none"          # chaos.profile
    shadow: bool = False         # shadow.enabled
    fleet: int = 0               # fleet.tenants
    serving: bool = False        # serving.enabled

    def validate(self) -> "RescheduleConfig":
        if self.algorithm == "proactive":
            raise ValueError(
                "algorithm='proactive' needs the forecast plane, which the port does not "
                "have yet (ROADMAP Queue 1 item 3)"
            )
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; expected one of {sorted(ALGORITHMS)}"
            )
        if self.max_rounds < 0:
            raise ValueError("max_rounds must be >= 0")
        mpr = self.moves_per_round
        if not (mpr == "all" or (isinstance(mpr, int) and mpr >= 1)):
            raise ValueError(f"moves_per_round must be a positive int or 'all', got {mpr!r}")
        gmc = self.global_moves_cap
        if not (gmc == "all" or (isinstance(gmc, int) and gmc >= 1)):
            raise ValueError(f"global_moves_cap must be a positive int or 'all', got {gmc!r}")
        if self.solver_backend not in ("dense", "sparse"):
            raise ValueError(
                f"solver_backend must be 'dense' or 'sparse', got {self.solver_backend!r}"
            )
        if self.placement_unit not in ("service", "pod"):
            raise ValueError(
                f"placement_unit must be 'service' or 'pod', got {self.placement_unit!r}"
            )
        if self.placement_unit == "pod":
            if self.algorithm != "global":
                raise ValueError(
                    "placement_unit='pod' requires algorithm='global' "
                    "(the greedy policies score whole services)"
                )
            if isinstance(gmc, int):
                raise ValueError(
                    "placement_unit='pod' does not support global_moves_cap "
                    "(use move_cost: disruption pricing inside the solve)"
                )
        if self.solver_restarts > 1 or self.solver_tp > 1:
            raise ValueError(
                "solver_restarts > 1 and solver_tp > 1 run across devices, which the port "
                "does not do yet (ROADMAP Queue 1 item 5)"
            )
        if self.solver_restarts < 1 or self.solver_tp < 1:
            raise ValueError("solver_restarts and solver_tp must be >= 1")
        if self.backend != "sim":
            raise ValueError(
                f"backend {self.backend!r}: the port drives only the simulator so far "
                "(the k8s backend is ROADMAP Queue 1 item 4)"
            )
        self.retry.validate()
        refused = (
            (self.chaos != "none", "chaos injection (backends/chaos.py)", 4),
            (self.shadow, "shadow mode (bench/shadow.py)", 4),
            (self.fleet > 0, "fleet mode", 3),
            (self.serving, "the serving plane", 3),
        )
        for on, what, item in refused:
            if on:
                raise ValueError(
                    f"{what} is not ported yet (ROADMAP Queue 1 item {item})"
                )
        if self.max_consecutive_failures < 0:
            raise ValueError("max_consecutive_failures must be >= 0")
        if self.breaker_cooldown_rounds < 1:
            raise ValueError("breaker_cooldown_rounds must be >= 1")
        if self.failure_budget_per_round < 0:
            raise ValueError("failure_budget_per_round must be >= 0")
        if self.repair_budget_per_round < 0:
            raise ValueError(
                "repair_budget_per_round must be >= 0 (0 = detect only), got "
                f"{self.repair_budget_per_round}"
            )
        if not 0.0 < self.max_quarantine_frac <= 1.0:
            raise ValueError(
                f"max_quarantine_frac must be in (0, 1], got {self.max_quarantine_frac}"
            )
        if self.explain_top_k < 1:
            raise ValueError("explain_top_k must be >= 1")
        self._validate_schedules()
        self._validate_elastic()
        return self

    def _validate_schedules(self) -> None:
        if self.pipeline_depth != 2:
            raise ValueError(
                "controller pipeline depth must be 2 (the only implemented schedule: one "
                f"round closing while the next decides), got {self.pipeline_depth}"
            )
        if self.scan_block < 0:
            raise ValueError(
                f"controller scan_block must be >= 0 (0 = scanned schedule off), "
                f"got {self.scan_block}"
            )
        if self.scan_block and self.pipeline:
            raise ValueError(
                "controller scan_block and pipeline are mutually exclusive schedules of "
                "the same loop: the scan already amortizes dispatch and transfer over K "
                "rounds, so there is no per-round tail left to overlap"
            )
        if self.scan_block:
            # decisions made outside the scan body are refused here; churn,
            # checkpoints and load hooks drain per round at run time instead
            if self.algorithm not in SCAN_POLICIES:
                raise ValueError(
                    f"controller scan_block requires a pinning greedy algorithm "
                    f"{sorted(SCAN_POLICIES)} (got {self.algorithm!r}: global/pod solvers "
                    "and the forecast plane decide outside the scan body, and "
                    "kubescheduling's affinityOnly landing belongs to the scheduler, not "
                    "the twin)"
                )
            if self.moves_per_round != 1:
                raise ValueError(
                    "controller scan_block requires moves_per_round=1 (the scan body is "
                    "the reference-faithful one-decision round)"
                )
        for name, rule in (("tripwire_cost_frac", "cost_regression"),
                           ("tripwire_load_factor", "load_std_spike"),
                           ("tripwire_hazard_streak", "hazard_streak")):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0 (0 disables the {rule} tripwire rule)")

    def _validate_elastic(self) -> None:
        valid = ("none",) + ELASTIC_PROFILES
        if self.elastic not in valid:
            raise ValueError(
                f"unknown churn profile {self.elastic!r}; expected one of {sorted(valid)}"
            )
        if self.bucket_floor < 1:
            raise ValueError(f"bucket_floor must be >= 1, got {self.bucket_floor}")
