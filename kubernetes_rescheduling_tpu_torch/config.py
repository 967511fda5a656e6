"""The rescheduling run's configuration — the port of
``kubernetes_rescheduling_tpu.config.RescheduleConfig`` as far as the
sequential control loop on the simulator reads it.

Fields of the JAX package's nested blocks are flat here, named after
their block (``reconcile_admission`` is ``reconcile.admission``), with the
JAX package's defaults. The config also carries planes this port does not
have yet: each keeps a field whose default is off, and
:meth:`RescheduleConfig.validate` refuses it, naming the ROADMAP item that
brings it — a run never quietly does something else.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_NAMES
from kubernetes_rescheduling_tpu_torch.utils.retry import RetryPolicy

ALGORITHMS: tuple[str, ...] = POLICY_NAMES + ("global",)


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

    # planes of the JAX package that this port does not carry yet
    chaos: str = "none"          # chaos.profile
    elastic: str = "none"        # elastic.profile
    shadow: bool = False         # shadow.enabled
    fleet: int = 0               # fleet.tenants
    serving: bool = False        # serving.enabled
    pipeline: bool = False       # controller.pipeline
    scan_block: int = 0          # controller.scan_block

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
            (self.elastic != "none", "elastic churn (elastic/)", 3),
            (self.shadow, "shadow mode (bench/shadow.py)", 4),
            (self.fleet > 0, "fleet mode", 3),
            (self.serving, "the serving plane", 3),
            (self.pipeline, "the pipelined schedule", 3),
            (self.scan_block > 0, "the scanned schedule (bench/scan.py)", 3),
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
        return self
