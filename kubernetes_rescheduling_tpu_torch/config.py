"""The rescheduling run's configuration — the port of
``kubernetes_rescheduling_tpu.config.RescheduleConfig``.

Fields of the JAX package's nested blocks are flat here, named after
their block (``reconcile_admission`` is ``reconcile.admission``,
``pipeline_depth`` is ``controller.depth``, ``elastic_seed`` is
``elastic.seed``, ``chaos`` and ``chaos_seed`` are ``chaos.profile`` and
``chaos.seed``, the tripwire, explanation, attribution and ops-plane
fields are ``obs.*`` under the same names), with the JAX package's
defaults, and :meth:`RescheduleConfig.validate` refuses what the JAX
package refuses, for the same reasons. Fleet mode, the forecast plane, the
serving plane, SLO v2, shadow mode and the perf ledger keep their blocks
(:class:`FleetConfig`, :class:`ForecastConfig`, :class:`ServingConfig`,
:class:`SloConfig`, :class:`ShadowConfig`, :class:`PerfConfig`).
:meth:`RescheduleConfig.from_toml` reads the JAX package's TOML files:
each nested table lands on the flat fields by the table :data:`TOML_TABLES`.
``solver_restarts`` and ``solver_tp`` run as in the JAX package: best-of-N
solves a round, in sequence on one device, and each solve's node axis
sharded over ``tp`` ranks of the process group (``parallel/``). The config
also carries fields of planes this port does not have yet (the fleet's dp
plane and its restarts, the mesh plane: ROADMAP Queue 1 item 5): each keeps
its JAX default, and ``validate`` refuses a value that asks for the plane,
naming the item — a run never quietly does something else.
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field
from pathlib import Path

from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_NAMES
from kubernetes_rescheduling_tpu_torch.utils.retry import RetryPolicy

ALGORITHMS: tuple[str, ...] = POLICY_NAMES + ("global", "proactive")

# greedy policies whose placement mechanism PINS the landing node: the
# scanned schedule replays their moves knowing where they land.
# kubescheduling is absent: its affinityOnly landing is the scheduler's,
# and a block must not bet K decisions on an f32 twin of the simulator's
# f64 choice
SCAN_POLICIES: tuple[str, ...] = ("spread", "binpack", "random", "communication")

# the named churn profiles of elastic/events.py
ELASTIC_PROFILES: tuple[str, ...] = ("steady", "diurnal-autoscale", "deploy-waves", "node-flap")

# the named fault profiles of backends/chaos.py (kept here so the config
# stays light; a test holds the two equal)
CHAOS_PROFILES: tuple[str, ...] = ("none", "flaky-monitor", "flaky-moves", "node-flap", "soak",
                                   "reconcile")


@dataclass(frozen=True)
class ForecastConfig:
    """The forecast plane (the JAX package's ``[forecast]`` block): the
    online lag-feature ridge forecaster behind ``algorithm="proactive"``
    (``forecast/``).

    ``lags`` is the feature window; ``ridge`` the L2 term that keeps every
    per-node solve well-posed; ``min_history`` the observations a node needs
    before its model prediction is trusted (until then the prediction is
    persistence and a proactive round equals a reactive one);
    ``min_skill`` the device-side gate: when ``forecast_skill = 1 -
    mae_model/mae_persistence`` drops below it the applied delta is zero.
    ``decay`` weighs the skill window per scored round (1.0 = cumulative);
    ``fit_decay`` is the recursive-least-squares forgetting of the ridge
    statistics, longer than the skill window. ``base_policy`` is the greedy
    policy proactive rounds score with: the forecast moves the state the
    policy sees, not the policy."""

    lags: int = 2
    ridge: float = 1e-3
    min_history: int = 12
    min_skill: float = 0.0
    decay: float = 0.85
    fit_decay: float = 0.97
    base_policy: str = "communication"

    def validate(self) -> "ForecastConfig":
        if self.lags < 1:
            raise ValueError(f"forecast lags must be >= 1, got {self.lags}")
        if self.ridge <= 0:
            raise ValueError(
                f"forecast ridge must be > 0 (it keeps cold solves well-posed), got {self.ridge}"
            )
        if self.min_history < self.lags + 2:
            raise ValueError(
                f"forecast min_history must be >= lags + 2 (a node needs a full feature "
                f"window plus targets before its fit means anything), got "
                f"{self.min_history} with lags={self.lags}"
            )
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(
                f"forecast decay must be in (0, 1] (1 = cumulative skill window), "
                f"got {self.decay}"
            )
        if not 0.0 < self.fit_decay <= 1.0:
            raise ValueError(
                f"forecast fit_decay must be in (0, 1] (1 = infinite fit memory), "
                f"got {self.fit_decay}"
            )
        if self.base_policy not in POLICY_NAMES:
            raise ValueError(
                f"forecast base_policy must be a greedy policy {sorted(POLICY_NAMES)}, "
                f"got {self.base_policy!r}"
            )
        return self



@dataclass(frozen=True)
class ReconcileConfig:
    """The JAX package's ``[reconcile]`` block as one value, for the
    callers that carry it whole (the bench harness's ``ExperimentConfig``);
    a run's :class:`RescheduleConfig` holds its fields flat
    (:meth:`flat`)."""

    admission: bool = True
    enabled: bool = True
    repair_budget_per_round: int = 2
    max_quarantine_frac: float = 0.5

    def validate(self) -> "ReconcileConfig":
        if self.repair_budget_per_round < 0:
            raise ValueError(
                f"reconcile repair_budget_per_round must be >= 0 (0 = detect only), got "
                f"{self.repair_budget_per_round}")
        if not 0.0 < self.max_quarantine_frac <= 1.0:
            raise ValueError(
                f"reconcile max_quarantine_frac must be in (0, 1], got "
                f"{self.max_quarantine_frac}")
        return self

    def flat(self) -> dict:
        """The :class:`RescheduleConfig` fields of this block."""
        return {"reconcile_admission": self.admission, "reconcile_enabled": self.enabled,
                "repair_budget_per_round": self.repair_budget_per_round,
                "max_quarantine_frac": self.max_quarantine_frac}


@dataclass(frozen=True)
class PerfConfig:
    """The perf ledger (the JAX package's ``[perf]`` block): where the
    append-only ledger lives and how its rolling-window regression detector
    judges (``telemetry/perf_ledger.py``). ``ledger_path = None`` lets the
    consumer pick (the bench harness writes ``<session>/perf_ledger.jsonl``);
    ``enabled = False`` turns ledger writes and detection off."""

    enabled: bool = True
    ledger_path: str | None = None
    window: int = 5                  # prior readings judged against
    regression_frac: float = 0.2     # threshold above baseline = regressed
    baseline: str = "median"         # "median" | "best" of the window
    min_history: int = 2             # readings before a series is judged

    def validate(self) -> "PerfConfig":
        if self.window < 1:
            raise ValueError("perf window must be >= 1")
        if self.regression_frac < 0:
            raise ValueError("perf regression_frac must be >= 0")
        if self.baseline not in ("median", "best"):
            raise ValueError(f"perf baseline must be 'median' or 'best', got {self.baseline!r}")
        if self.min_history < 1:
            raise ValueError("perf min_history must be >= 1")
        return self


@dataclass(frozen=True)
class ServingConfig:
    """The serving plane (the JAX package's ``[serving]`` block): the
    request-grain placement service (``serving/``).

    ``enabled`` attaches the engine to a run (the engine itself can always be
    built in code); ``max_batch`` is the static batch shape every dispatch
    pads to (one capture in steady state); ``batch_window_ms`` how long the
    batcher holds its first request open for company; ``queue_depth`` the
    bounded admission queue (arrivals beyond it shed, counted
    ``serving_shed_total{reason="queue_full"}``); ``deadline_ms`` the
    default per-request deadline (0 = none); ``window`` the rolling
    completed-request window behind the percentiles; ``ring`` the bounded
    recent-request ring."""

    enabled: bool = False
    max_batch: int = 8
    batch_window_ms: float = 2.0
    queue_depth: int = 64
    deadline_ms: float = 250.0
    window: int = 256
    ring: int = 32

    def validate(self) -> "ServingConfig":
        if self.max_batch < 1:
            raise ValueError(f"serving max_batch must be >= 1, got {self.max_batch}")
        if self.batch_window_ms < 0:
            raise ValueError(
                f"serving batch_window_ms must be >= 0 (0 = dispatch whatever is queued "
                f"immediately), got {self.batch_window_ms}"
            )
        if self.queue_depth < 1:
            raise ValueError(f"serving queue_depth must be >= 1, got {self.queue_depth}")
        if self.deadline_ms < 0:
            raise ValueError(
                f"serving deadline_ms must be >= 0 (0 = no deadline), got {self.deadline_ms}"
            )
        if self.window < 2:
            raise ValueError(
                f"serving window must be >= 2 (percentiles over one sample judge nothing), "
                f"got {self.window}"
            )
        if self.ring < 1:
            raise ValueError(f"serving ring must be >= 1, got {self.ring}")
        return self


@dataclass(frozen=True)
class FleetConfig:
    """Fleet mode (the JAX package's ``[fleet]`` block): ``tenants`` clusters
    decided by one device plane a round under the multiplexed loop
    (``bench/fleet.py``); 0 = off. ``plane`` is the device batching: the
    port carries ``"vmap"`` (one captured program over the tenants);
    ``"dp"`` (one tenant group a device) is refused with multi-device
    (ROADMAP Queue 1 item 5). ``chaos_tenants`` selects the tenants the
    run's chaos profile wraps (empty = every tenant)."""

    tenants: int = 0
    plane: str = "vmap"                  # "vmap" | "dp"
    chaos_tenants: tuple[int, ...] = ()

    def validate(self) -> "FleetConfig":
        if self.tenants < 0:
            raise ValueError(f"fleet tenants must be >= 0, got {self.tenants}")
        if self.plane not in ("vmap", "dp"):
            raise ValueError(f"fleet plane must be 'vmap' or 'dp', got {self.plane!r}")
        for t in self.chaos_tenants:
            if not (isinstance(t, int) and t >= 0):
                raise ValueError(f"chaos_tenants must be non-negative ints, got {t!r}")
            if self.tenants and t >= self.tenants:
                raise ValueError(f"chaos tenant {t} out of range for {self.tenants} tenants")
        if self.plane == "dp":
            raise ValueError(
                "fleet plane 'dp' shards the tenants over devices, which the port does "
                "not do yet (ROADMAP Queue 1 item 5)"
            )
        return self


@dataclass(frozen=True)
class SloConfig:
    """SLO v2 block (the JAX package's ``[slo]``): error budgets and multi-window
    burn-rate alerting over the in-process history plane
    (``telemetry/timeseries.py`` + ``telemetry/slo.py``).

    ``enabled`` turns the plane on (off by default: disabled runs must
    stay bit-identical to pre-SLO output). ``objective`` is the success
    fraction every default SLO targets (0.99 = 1% error budget);
    ``latency_threshold_ms`` additionally compiles a serving-latency SLO
    over the ``serving_request_seconds{stage="total"}`` histogram (0
    disables it). All windows are in *ticks* (rounds/batches — the sim
    clock is not wall time): ``budget_window`` is the long accounting
    window behind ``slo_budget_remaining_frac``; the
    ``fast_window``/``fast_burn`` pair is the page
    (``slo_fast_burn``, the 5m-of-1h analogue with a 14.4x default
    threshold), ``slow_window``/``slow_burn`` the ticket
    (``slo_slow_burn``, 6x); each long window carries an implicit 1/12
    confirm window, and a burn of 0 disables that rule.
    ``series_capacity``/``max_series`` bound the history plane: points
    per ring and the hard global series budget (LRU-evicted, counted
    ``timeseries_evictions_total``)."""

    enabled: bool = False
    objective: float = 0.99
    latency_threshold_ms: float = 0.0
    budget_window: int = 512
    fast_window: int = 48
    fast_burn: float = 14.4
    slow_window: int = 288
    slow_burn: float = 6.0
    series_capacity: int = 512
    max_series: int = 256

    def validate(self) -> "SloConfig":
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"slo objective must be in (0, 1), got {self.objective}"
            )
        if self.latency_threshold_ms < 0:
            raise ValueError(
                f"slo latency_threshold_ms must be >= 0 (0 disables the "
                f"latency SLO), got {self.latency_threshold_ms}"
            )
        for name in ("budget_window", "fast_window", "slow_window"):
            if getattr(self, name) < 2:
                raise ValueError(
                    f"slo {name} must be >= 2, got {getattr(self, name)}"
                )
        if self.fast_window >= self.slow_window:
            raise ValueError(
                f"slo fast_window ({self.fast_window}) must be shorter "
                f"than slow_window ({self.slow_window})"
            )
        if self.budget_window < self.slow_window:
            raise ValueError(
                f"slo budget_window ({self.budget_window}) must cover "
                f"slow_window ({self.slow_window})"
            )
        if self.fast_burn < 0 or self.slow_burn < 0:
            raise ValueError(
                "slo burn thresholds must be >= 0 (0 disables the rule)"
            )
        if self.series_capacity < 2:
            raise ValueError(
                f"slo series_capacity must be >= 2, got {self.series_capacity}"
            )
        if self.max_series < 1:
            raise ValueError(
                f"slo max_series must be >= 1, got {self.max_series}"
            )
        return self


@dataclass(frozen=True)
class ShadowConfig:
    """Shadow mode (the JAX package's ``[shadow]`` block): replay a recorded
    cluster trace, recommend moves without applying any, and score our
    counterfactual placement against what the trace's scheduler did
    (``backends/replay.py``, ``bench/shadow.py``).

    ``enabled`` turns the plane on; the run must use the replay backend
    (``reschedule --shadow TRACE`` builds both together). ``win_margin`` is
    the undercut a round must achieve to count as a win: our counterfactual
    cost at or below ``actual · (1 − win_margin)`` (0 = ties count)."""

    enabled: bool = False
    win_margin: float = 0.0

    def validate(self) -> "ShadowConfig":
        if not (0.0 <= self.win_margin < 1.0):
            raise ValueError(
                f"shadow win_margin must be in [0, 1) (a fraction of the actual cost to "
                f"undercut), got {self.win_margin}"
            )
        return self


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

    # "sim" (the simulator), "replay" (a recorded trace, shadow mode) or
    # "k8s" (a live cluster through backends/k8s.py)
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

    # array capacities (0 = size to the scenario); read by nothing yet, in
    # the JAX package as here
    node_capacity: int = 0
    pod_capacity: int = 0

    # the live adapter (backends/k8s.py): namespace and the delete poll of
    # each Deployment move (reference main.py:68, delete_replaced_pod.py:8)
    namespace: str = "default"
    delete_timeout_s: float = 180.0
    delete_poll_interval_s: float = 1.5

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
    # on AND a logger or the ops plane is attached to the run
    explain: bool = True
    explain_top_k: int = 3
    # cost attribution (obs.attribution*): the per-round edge / node-pair
    # decomposition of the cost and the move provenance, recorded when on
    # AND a logger or the ops plane is attached; the drift rule's top-1
    # edge share of total cost (0 = rule off)
    attribution: bool = True
    attribution_top_k: int = 8
    attribution_drift_frac: float = 0.0

    # the live ops plane (obs.*, telemetry/server.py): the HTTP endpoint
    # (None = no server, 0 = an ephemeral port), the flight recorder's ring
    # and bundle directory, the /healthz staleness rule (0 = off), the SLO
    # watchdog's window and rules (a zero threshold disables its rule), and
    # the bounded torch.profiler captures of POST /profile
    serve_port: int | None = None
    flight_recorder_rounds: int = 16
    bundle_dir: str = "flight_recorder"
    max_round_age_s: float = 0.0
    slo_window: int = 20
    slo_min_samples: int = 5
    slo_latency_p95_s: float = 0.0
    slo_cost_regression_frac: float = 0.0
    slo_max_retraces: int = 1
    slo_forecast_min_skill: float = 0.0
    slo_pipeline_min_overlap: float = 0.0
    slo_reconcile_drift_pods: int = 0
    # the shadow_win_rate rule: a shadow run whose running win rate against
    # the trace's scheduler sits below this is in violation (0 = off; only
    # rounds carrying shadow data are judged)
    slo_shadow_min_win_rate: float = 0.0
    slo_fleet_tail_frac: float = 0.0
    slo_scan_tripwire: bool = True
    slo_serving_p99_ms: float = 0.0
    # the mesh plane (obs.device_rollup, obs.device_label_budget,
    # obs.slo_mesh_imbalance_ratio): per-device rollups over a multi-device
    # mesh, ROADMAP Queue 1 item 5. One device has nothing to roll up, so
    # the defaults run; the mesh_imbalance rule is refused
    device_rollup: bool = True
    device_label_budget: int = 64
    slo_mesh_imbalance_ratio: float = 0.0
    profile_rounds: int = 0
    profile_max_captures: int = 4
    profile_max_mb: float = 256.0
    # SLO v2 (slo.*): error budgets and burn-rate alerting, off by default
    slo: SloConfig = field(default_factory=SloConfig)

    # the schedules (controller.*): the software-pipelined loop (depth 2
    # only), or K steady-state rounds a scan block (0 = off); exclusive
    pipeline: bool = False
    pipeline_depth: int = 2
    scan_block: int = 0
    # controller.donate_carry: the JAX package's buffer donation of the
    # solver's carry. A captured solve writes into its graph's own buffers,
    # so the port has nothing to donate and reads nothing from this field
    donate_carry: bool = True

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
    # fleet mode only: the tenant indices the profile churns (empty = all)
    elastic_tenants: tuple[int, ...] = ()

    # fleet mode (fleet.*) and its observability (obs.*): the cardinality
    # budget (fleets of at most this many tenants keep per-tenant labeled
    # series; larger fleets suppress them, counted), the device-side tenant
    # rollups riding the round-end bundle, and the worst tenants a rollup
    # records per dimension
    fleet: FleetConfig = field(default_factory=FleetConfig)
    tenant_label_budget: int = 64
    fleet_rollup: bool = True
    fleet_rollup_top_k: int = 3

    # the forecast plane behind algorithm="proactive" (forecast.*) and the
    # request-grain serving plane (serving.*)
    forecast: ForecastConfig = field(default_factory=ForecastConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)

    # fault injection (chaos.*): the named backends/chaos.py profile that
    # wraps the loop's backend ("none" = off) and its fault stream's seed;
    # in fleet mode it wraps fleet.chaos_tenants, tenant t seeded seed + t
    chaos: str = "none"          # chaos.profile
    chaos_seed: int = 0          # chaos.seed

    # shadow mode (shadow.*): replayed trace windows, recommendations in a
    # shadow ledger, the counterfactual twin scored every round
    shadow: ShadowConfig = field(default_factory=ShadowConfig)

    # the perf ledger (perf.*): append-only perf history and its
    # rolling-window regression detector
    perf: PerfConfig = field(default_factory=PerfConfig)

    def validate(self) -> "RescheduleConfig":
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
        if self.solver_restarts < 1 or self.solver_tp < 1:
            raise ValueError("solver_restarts and solver_tp must be >= 1")
        self.retry.validate()
        self.forecast.validate()
        if self.algorithm == "proactive":
            # the global and pod solvers never read the forecast delta: a
            # proactive round routed through them would decide reactively
            if self.moves_per_round == "all":
                raise ValueError(
                    "algorithm='proactive' requires integer moves_per_round: 'all' routes "
                    "the round through the global solver, which does not consume the forecast"
                )
        self.serving.validate()
        if self.serving.enabled and self.algorithm not in POLICY_NAMES:
            raise ValueError(
                "the serving plane scores requests with the greedy machinery: "
                f"serving.enabled requires a greedy algorithm {sorted(POLICY_NAMES)}, "
                f"got {self.algorithm!r}"
            )
        if self.chaos not in CHAOS_PROFILES:
            # backends.chaos.with_chaos's message
            raise ValueError(
                f"unknown chaos profile {self.chaos!r}; expected one of "
                f"{sorted(CHAOS_PROFILES)}"
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
        self._validate_obs()
        self.perf.validate()
        self.slo.validate()
        self._validate_schedules()
        self._validate_elastic()
        self._validate_shadow()
        self._validate_fleet()
        return self

    @classmethod
    def from_toml(cls, path: str | Path) -> "RescheduleConfig":
        """The config of a TOML file in the JAX package's layout
        (:func:`config_from_toml`)."""
        return config_from_toml(path)

    def _validate_shadow(self) -> None:
        """What the JAX package refuses of shadow mode: it is the solo greedy
        or global loop over replayed snapshots, and the planes it cannot
        compose with are refused rather than scored as nonsense."""
        self.shadow.validate()
        if not self.shadow.enabled:
            return
        if self.fleet.tenants > 0:
            raise ValueError(
                "shadow mode is a solo-loop plane: fleet multiplexing has no per-tenant "
                "counterfactual twin yet"
            )
        if self.elastic != "none":
            raise ValueError(
                "shadow mode replays RECORDED churn: the synthetic churn engine cannot "
                "compose with a trace-driven cluster"
            )
        if self.chaos != "none":
            raise ValueError(
                "shadow mode cannot compose with chaos injection: corrupting the replayed "
                "trace poisons the very head-to-head scores the plane exists to produce "
                "(and stale re-serves break the replay backend's fresh-snapshot contract)"
            )
        if self.placement_unit != "service":
            raise ValueError(
                "shadow scoring re-homes whole services (applied_moves is "
                "service-granular); placement_unit='pod' is not supported in shadow mode"
            )
        if not self.reconcile_admission:
            raise ValueError(
                "shadow mode requires the admission guard: replayed real-world snapshots "
                "are exactly the untrusted input it quarantines (and the shadow plane "
                "reuses its pulled host arrays)"
            )

    def _validate_obs(self) -> None:
        """The JAX package's ``ObsConfig.validate`` over the fields the port
        carries."""
        if self.serve_port is not None and not (0 <= self.serve_port <= 65535):
            raise ValueError(f"serve_port must be in [0, 65535], got {self.serve_port}")
        if self.attribution_top_k < 1:
            raise ValueError("attribution_top_k must be >= 1")
        if not (0.0 <= self.attribution_drift_frac <= 1.0):
            raise ValueError("attribution_drift_frac must be in [0, 1]")
        if self.slo_fleet_tail_frac < 0:
            raise ValueError(
                "slo_fleet_tail_frac must be >= 0 (0 disables the fleet_tail_cost rule)")
        if self.flight_recorder_rounds < 1:
            raise ValueError("flight_recorder_rounds must be >= 1")
        if self.max_round_age_s < 0:
            raise ValueError("max_round_age_s must be >= 0")
        if self.slo_window < 2:
            raise ValueError("slo_window must be >= 2")
        if self.slo_min_samples < 1:
            raise ValueError("slo_min_samples must be >= 1")
        if self.slo_latency_p95_s < 0 or self.slo_cost_regression_frac < 0:
            raise ValueError("SLO thresholds must be >= 0")
        if self.slo_max_retraces < 0:
            raise ValueError("slo_max_retraces must be >= 0")
        if self.slo_forecast_min_skill > 1.0:
            raise ValueError(
                "slo_forecast_min_skill must be <= 1.0 (skill is bounded above by 1, so a "
                "larger threshold would always violate)")
        if not (0.0 <= self.slo_pipeline_min_overlap <= 1.0):
            raise ValueError(
                "slo_pipeline_min_overlap must be in [0, 1] (overlap_ratio is a fraction of "
                "background boundary time hidden)")
        if self.slo_reconcile_drift_pods < 0:
            raise ValueError(
                "slo_reconcile_drift_pods must be >= 0 (0 disables the reconcile_divergence "
                "rule)")
        if not (0.0 <= self.slo_shadow_min_win_rate <= 1.0):
            raise ValueError(
                "slo_shadow_min_win_rate must be in [0, 1] (a win-rate fraction; 0 disables "
                "the shadow_win_rate rule)")
        if self.slo_serving_p99_ms < 0:
            raise ValueError(
                "slo_serving_p99_ms must be >= 0 (0 disables the serving_p99 rule)")
        if self.device_label_budget < 0:
            raise ValueError(
                "device_label_budget must be >= 0 (0 = per-device series always "
                "suppressed; the bounded mesh rollups still emit)")
        if self.slo_mesh_imbalance_ratio != 0.0:
            if self.slo_mesh_imbalance_ratio < 1.0:
                raise ValueError(
                    "slo_mesh_imbalance_ratio must be 0 (rule off) or >= 1 (a worst/median "
                    "step-time ratio)")
            raise ValueError(
                "slo_mesh_imbalance_ratio judges the per-device rollups of a multi-device "
                "mesh, which the port does not have yet (ROADMAP Queue 1 item 5)")
        if self.profile_rounds < 0:
            raise ValueError("profile_rounds must be >= 0 (0 = no capture armed at run start)")
        if self.profile_max_captures < 1:
            raise ValueError("profile_max_captures must be >= 1")
        if self.profile_max_mb <= 0:
            raise ValueError("profile_max_mb must be > 0 (the per-artifact size cap)")

    def _validate_fleet(self) -> None:
        if self.tenant_label_budget < 0:
            raise ValueError(
                "tenant_label_budget must be >= 0 (0 = per-tenant series always "
                "suppressed in fleet mode)"
            )
        if self.fleet_rollup_top_k < 1:
            raise ValueError("fleet_rollup_top_k must be >= 1")
        self.fleet.validate()
        if self.fleet.tenants == 0:
            return
        # what the JAX package refuses of fleet mode, for its reasons
        if self.placement_unit != "service":
            raise ValueError(
                "fleet mode requires placement_unit='service': the expanded per-pod "
                "graph is built host-side per tenant, which the batched device plane "
                "cannot amortize"
            )
        greedy_family = (self.algorithm in POLICY_NAMES + ("proactive",)
                         and self.moves_per_round == 1)
        global_family = self.algorithm == "global" or self.moves_per_round == "all"
        if not (greedy_family or global_family):
            raise ValueError(
                "fleet mode batches whole decision planes: it requires a greedy/proactive "
                "algorithm with moves_per_round=1, or a global round (algorithm='global' "
                f"/ moves_per_round='all') (got algorithm={self.algorithm!r}, "
                f"moves_per_round={self.moves_per_round!r})"
            )
        if global_family:
            if self.solver_backend == "sparse":
                raise ValueError(
                    "fleet mode cannot batch solver_backend='sparse': the sparse form's "
                    "degree-sorted block layout is per-tenant structure, so every tenant "
                    "would key its own capture (the dense solver batches; sparse stays solo)"
                )
            if self.global_moves_cap != "all":
                raise ValueError(
                    "fleet mode does not support an integer global_moves_cap: wave-cap "
                    "selection is a sequential host-side re-scoring loop per tenant, "
                    "which defeats the batched dispatch (use move_cost)"
                )
            if self.solver_tp != 1:
                raise ValueError(
                    "fleet mode does not compose with solver_tp yet: the mesh's dp axis "
                    "is the tenant axis (fleet.plane='dp'); node-axis sharding of each "
                    "tenant's solve would need a dp×tp fleet mesh"
                )
            if self.solver_restarts > 1:
                raise ValueError(
                    "fleet restarts (solver_restarts > 1 with fleet mode) fan the tenants' "
                    "restarts out over the fleet's device mesh, which the port does not "
                    "do yet (ROADMAP Queue 1 item 5)"
                )

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
            if self.backend != "sim":
                raise ValueError(
                    "controller scan_block requires the hermetic sim backend: the device "
                    "twin IS the simulator's steady-state update, and a live cluster has "
                    "no twin"
                )
            if self.shadow.enabled:
                raise ValueError(
                    "controller scan_block cannot compose with shadow mode: replayed trace "
                    "windows drive every round, so there is no steady state for the twin "
                    "to scan"
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
        if self.elastic != "none" and self.backend == "k8s":
            raise ValueError(
                "churn injection requires the hermetic sim backend: a live cluster churns "
                "itself"
            )
        if self.bucket_floor < 1:
            raise ValueError(f"bucket_floor must be >= 1, got {self.bucket_floor}")
        for t in self.elastic_tenants:
            if not (isinstance(t, int) and t >= 0):
                raise ValueError(f"elastic tenants must be non-negative ints, got {t!r}")


# The JAX package's TOML layout: its top-level keys, and for each nested
# table the port's flat field of each key (a table absent here is a block
# dataclass the port keeps whole)
TOML_TOP_LEVEL: tuple[str, ...] = (
    "algorithm", "hazard_threshold_pct", "max_rounds", "sleep_after_action_s",
    "moves_per_round", "global_moves_cap", "backend", "enforce_capacity", "capacity_frac",
    "global_solver_iters", "balance_weight", "move_cost", "solver_restarts", "solver_tp",
    "solver_backend", "placement_unit", "seed", "node_capacity", "pod_capacity", "namespace",
    "delete_timeout_s", "delete_poll_interval_s", "max_consecutive_failures",
    "breaker_cooldown_rounds", "failure_budget_per_round",
)
TOML_TABLES: dict[str, dict[str, str]] = {
    "chaos": {"profile": "chaos", "seed": "chaos_seed"},
    "reconcile": {"admission": "reconcile_admission", "enabled": "reconcile_enabled",
                  "repair_budget_per_round": "repair_budget_per_round",
                  "max_quarantine_frac": "max_quarantine_frac"},
    "elastic": {"profile": "elastic", "seed": "elastic_seed", "bucket_floor": "bucket_floor",
                "tenants": "elastic_tenants"},
    "controller": {"pipeline": "pipeline", "depth": "pipeline_depth",
                   "donate_carry": "donate_carry", "scan_block": "scan_block"},
    "obs": {name: name for name in (
        "serve_port", "explain", "explain_top_k", "attribution", "attribution_top_k",
        "attribution_drift_frac", "tenant_label_budget", "fleet_rollup", "fleet_rollup_top_k",
        "slo_fleet_tail_frac", "flight_recorder_rounds", "bundle_dir", "max_round_age_s",
        "slo_window", "slo_min_samples", "slo_latency_p95_s", "slo_cost_regression_frac",
        "slo_max_retraces", "slo_forecast_min_skill", "slo_pipeline_min_overlap",
        "slo_reconcile_drift_pods", "slo_shadow_min_win_rate", "scan_tripwires",
        "tripwire_cost_frac", "tripwire_load_factor", "tripwire_hazard_streak",
        "slo_scan_tripwire", "slo_serving_p99_ms", "device_rollup", "device_label_budget",
        "slo_mesh_imbalance_ratio", "profile_rounds", "profile_max_captures",
        "profile_max_mb")},
}
TOML_BLOCKS = {"retry": RetryPolicy, "shadow": ShadowConfig, "fleet": FleetConfig,
               "forecast": ForecastConfig, "perf": PerfConfig, "serving": ServingConfig,
               "slo": SloConfig}


def _toml_value(v):
    """TOML arrays are lists; the config's sequences are tuples."""
    return tuple(v) if isinstance(v, list) else v


def config_from_toml(path: str | Path) -> RescheduleConfig:
    """A :class:`RescheduleConfig` from a TOML file in the JAX package's
    layout (``RescheduleConfig.from_toml`` there): top-level keys, the
    nested tables mapped onto the flat fields (:data:`TOML_TABLES`) or into
    their block dataclass (:data:`TOML_BLOCKS`). Unknown keys are refused
    as the JAX package refuses them: a ``ValueError`` at the top level, a
    ``TypeError`` inside a table. The result is validated."""
    data = tomllib.loads(Path(path).read_text())
    unknown = set(data) - set(TOML_TOP_LEVEL) - set(TOML_TABLES) - set(TOML_BLOCKS)
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    kwargs = {}
    for key, value in data.items():
        if key in TOML_TABLES and isinstance(value, dict):
            names = TOML_TABLES[key]
            bad = set(value) - set(names)
            if bad:
                raise TypeError(f"[{key}] got unexpected keys {sorted(bad)}")
            kwargs.update({names[k]: _toml_value(v) for k, v in value.items()})
        elif key in TOML_BLOCKS and isinstance(value, dict):
            kwargs[key] = TOML_BLOCKS[key](**{k: _toml_value(v) for k, v in value.items()})
        else:
            kwargs[key] = _toml_value(value)
    return RescheduleConfig(**kwargs).validate()

