"""The experiment matrix and the scenario factory — the port of
``kubernetes_rescheduling_tpu.bench.harness``.

:func:`run_experiment` is the reference's ``auto_full_pipeline_repeat.sh``
(algorithms × repeats, cordon-induced imbalance, three measurement phases)
as a seed-reproducible harness over the simulator or a live cluster. Per
(algorithm, run): a fresh seeded backend, the imbalance injection
(auto_full_pipeline_repeat.sh:48-51), phase r1 (the request stream of
``bench/loadgen.py`` against the "Before" placement, release1.sh), phase r2
(the control loop under sustained load, each round's moved Deployments
down for their teardown, release2.sh:50-59 + main.py) and phase r3 (the
load against the final placement). Results land in
``<out>/session_<name>/<algo>/run_<n>/`` with the reference's CSV schemas,
``rounds.jsonl``, ``log.jsonl``, ``metrics.jsonl``, ``phase1.json`` and
``run.json``, and the session writes ``summary.json``, ``manifest.json``
and the perf ledger. A named session resumes: finished cells reload, a
half-finished one resumes from its latest checkpoint.

Beside it: the scenario factory (:func:`make_backend`: the reference's
µBench cluster and the synthetic meshes up to ``xlarge``, the same
``default_rng(seed)`` call sequence as the JAX package, so one seed builds
the identical cluster in both), ``bench.py``'s sparse problem
(:func:`sparse_problem`) and fleet problem (:func:`make_fleet_problem`),
the forecast plane's head-to-head cell (:func:`run_forecast_headtohead`)
and the chaos soak cell (:func:`run_chaos_soak`).
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE
from kubernetes_rescheduling_tpu_torch.backends.sim import LoadModel, SimBackend
from kubernetes_rescheduling_tpu_torch.core.sparsegraph import from_workmodel
from kubernetes_rescheduling_tpu_torch.core.topology import _random_workmodel, state_from_workmodel
from kubernetes_rescheduling_tpu_torch.bench.loadgen import LoadGenConfig
from kubernetes_rescheduling_tpu_torch.config import (
    SCAN_POLICIES,
    ForecastConfig,
    PerfConfig,
    ReconcileConfig,
    RescheduleConfig,
)
from kubernetes_rescheduling_tpu_torch.core.workmodel import Workmodel, mubench_workmodel_c

SCENARIOS = ("mubench", "dense", "powerlaw", "large", "xlarge")


def make_backend(
    scenario: str, seed: int, device: str | torch.device | None = DEFAULT_DEVICE,
    workmodel_path: str | None = None,
) -> SimBackend:
    """Scenario factory: ``mubench`` (the reference's 20 services on 3
    workers), ``dense`` (200 services × 20 nodes), ``powerlaw`` (2k × 200),
    ``large`` (the 10k × 1k north star) and ``xlarge`` (20k × 2k).
    ``workmodel_path`` swaps the scenario's topology for a µBench workmodel
    JSON, keeping its cluster shape and load model."""
    rng = np.random.default_rng(seed)
    override = Workmodel.from_file(workmodel_path) if workmodel_path is not None else None
    if scenario == "mubench":
        # reference cluster: 3 workers of 20 threads (README.md:44-46); the
        # load drives the cordon-induced pile-up on worker1 to ~85% CPU
        return SimBackend(
            workmodel=override or mubench_workmodel_c(),
            node_names=["worker1", "worker2", "worker3"],
            node_cpu_cap_m=20_000.0,
            seed=seed,
            load=LoadModel(entry_rps=100.0, cost_per_req_m=8.0, idle_m=50.0),
            device=device,
        )
    # synthetic meshes: fanout_frac ≈ 1/(mean forward out-degree) keeps the
    # expected request branching factor at ~1
    if scenario == "dense":
        return SimBackend(
            workmodel=override or _random_workmodel(200, rng, powerlaw=False, mean_degree=8.0),
            node_names=[f"worker{i:04d}" for i in range(20)],
            node_cpu_cap_m=20_000.0,
            seed=seed,
            load=LoadModel(idle_m=40.0, cost_per_req_m=5.0, fanout_frac=0.25),
            device=device,
        )
    if scenario == "powerlaw":
        return SimBackend(
            workmodel=override or _random_workmodel(2000, rng, powerlaw=True, mean_degree=4.0),
            node_names=[f"worker{i:04d}" for i in range(200)],
            node_cpu_cap_m=20_000.0,
            seed=seed,
            load=LoadModel(fanout_frac=0.5),
            device=device,
        )
    if scenario == "large":
        return SimBackend(
            workmodel=override or _random_workmodel(10_000, rng, powerlaw=True, mean_degree=4.0),
            node_names=[f"worker{i:04d}" for i in range(1000)],
            node_cpu_cap_m=2_000.0,
            seed=seed,
            load=LoadModel(
                entry_rps=10.0, cost_per_req_m=0.1, idle_m=50.0, fanout_frac=0.5
            ),
            device=device,
        )
    if scenario == "xlarge":
        # 2× the north star on both axes
        return SimBackend(
            workmodel=override or _random_workmodel(20_000, rng, powerlaw=True, mean_degree=4.0),
            node_names=[f"worker{i:04d}" for i in range(2000)],
            node_cpu_cap_m=2_000.0,
            seed=seed,
            load=LoadModel(
                entry_rps=10.0, cost_per_req_m=0.05, idle_m=50.0, fanout_frac=0.5
            ),
            device=device,
        )
    raise ValueError(f"unknown scenario {scenario!r} (known: {', '.join(SCENARIOS)})")


def sparse_problem(
    n_services: int, n_nodes: int, seed: int = 0,
    device: str | torch.device | None = DEFAULT_DEVICE,
):
    """Power-law mesh past the dense form's sizing wall, built straight
    into the block-local sparse form (the JAX package's ``bench.py``
    ``_sparse_problem``; ``sparse_problem(50_000, 2_000)`` is its
    ``sparse50k``): mean degree 4, ``n_nodes`` nodes of 5000 m CPU.
    Returns ``(state, sparse_graph)``."""
    rng = np.random.default_rng(seed)
    wm = _random_workmodel(n_services, rng, powerlaw=True, mean_degree=4.0)
    graph = from_workmodel(wm, device=device)
    state = state_from_workmodel(
        wm,
        node_names=[f"w{i:05d}" for i in range(n_nodes)],
        node_cpu_cap_m=5_000.0,
        seed=seed,
        device=device,
    )
    return state, graph


def make_fleet_problem(
    tenants: int = 16, n_services: int = 2000, n_nodes: int = 256, seed: int = 0,
    device: str | torch.device | None = DEFAULT_DEVICE,
):
    """The JAX package's fleet bench problem: N same-shaped power-law
    tenants, tenant ``t`` built from seed ``seed*1000 + t`` over an
    identical cluster shape (``n_nodes`` nodes of 2000 m CPU). Returns
    ``(states, graphs)``, index-aligned lists."""
    states, graphs = [], []
    for t in range(tenants):
        rng = np.random.default_rng(seed * 1000 + t)
        wm = _random_workmodel(n_services, rng, powerlaw=True, mean_degree=4.0)
        graphs.append(wm.comm_graph(device=device))
        states.append(state_from_workmodel(
            wm, node_names=[f"w{i:03d}" for i in range(n_nodes)], node_cpu_cap_m=2_000.0,
            seed=seed * 1000 + t, device=device,
        ))
    return states, graphs


def run_forecast_headtohead(
    profiles: tuple[str, ...] = ("diurnal-autoscale", "deploy-waves"),
    rounds: int = 40,
    *,
    scenario: str = "dense",
    seed: int = 1,
    churn_seed: int = 7,
    load_noise_frac: float = 0.05,
    forecast=None,
    logger_factory=None,
    registry=None,
    device: str | torch.device | None = DEFAULT_DEVICE,
) -> dict:
    """The forecast plane's cell: ``proactive`` against reactive CAR on
    identically seeded churned clusters, one pair per churn profile.

    Both arms get the same backend, imbalance, churn stream (profile and
    seed), metric-reading noise (``load_noise_frac``: per-pod gaussian
    noise in the simulator's monitor, the regime where the differenced
    model has an edge over persistence) and round seed; only the algorithm
    differs. Returns per profile each arm's mean and final communication
    cost, mean load std, round and move counts, and the proactive arm's
    last forecast block; ``_records`` holds the records."""
    from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller
    from kubernetes_rescheduling_tpu_torch.config import ForecastConfig, RescheduleConfig

    out: dict = {"rounds": rounds, "scenario": scenario, "profiles": {}}
    for profile in profiles:
        arms: dict[str, dict] = {}
        for algo in ("proactive", "communication"):
            backend = make_backend(scenario, seed, device=device)
            if load_noise_frac:
                backend.load = dataclasses.replace(backend.load, noise_frac=load_noise_frac)
            backend.inject_imbalance(backend.node_names[0])
            cfg = RescheduleConfig(
                algorithm=algo, max_rounds=rounds, sleep_after_action_s=0.0, seed=seed,
                elastic=profile, elastic_seed=churn_seed,
                forecast=forecast if forecast is not None else ForecastConfig(),
            )
            logger = logger_factory() if logger_factory is not None else None
            result = run_controller(backend, cfg, device=device, logger=logger,
                                    registry=registry)
            costs = [r.communication_cost for r in result.rounds]
            arms[algo] = {
                "mean_communication_cost": float(np.mean(costs)) if costs else 0.0,
                "final_communication_cost": costs[-1] if costs else None,
                "mean_load_std": (float(np.mean([r.load_std for r in result.rounds]))
                                  if result.rounds else 0.0),
                "rounds": len(result.rounds),
                "skipped_rounds": result.skipped_rounds,
                "moves": result.moves,
                "forecast": next((r.forecast for r in reversed(result.rounds)
                                  if r.forecast is not None), None),
                "records": result.rounds,
            }
        pro, rea = arms["proactive"], arms["communication"]
        out["profiles"][profile] = {
            **{k: {kk: vv for kk, vv in v.items() if kk != "records"} for k, v in arms.items()},
            "proactive_vs_reactive_cost": (
                pro["mean_communication_cost"] / rea["mean_communication_cost"]
                if rea["mean_communication_cost"] > 0 else 1.0
            ),
            "_records": {k: v["records"] for k, v in arms.items()},
        }
    return out


def run_chaos_soak(
    profile: str = "soak",
    rounds: int = 30,
    *,
    scenario: str = "mubench",
    algorithm: str = "communication",
    seed: int = 0,
    chaos_seed: int = 0,
    max_consecutive_failures: int = 3,
    breaker_cooldown_rounds: int = 2,
    failure_budget_per_round: int = 2,
    retry=None,
    logger=None,
    registry=None,
    ops=None,
    device: str | torch.device | None = DEFAULT_DEVICE,
) -> dict:
    """The chaos soak cell: one seeded fault profile against one scenario
    (piled on its first node), with the loop's degraded-mode machinery on.

    The chaos wrapper is built here, not through ``config.chaos``, so the
    report can hold the wrapper's own ``fault_counts`` against the
    registry's ``chaos_faults_total``: every injected fault is counted,
    every round is accounted (``rounds == records + skipped_rounds``), and
    the loop finishes without raising. The run is one ``bench/chaos_soak``
    span. ``ops`` optionally attaches a live ops plane
    (``telemetry.server.OpsPlane``): ``/healthz`` watches the breaker open
    and recover, and an open transition dumps a flight-recorder bundle."""
    from kubernetes_rescheduling_tpu_torch.backends.chaos import with_chaos
    from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller
    from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig
    from kubernetes_rescheduling_tpu_torch.telemetry.spans import span
    from kubernetes_rescheduling_tpu_torch.utils.retry import RetryPolicy

    backend = make_backend(scenario, seed, device=device)
    backend.inject_imbalance(backend.node_names[0])
    chaos = with_chaos(backend, profile, seed=chaos_seed, registry=registry)
    cfg = RescheduleConfig(
        algorithm=algorithm,
        max_rounds=rounds,
        sleep_after_action_s=0.0,
        seed=seed,
        retry=retry if retry is not None else RetryPolicy(max_attempts=2, base_delay_s=0.05),
        max_consecutive_failures=max_consecutive_failures,
        breaker_cooldown_rounds=breaker_cooldown_rounds,
        failure_budget_per_round=failure_budget_per_round,
    )
    with span("bench/chaos_soak", profile=profile):
        result = run_controller(chaos, cfg, device=device, logger=logger, registry=registry,
                                ops=ops)
    fault_counts = dict(getattr(chaos, "fault_counts", {}))
    return {
        "profile": profile,
        "rounds": rounds,
        "records": len(result.rounds),
        "skipped_rounds": result.skipped_rounds,
        "degraded_rounds": result.degraded_rounds,
        "boundary_failures": result.boundary_failures,
        "moves": result.moves,
        "breaker_transitions": result.breaker_transitions,
        "breaker_opens": sum(1 for t in result.breaker_transitions if t["to"] == "open"),
        "breaker_closes": sum(1 for t in result.breaker_transitions if t["to"] == "closed"),
        "fault_counts": fault_counts,
        "faults_injected": sum(fault_counts.values()),
    }


@dataclass(frozen=True)
class ExperimentConfig:
    """One experiment matrix (the JAX package's ``ExperimentConfig``, its
    fields and defaults). Invalid solver, perf, churn and forecast
    combinations raise at construction, before minutes of phase r1."""

    algorithms: tuple[str, ...] = (
        "spread", "binpack", "random", "kubescheduling", "communication", "global",
    )
    repeats: int = 5                   # reference auto_full_pipeline_repeat.sh:10
    rounds: int = 10                   # reference main.py:28
    scenario: str = "mubench"          # mubench | dense | powerlaw | large | xlarge
    backend: str = "sim"               # sim | k8s (a live cluster, as the reference runs)
    namespace: str = "default"         # k8s backend only (reference main.py:68)
    workmodel: str | None = None       # external workmodel JSON (overrides the topology)
    out_dir: str = "result"
    # a named session resumes: finished (algorithm, run) cells reload from
    # their run.json, a crashed cell resumes from its latest checkpoint;
    # None = a fresh timestamped session every call
    session_name: str | None = None
    seed: int = 0
    hazard_threshold_pct: float = 30.0
    inject_imbalance: bool = True      # the cordon trick
    pacing_s: float = 15.0             # simulated seconds a round (main.py:27)
    load: LoadGenConfig = field(default_factory=LoadGenConfig)
    # λ of the global solver: comm-cost edges traded per load-std point (0
    # would let it keep the "Before" pile-up: cost 0, load std terrible)
    balance_weight: float = 0.5
    solver_restarts: int = 1           # best-of-N solves a round (item 5)
    solver_tp: int = 1                 # node-axis devices a solve (item 5)
    move_cost: float = 0.0             # disruption pricing in the global solve
    solver_backend: str = "dense"      # "dense" | "sparse" pair weights
    placement_unit: str = "service"    # "service" | "pod"
    moves_per_round: int | str = 1     # k per greedy round, or "all"
    global_moves_cap: int | str = "all"  # wave cap of global rounds
    # the global solver's packing budget (a fraction of node capacity)
    enforce_capacity: bool = False
    capacity_frac: float = 1.0
    # solve on OBSERVED traffic: edge weights estimated from the request
    # stream (phase r1, then each round's) instead of the declared topology
    observe_weights: bool = False
    # chaos cells: the named profile wraps each cell's loop backend (the
    # measurement phases stay on the raw backend)
    chaos_profile: str = "none"
    chaos_seed: int = 0
    max_consecutive_failures: int = 5
    # churn cells: a named elastic profile mutates the cluster between
    # rounds; the load phases keep measuring the initial topology
    churn_profile: str = "none"
    churn_seed: int = 0
    forecast: ForecastConfig = field(default_factory=ForecastConfig)
    # the pipelined schedule of the r2 loop (decisions equal to sequential)
    pipeline: bool = False
    pipeline_depth: int = 2
    # the scanned schedule: cells sustain load through on_round, on which
    # the scan drains every round, so scan cells are only applied to the
    # algorithms the scan expresses
    scan_block: int = 0
    reconcile: ReconcileConfig = field(default_factory=ReconcileConfig)
    # the live ops plane across the whole session (None = off, 0 = an
    # ephemeral port); bundles land in bundle_dir (None =
    # <session>/flight_recorder)
    serve_port: int | None = None
    bundle_dir: str | None = None
    # the perf ledger: one decisions/sec reading a finished cell (None =
    # <session>/perf_ledger.jsonl), judged by the rolling-window detector
    perf_enabled: bool = True
    perf_ledger: str | None = None
    perf_window: int = 5
    perf_regression_frac: float = 0.2
    perf_baseline: str = "median"    # "median" | "best" of the window

    def __post_init__(self):
        RescheduleConfig(
            algorithm="global",
            solver_backend=self.solver_backend,
            placement_unit=self.placement_unit,
            solver_restarts=self.solver_restarts,
            solver_tp=self.solver_tp,
            moves_per_round=self.moves_per_round,
            global_moves_cap=self.global_moves_cap,
        ).validate()
        PerfConfig(ledger_path=self.perf_ledger, window=self.perf_window,
                   regression_frac=self.perf_regression_frac,
                   baseline=self.perf_baseline).validate()
        RescheduleConfig(elastic=self.churn_profile, elastic_seed=self.churn_seed).validate()
        self.forecast.validate()
        self.reconcile.validate()
        if self.churn_profile != "none" and self.backend == "k8s":
            raise ValueError("churn_profile requires the sim backend: a live cluster churns itself")
        if self.churn_profile != "none" and self.observe_weights:
            # the estimator's call plan is fixed at cell start: under churn
            # it would steer every solve with the stale topology
            raise ValueError(
                "churn_profile and observe_weights cannot combine yet: the weight "
                "estimator's call plan is fixed at cell start and cannot observe churned "
                "services")
        if self.placement_unit == "pod" and self.backend == "k8s":
            raise ValueError(
                "placement_unit='pod' requires the sim backend: the k8s Deployment mechanism "
                "cannot pin a single replica")


def mubench_reference_placements(
    device: str | torch.device | None = DEFAULT_DEVICE, *, plan=None,
) -> dict:
    """Three placements of the µBench scenario, each monitored through the
    simulator (so the load model couples placement to node utilization):
    the cordon pile-up, the global solve under a 50% packing budget, and a
    seeded random spread. ``plan`` is the global solve's sweep plans (the
    tests' seam for jax's key stream); by default they come from a CPU
    generator seeded 0."""
    from kubernetes_rescheduling_tpu_torch.solver import GlobalSolverConfig, global_assign

    def monitored(kind):
        backend = make_backend("mubench", 0, device=device)
        backend.inject_imbalance(backend.node_names[0])
        st = backend.monitor()
        if kind == "global":
            after, _ = global_assign(
                st, backend.comm_graph(), torch.Generator().manual_seed(0),
                GlobalSolverConfig(sweeps=9, balance_weight=0.5, enforce_capacity=True,
                                   capacity_frac=0.5),
                plan=plan,
            )
            backend.restore_placement(after)
            st = backend.monitor()
        elif kind == "random":
            rng = np.random.default_rng(1)
            valid = st.pod_valid.cpu().numpy()
            nodes = np.where(valid, rng.integers(0, st.num_nodes, st.num_pods),
                             st.pod_node.cpu().numpy())
            backend.restore_placement(st.replace(
                pod_node=torch.as_tensor(nodes, dtype=torch.int32, device=st.pod_node.device)))
            st = backend.monitor()
        return st

    return {k: monitored(k) for k in ("pileup", "global", "random")}


def make_experiment_backend(cfg: ExperimentConfig, seed: int, *,
                            device: str | torch.device | None = DEFAULT_DEVICE, **k8s_apis):
    """The backend of one matrix cell: the simulator, or the live-cluster
    adapter when ``cfg.backend == "k8s"`` (the reference's pipeline always
    runs live). ``k8s_apis`` passes client objects through (the tests
    inject fakes)."""
    if cfg.backend == "k8s":
        from kubernetes_rescheduling_tpu_torch.backends.k8s import K8sBackend

        wm = Workmodel.from_file(cfg.workmodel) if cfg.workmodel else mubench_workmodel_c()
        return K8sBackend(workmodel=wm, namespace=cfg.namespace, device=device, **k8s_apis)
    return make_backend(cfg.scenario, seed, device=device, workmodel_path=cfg.workmodel)


# the phase seeds of a cell: the counterparts of the JAX harness's
# split(PRNGKey(seed), 4) into (_, k_before, k_during, k_after)
PHASE_BEFORE, PHASE_DURING, PHASE_AFTER = 0, 1, 2


def _cell_config(cfg: ExperimentConfig, algo: str, run_i: int, seed: int) -> RescheduleConfig:
    """The r2 loop's config of one cell: every field the JAX harness gives
    its ``RescheduleConfig``."""
    return RescheduleConfig(
        algorithm=algo,
        max_rounds=cfg.rounds,
        hazard_threshold_pct=cfg.hazard_threshold_pct,
        sleep_after_action_s=cfg.pacing_s,  # the simulated clock, not wall
        balance_weight=cfg.balance_weight,
        move_cost=cfg.move_cost,
        solver_backend=cfg.solver_backend,
        placement_unit=cfg.placement_unit,
        solver_restarts=cfg.solver_restarts,
        solver_tp=cfg.solver_tp,
        moves_per_round=cfg.moves_per_round,
        global_moves_cap=cfg.global_moves_cap,
        enforce_capacity=cfg.enforce_capacity,
        capacity_frac=cfg.capacity_frac,
        seed=seed,
        # the loop's view of the backend is wrapped; phases r1 and r3
        # measure the raw backend (faults hit the loop, not the ruler)
        chaos=cfg.chaos_profile,
        chaos_seed=cfg.chaos_seed + run_i,
        elastic=cfg.churn_profile,
        elastic_seed=cfg.churn_seed + run_i,
        forecast=cfg.forecast,
        max_consecutive_failures=cfg.max_consecutive_failures,
        pipeline=cfg.pipeline,
        pipeline_depth=cfg.pipeline_depth,
        # the matrix mixes algorithms: scan only what the scan expresses
        scan_block=(cfg.scan_block
                    if algo in SCAN_POLICIES and cfg.moves_per_round == 1 else 0),
        **cfg.reconcile.flat(),
    )


def run_experiment(
    cfg: ExperimentConfig,
    *,
    device: str | torch.device | None = DEFAULT_DEVICE,
    seams: Callable[[str, int, int], dict] | None = None,
    **backend_kwargs,
) -> dict:
    """Run the whole matrix on ``device``; returns (and writes) the summary.

    With ``cfg.session_name`` the session resumes after a crash: finished
    (algorithm, run) cells reload from their ``run.json``, and a
    half-finished cell restores the simulator from its latest round
    checkpoint and goes on. With ``cfg.serve_port`` one live ops plane
    serves the whole session (``/metrics`` across cells, ``/healthz`` of
    the running cell, bundles under ``<session>/flight_recorder``).

    ``seams(algo, run_i, seed)`` returns the random streams of one cell, the
    tests' way to feed jax's: any of ``gumbel_rows`` and ``solver_plans``
    (``run_controller``'s seams), ``draws_before`` and ``draws_after`` (a
    phase's ``draws(chunk_i)``) and ``draws_during`` (``segment_i`` →
    ``draws``). ``backend_kwargs`` reach :func:`make_experiment_backend`."""
    from kubernetes_rescheduling_tpu_torch._random import derive_seed
    from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller
    from kubernetes_rescheduling_tpu_torch.bench.loadgen import LoadGenerator, new_samples
    from kubernetes_rescheduling_tpu_torch.bench.sinks import (
        JsonlSink,
        communication_cost_sink,
        node_std_sink,
    )
    from kubernetes_rescheduling_tpu_torch.objectives.metrics import (
        communication_cost,
        load_std,
    )
    from kubernetes_rescheduling_tpu_torch.telemetry import (
        get_registry,
        span,
        write_manifest,
    )
    from kubernetes_rescheduling_tpu_torch.telemetry import perf_ledger as pl
    from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger

    from kubernetes_rescheduling_tpu_torch._device import resolve_device

    device = resolve_device(device)  # a card asked for and absent raises here
    stamp = cfg.session_name or time.strftime("%Y%m%d_%H%M%S")
    session = Path(cfg.out_dir) / f"session_{stamp}"
    cfg_dict = dataclasses.asdict(cfg)
    summary: dict = {"config": cfg_dict, "runs": []}

    # one ledger for the session (or a shared file): each cell appends its
    # decisions/sec, keyed so that only like readings compare
    ledger = (pl.PerfLedger(cfg.perf_ledger or session / "perf_ledger.jsonl")
              if cfg.perf_enabled else None)
    cell_digest = pl.config_digest(
        {k: v for k, v in cfg_dict.items() if k not in ("out_dir", "session_name")})
    device_kind = pl.device_kind(device)

    ops = None
    if cfg.serve_port is not None:
        from kubernetes_rescheduling_tpu_torch.telemetry import OpsPlane

        ops = OpsPlane.from_config(
            RescheduleConfig(serve_port=cfg.serve_port),
            bundle_dir=cfg.bundle_dir or str(session / "flight_recorder"),
        ).start()

    try:
        if cfg.session_name:
            # a resumed session must be the same experiment
            session.mkdir(parents=True, exist_ok=True)
            fingerprint = {k: v for k, v in cfg_dict.items() if k != "out_dir"}
            fp_file = session / "config.json"
            if fp_file.is_file():
                saved = json.loads(fp_file.read_text())
                if saved != json.loads(json.dumps(fingerprint, default=float)):
                    raise ValueError(
                        f"session {cfg.session_name!r} was created with a different config; "
                        f"refusing to mix results (delete {session} or use a new session name)")
            else:
                fp_file.write_text(json.dumps(fingerprint, default=float))

        # provenance after the fingerprint gate; a resume keeps the manifest
        # of the run that produced the existing cells
        manifest_file = session / "manifest.json"
        if manifest_file.is_file():
            manifest_file = session / "manifest.resume.json"
        write_manifest(manifest_file, json.loads(json.dumps(cfg_dict, default=float)))

        for algo in cfg.algorithms:
            for run_i in range(1, cfg.repeats + 1):
                run_dir = session / algo / f"run_{run_i}"
                run_dir.mkdir(parents=True, exist_ok=True)
                run_marker = run_dir / "run.json"
                if cfg.session_name and run_marker.is_file():
                    summary["runs"].append(json.loads(run_marker.read_text()))
                    continue
                seed = cfg.seed * 1000 + run_i
                seam = seams(algo, run_i, seed) if seams is not None else {}
                backend = make_experiment_backend(cfg, seed, device=device, **backend_kwargs)
                if cfg.inject_imbalance and hasattr(backend, "inject_imbalance"):
                    backend.inject_imbalance(backend.node_names[0])

                graph = backend.comm_graph()
                load_model = getattr(backend, "load", None)
                loadgen = LoadGenerator(
                    backend.workmodel, cfg.load,
                    fanout_frac=load_model.fanout_frac if load_model else 1.0,
                    device=device,
                )
                k_before, k_during, k_after = (derive_seed(seed, p) for p in (
                    PHASE_BEFORE, PHASE_DURING, PHASE_AFTER))
                std_sink = node_std_sink(run_dir)
                cost_sink = communication_cost_sink(run_dir)
                rounds_sink = JsonlSink(run_dir / "rounds.jsonl")
                logger = StructuredLogger(name=f"{algo}/run_{run_i}", path=run_dir / "log.jsonl")

                # phase r1, persisted at once so that a resume never
                # re-measures "before" on a half-rescheduled cluster
                phase1 = run_dir / "phase1.json"
                if cfg.session_name and phase1.is_file():
                    saved = json.loads(phase1.read_text())
                    before_metrics = saved["before"]
                    load_before_dict = saved["load_before"]
                    edge_counts = (np.asarray(saved["edge_counts"], dtype=np.int64)
                                   if saved.get("edge_counts") is not None else None)
                    obs_sent = int(saved.get("obs_sent", 0))
                else:
                    before = backend.monitor()
                    samples_before = loadgen.run(before, k_before,
                                                 draws=seam.get("draws_before"))
                    load_before = samples_before.stats()
                    load_before_dict = load_before.as_dict()
                    edge_counts = samples_before.edge_counts
                    obs_sent = samples_before.sent
                    before_metrics = {
                        "communication_cost": float(communication_cost(before, graph)),
                        "load_std": float(load_std(before)),
                        "response_time_ms": load_before.latency_avg_ms,
                    }
                    std_sink.append(before_metrics["load_std"])
                    phase1.write_text(json.dumps({
                        "before": before_metrics,
                        "load_before": load_before_dict,
                        "edge_counts": (edge_counts.tolist()
                                        if edge_counts is not None else None),
                        "obs_sent": obs_sent,
                    }, default=float))

                # the DECISION graph on observed traffic: seeded by phase r1
                # and re-estimated each round from the sustained load's
                # counts; the reported costs stay on the declared graph
                def solve_graph(_counts=edge_counts, _sent=obs_sent):
                    total, n = _counts, _sent
                    if during.edge_counts is not None:
                        total = (during.edge_counts if total is None
                                 else total + during.edge_counts)
                        n += during.sent
                    return loadgen.observed_graph(total, n, graph)

                # phase r2: the loop under sustained load, each round's
                # segment with a teardown outage per moved Deployment
                rcfg = _cell_config(cfg, algo, run_i, seed)
                during = new_samples()

                def clock(_backend=backend):
                    # the simulated clock; a live cluster's wall time
                    c = getattr(_backend, "clock_s", None)
                    return time.monotonic() if c is None else c

                seg_state = {"clock": clock(), "i": 0}

                def on_round(rec, state, _ss=seg_state, _during=during):
                    # the sinks written in the loop: a crash keeps the
                    # finished rounds' rows for the resumed session
                    std_sink.append(rec.load_std)
                    rounds_sink.append(rec.as_dict())
                    now = clock()
                    seg_dur = max(now - _ss["clock"], 1e-9)
                    _ss["clock"] = now
                    n_req = max(int(cfg.load.requests_per_phase * seg_dur
                                    / max(cfg.load.duration_s, 1e-9)), 64)
                    # read each round: a live backend measures its
                    # delete → recreate time after each move
                    reconcile = getattr(backend, "reconcile_delay_s", 10.0)
                    outages = [(svc, i * reconcile, (i + 1) * reconcile)
                               for i, svc in enumerate(rec.services_moved)]
                    seg, seg_draws = _ss["i"], seam.get("draws_during")
                    loadgen.run(state, derive_seed(k_during, seg), duration_s=seg_dur,
                                n_requests=n_req, outages=outages, samples=_during,
                                draws=seg_draws(seg) if seg_draws is not None else None)
                    _ss["i"] += 1

                events = getattr(backend, "events", None)
                events_mark = len(events) if events is not None else 0
                # a live cluster: per-pod restartCount before the loop, so
                # its container crashes are a measured delta
                crash_probe = getattr(backend, "pod_restart_counts", None)
                crashes_at_start = crash_probe() if crash_probe else None
                t0 = time.perf_counter()
                with span("bench/run", algorithm=algo, run=run_i):
                    result = run_controller(
                        backend, rcfg, device=device, on_round=on_round,
                        checkpoint_dir=(str(run_dir / "checkpoints")
                                        if cfg.session_name else None),
                        logger=logger,
                        graph=solve_graph if cfg.observe_weights else None,
                        gumbel_rows=seam.get("gumbel_rows"),
                        solver_plans=seam.get("solver_plans"),
                        ops=ops,
                    )
                wall_s = time.perf_counter() - t0
                # restarts: pods re-created by the moves — from the event
                # log on the simulator, from the moved services' replicas
                # on a live cluster (each moved Deployment restarts all)
                if events is not None:
                    during.restarts = sum(
                        int(e.get("pods", 0)) for e in events[events_mark:]
                        if e.get("event") in ("move", "pod_moves"))
                    restart_source = "event_log"
                else:
                    replicas = {s.name: max(1, s.replicas) for s in backend.workmodel.services}
                    during.restarts = sum(replicas.get(svc, 1) for rec in result.rounds
                                          for svc in rec.services_moved)
                    restart_source = "derived_from_moves"
                # the reference's restartCount (release1.sh:101-102) as a
                # measured per-pod delta
                crashes_at_end = crash_probe() if crash_probe else None
                if crashes_at_start is not None and crashes_at_end is not None:
                    during.container_crashes = sum(
                        max(c - crashes_at_start.get(pod, 0), 0)
                        for pod, c in crashes_at_end.items())
                load_during = during.stats()

                # phase r3 on the healed cluster: a chaos cell may end with
                # a worker still killed
                if cfg.chaos_profile != "none":
                    revive = getattr(backend, "revive_node", None)
                    if revive is not None:
                        for node in backend.node_names:
                            revive(node)
                    pending = getattr(backend, "schedule_pending", None)
                    if pending is not None:
                        pending()
                after = backend.monitor()
                load_after = loadgen.measure(after, k_after, draws=seam.get("draws_after"))
                after_metrics = {
                    "communication_cost": float(communication_cost(after, graph)),
                    "load_std": float(load_std(after)),
                    "response_time_ms": load_after.latency_avg_ms,
                }
                cost_sink.append(after_metrics["communication_cost"])

                run_record = {
                    "algorithm": algo,
                    "run": run_i,
                    "seed": seed,
                    "before": before_metrics,
                    "after": after_metrics,
                    "load": {
                        "before": load_before_dict,
                        "during": load_during.as_dict(),
                        "after": load_after.as_dict(),
                    },
                    "moves": result.moves,
                    "restart_source": restart_source,
                    "decisions_per_sec": result.decisions_per_sec,
                    "decision_latency": result.latency_summary(),
                    "resumed_from_round": result.resumed_from_round,
                    "skipped_rounds": result.skipped_rounds,
                    "degraded_rounds": result.degraded_rounds,
                    "boundary_failures": result.boundary_failures,
                    "breaker_transitions": result.breaker_transitions,
                    "wall_s": wall_s,
                    "sim_clock_s": getattr(backend, "clock_s", None),
                }
                run_marker.write_text(json.dumps(run_record, default=float))
                logger.info("run_complete", moves=result.moves)
                # a cumulative registry snapshot a cell (the report reads
                # the last sample of each series)
                get_registry().dump_jsonl(run_dir / "metrics.jsonl")
                summary["runs"].append(run_record)
                if ledger is not None:
                    # one entry a cell, then every series re-judged: a
                    # regression arms the plane's perf_regression rule
                    ledger.append(
                        metric="decisions_per_sec", value=result.decisions_per_sec,
                        unit="1/s", scenario=f"{cfg.scenario}/{algo}",
                        device_kind=device_kind, digest=cell_digest, better="higher",
                        run=run_i, seed=seed,
                    )
                    if ops is not None:
                        ops.observe_perf(pl.detect(
                            ledger.entries(), window=cfg.perf_window,
                            threshold_frac=cfg.perf_regression_frac,
                            baseline=cfg.perf_baseline))

        # per-algorithm means; the loop-phase metrics only over runs that
        # executed rounds (a resumed cell whose loop had finished adds zeros)
        agg: dict[str, dict] = {}
        for algo in cfg.algorithms:
            runs = [r for r in summary["runs"] if r["algorithm"] == algo]
            looped = [r for r in runs if r["decision_latency"].get("count", 0) > 0]

            def loop_mean(metric_fn):
                return float(np.mean([metric_fn(r) for r in looped])) if looped else 0.0

            agg[algo] = {
                "communication_cost": float(np.mean(
                    [r["after"]["communication_cost"] for r in runs])),
                "load_std": float(np.mean([r["after"]["load_std"] for r in runs])),
                "response_time_ms": float(np.mean(
                    [r["after"]["response_time_ms"] for r in runs])),
                "error_rate_during": loop_mean(lambda r: r["load"]["during"]["error_rate"]),
                "restarts": loop_mean(lambda r: r["load"]["during"]["restarts"]),
                "decisions_per_sec": loop_mean(lambda r: r["decisions_per_sec"]),
            }
        summary["aggregate"] = agg

        session.mkdir(parents=True, exist_ok=True)
        (session / "summary.json").write_text(json.dumps(summary, indent=2, default=float))
    finally:
        # close the live endpoint however the matrix ends
        if ops is not None:
            ops.close()
    return summary
