"""Command line of the port: ``reschedule`` (the control loop on the
simulator), ``solve`` (one global rescheduling round) and ``trace`` (online
rescheduling over a streaming trace), printing the JSON keys of the JAX
package's commands for what the port computes.

    python -m kubernetes_rescheduling_tpu_torch reschedule --algorithm car --imbalance
    python -m kubernetes_rescheduling_tpu_torch reschedule --algorithm global --scenario large
    python -m kubernetes_rescheduling_tpu_torch reschedule --algorithm global --global-moves-cap 10
    python -m kubernetes_rescheduling_tpu_torch reschedule --algorithm global --placement-unit pod
    python -m kubernetes_rescheduling_tpu_torch reschedule --scenario large --scan-block 10
    python -m kubernetes_rescheduling_tpu_torch reschedule --scenario large --pipeline
    python -m kubernetes_rescheduling_tpu_torch reschedule --churn-profile diurnal-autoscale
    python -m kubernetes_rescheduling_tpu_torch reschedule --fleet 16 --scenario mubench --imbalance
    python -m kubernetes_rescheduling_tpu_torch reschedule --fleet 4 --scenario large --algorithm global
    python -m kubernetes_rescheduling_tpu_torch reschedule --algorithm proactive --churn-profile diurnal-autoscale
    python -m kubernetes_rescheduling_tpu_torch solve --scenario large
    python -m kubernetes_rescheduling_tpu_torch solve --scenario large --sparse
    python -m kubernetes_rescheduling_tpu_torch solve --scenario large --placement-unit pod
    python -m kubernetes_rescheduling_tpu_torch solve --scenario large --latency-budget 100
    python -m kubernetes_rescheduling_tpu_torch trace --steps 12

All run on the card unless ``--device cpu`` is given. ``--sparse`` (and
``reschedule --solver-backend sparse``) solves on the block-local sparse
form of the scenario's graph; ``--placement-unit pod`` re-places every pod
on its own, on the pod-level sparse graph; ``--latency-budget`` picks the
sweep count that fills that many ms of device time a round
(``solver/autotune.py``). ``reschedule --pipeline`` runs the pipelined
schedule, ``--scan-block K`` the scanned one (K rounds a device block, with
the in-block tripwires), and ``--churn-profile`` churns the cluster between
rounds. ``reschedule --fleet N`` runs N tenants under the multiplexed fleet
loop (``bench/fleet.py``). ``reschedule --algorithm proactive`` decides
against the forecast plane's predicted next window (``--forecast-*`` set
its ``ForecastConfig``). Best-of-N restarts and node sharding
(``--restarts``, ``--tp`` above 1), the telemetry files (``--metrics-out``,
``--trace-out``) and the serving front (``--place``, which needs the ops
server's ``POST /place``) are refused, naming the ROADMAP item that brings
them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller
from kubernetes_rescheduling_tpu_torch.bench.harness import SCENARIOS, make_backend
from kubernetes_rescheduling_tpu_torch.bench.trace import (
    bookinfo_workmodel,
    canary_trace,
    load_trace,
    replay,
)
from kubernetes_rescheduling_tpu_torch.config import FleetConfig, ForecastConfig, RescheduleConfig
from kubernetes_rescheduling_tpu_torch.core.sparsegraph import from_comm_graph
from kubernetes_rescheduling_tpu_torch.core.topology import state_from_workmodel
from kubernetes_rescheduling_tpu_torch.core.workmodel import Workmodel
from kubernetes_rescheduling_tpu_torch.objectives import communication_cost, load_std
from kubernetes_rescheduling_tpu_torch.solver import (
    GlobalSolverConfig,
    global_assign,
    global_assign_pods,
    global_assign_sparse,
    pod_level_graph,
)
from kubernetes_rescheduling_tpu_torch.solver.autotune import tune_sweeps


ALGO_ALIASES = {"car": "communication"}
WORKMODEL_HELP = ("path to a µBench workmodel JSON (e.g. workmodelC.json); "
                  "overrides the scenario's builtin topology")


def _norm_algo(name: str) -> str:
    name = name.strip().lower()
    return ALGO_ALIASES.get(name, name)


def _moves_per_round(value: str) -> int | str:
    if value == "all":
        return "all"
    try:
        n = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected a positive int or 'all', got {value!r}")
    if n < 1:
        raise argparse.ArgumentTypeError(f"expected a positive int or 'all', got {value!r}")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kubernetes_rescheduling_tpu_torch",
        description="Communication-aware Kubernetes rescheduling on PyTorch/CUDA",
    )
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("reschedule", help="run the rescheduling control loop")
    r.add_argument("--algorithm", default="communication",
                   help="spread|binpack|random|kubescheduling|communication|car|global|"
                        "proactive")
    r.add_argument("--backend", default="sim",
                   help="sim (the only backend the port drives so far)")
    r.add_argument("--scenario", default="mubench", choices=SCENARIOS)
    r.add_argument("--workmodel", default=None, help=WORKMODEL_HELP)
    r.add_argument("--rounds", type=int, default=10)
    r.add_argument("--threshold", type=float, default=30.0)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--imbalance", action="store_true",
                   help="inject the cordon-style imbalance before starting")
    r.add_argument("--moves-per-round", type=_moves_per_round, default=1,
                   help="deployments moved per round: a positive int "
                        "(1 = reference-faithful) or 'all' (global solve)")
    r.add_argument("--balance-weight", type=float, default=0.0,
                   help="λ: comm-cost edges traded per load-std point (global algorithm)")
    r.add_argument("--capacity-frac", type=float, default=None,
                   help="enable capacity enforcement with this packing budget "
                        "(fraction of node capacity)")
    r.add_argument("--move-cost", type=float, default=0.0,
                   help="disruption pricing: comm-weight units per restarted pod "
                        "inside the global solve (0 = moves are free)")
    r.add_argument("--solver-backend", default="dense", choices=["dense", "sparse"],
                   help="pair-weight storage for global rounds (sparse = block-local form)")
    r.add_argument("--global-moves-cap", type=_moves_per_round, default="all",
                   help="apply only the k highest-gain improving moves per "
                        "global round ('all' = uncapped)")
    r.add_argument("--placement-unit", default="service", choices=["service", "pod"],
                   help="pod = every replica places independently (global algorithm)")
    r.add_argument("--chaos-profile", default="none", metavar="NAME",
                   help="wrap the loop's backend in the fault-injecting ChaosBackend under "
                        "this named profile (none|flaky-monitor|flaky-moves|node-flap|soak|"
                        "reconcile); faults are seeded and counted as chaos_faults_total{kind}")
    r.add_argument("--chaos-seed", type=int, default=0,
                   help="seed for the injected fault stream (reproducible chaos)")
    r.add_argument("--churn-profile", default="none", metavar="NAME",
                   help="elastic topology churn between rounds under this seeded profile "
                        "(none|steady|diurnal-autoscale|deploy-waves|node-flap): services "
                        "deploy and tear down, replicas autoscale, nodes drain and join")
    r.add_argument("--churn-seed", type=int, default=0,
                   help="seed of the churn event stream")
    r.add_argument("--pipeline", action="store_true",
                   help="the software-pipelined loop: the previous round's round-end "
                        "transfer and record overlap this round's device work, and the "
                        "post-move monitor runs on a background thread; the records equal "
                        "the sequential loop's. Rounds it cannot honor (open breaker, "
                        "churn) drain to the sequential path. With --fleet N: the tenants' "
                        "boundary phases run on a worker pool, each tenant's records equal "
                        "to the serial fleet's")
    r.add_argument("--pipeline-depth", type=int, default=2,
                   help="depth of the pipelined loop; only 2 is implemented")
    r.add_argument("--scan-block", type=int, default=0,
                   help="the scanned schedule: K steady-state rounds a device block (decide, "
                        "the simulator's twin and the round-end metrics, one counted "
                        "round_end transfer a block); rounds it cannot honor drain to the "
                        "per-round path. A pinning greedy algorithm with one move a round; "
                        "exclusive with --pipeline. 0 = off")
    r.add_argument("--no-scan-tripwires", action="store_true",
                   help="turn off the in-block tripwires (device-side health rules in the "
                        "scan body; a trip latches the rest of the block to no-move rounds "
                        "and drains the trip round)")
    r.add_argument("--tripwire-cost-frac", type=float, default=0.0,
                   help="tripwire cost_regression rule: cost rising more than this fraction "
                        "above the block-start baseline trips (0 = off)")
    r.add_argument("--tripwire-load-factor", type=float, default=0.0,
                   help="tripwire load_std_spike rule: load std above this factor of the "
                        "block-start baseline trips (0 = off)")
    r.add_argument("--tripwire-hazard-streak", type=int, default=0,
                   help="tripwire hazard_streak rule: the same most-hazardous node this many "
                        "rounds in a row trips (0 = off)")
    r.add_argument("--fleet", type=int, default=0, metavar="N",
                   help="fleet mode: N tenants of the scenario (tenant t seeded seed*1000+t) "
                        "under the multiplexed loop, one boundary and breaker a tenant and "
                        "ONE device decision a round (greedy policies, or --algorithm global)")
    r.add_argument("--fleet-plane", default="vmap", choices=["vmap", "dp"],
                   help="device batching for --fleet: 'vmap' (one program over the "
                        "tenants); 'dp' is refused (ROADMAP Queue 1 item 5)")
    r.add_argument("--fleet-chaos-tenants", default="", metavar="I,J,...",
                   help="tenant indices the --chaos-profile wraps (empty = every tenant; "
                        "tenant t's faults seeded --chaos-seed + t)")
    r.add_argument("--tenant-label-budget", type=int, default=64, metavar="N",
                   help="fleet cardinality budget: fleets of more than N tenants suppress "
                        "the per-tenant labeled series (counted) and observe through the "
                        "device-side rollups")
    _add_forecast_flags(r)
    r.add_argument("--place", action="store_true",
                   help="serving mode: the request-grain placement service behind the ops "
                        "server's POST /place (refused: the ops server is ROADMAP Queue 1 "
                        "item 4.2; build serving.ServingEngine in code instead)")
    r.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")

    s = sub.add_parser("solve", help="one-shot global solve")
    s.add_argument("--scenario", default="large", choices=SCENARIOS)
    s.add_argument("--workmodel", default=None, help=WORKMODEL_HELP)
    s.add_argument("--sweeps", type=int, default=9)
    s.add_argument("--balance-weight", type=float, default=0.0)
    s.add_argument("--capacity-frac", type=float, default=1.0,
                   help="packing budget as a fraction of node capacity "
                        "(solver feasibility + over-budget repulsion)")
    s.add_argument("--move-cost", type=float, default=0.0,
                   help="disruption pricing: comm-weight units per restarted "
                        "pod (0 = moves are free)")
    s.add_argument("--sparse", action="store_true",
                   help="solve on the block-local sparse pair-weight form")
    s.add_argument("--placement-unit", choices=("service", "pod"), default="service",
                   help="pod: re-place every pod independently on the pod-level graph")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--restarts", type=int, default=1,
                   help="best-of-N independent solves (only 1 is ported)")
    s.add_argument("--tp", type=int, default=1,
                   help="node-axis devices per solve (only 1 is ported)")
    s.add_argument("--latency-budget", type=float, default=None,
                   help="auto-tune the sweep count to fill this many ms of "
                        "device time per round (overrides --sweeps)")
    s.add_argument("--device", default="cuda",
                   help="torch device to solve on (default: cuda)")

    t = sub.add_parser(
        "trace",
        help="streaming trace replay: online rescheduling as edge weights "
             "shift (external workmodel + trace stream, or the builtin "
             "Bookinfo canary rollout demo)",
    )
    t.add_argument("--workmodel", default=None,
                   help="external µBench workmodel JSON to replay over "
                        "(default: builtin Bookinfo)")
    t.add_argument("--trace", default=None,
                   help="external trace stream (JSONL, one step per line: "
                        '{"t": 1.0, "weights": [["a", "b", 0.9], ...]}); '
                        "default: the builtin canary schedule")
    t.add_argument("--steps", type=int, default=12,
                   help="builtin canary steps (ignored with --trace)")
    t.add_argument("--replicas", type=int, default=1,
                   help="replicas per service (builtin workmodel only)")
    t.add_argument("--nodes", type=int, default=3)
    t.add_argument("--sweeps", type=int, default=4)
    t.add_argument("--balance-weight", type=float, default=0.5)
    t.add_argument("--capacity-frac", type=float, default=None,
                   help="enable capacity enforcement with this packing "
                        "budget (fraction of node capacity)")
    t.add_argument("--restarts", type=int, default=1,
                   help="best-of-N solves per trace step (only 1 is ported)")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="the metrics registry as JSONL (not ported)")
    t.add_argument("--trace-out", default=None, metavar="PATH",
                   help="host-side spans as Chrome trace JSON (not ported)")
    t.add_argument("--device", default="cuda",
                   help="torch device to replay on (default: cuda)")
    return p


def _add_forecast_flags(parser: argparse.ArgumentParser) -> None:
    """The forecast plane behind ``--algorithm proactive``; the defaults are
    ``ForecastConfig``'s, so a CLI run and a run built in code agree."""
    d = ForecastConfig()
    parser.add_argument("--forecast-lags", type=int, default=d.lags,
                        help="lag-feature window of the online per-node ridge forecaster "
                             "(proactive algorithm)")
    parser.add_argument("--forecast-decay", type=float, default=d.decay,
                        help="exponential weight of the rolling skill window per scored "
                             "round (~1/(1-decay) rounds dominate; 1.0 = cumulative)")
    parser.add_argument("--forecast-ridge", type=float, default=d.ridge,
                        help="L2 regularization of the per-node ridge fits (keeps cold "
                             "solves well-posed)")
    parser.add_argument("--forecast-min-history", type=int, default=d.min_history,
                        help="observations a node needs before its model prediction is "
                             "trusted; until then proactive rounds equal reactive CAR's")
    parser.add_argument("--forecast-min-skill", type=float, default=d.min_skill,
                        help="degrade gate: when forecast_skill (1 - mae_model/"
                             "mae_persistence) drops below this, proactive rounds fall back "
                             "to reactive CAR while the shadow model keeps scoring")


def _forecast_config(args) -> ForecastConfig:
    return ForecastConfig(lags=args.forecast_lags, ridge=args.forecast_ridge,
                          min_history=args.forecast_min_history,
                          min_skill=args.forecast_min_skill, decay=args.forecast_decay)


def _refuse_unported(command: str, args) -> None:
    """Exit naming the ROADMAP item of a flag the port does not carry yet."""
    if getattr(args, "restarts", 1) > 1 or getattr(args, "tp", 1) > 1:
        raise SystemExit(f"{command}: --restarts and --tp above 1 need parallel/sharded.py, "
                         "not ported yet (ROADMAP Queue 1 item 5)")
    if getattr(args, "metrics_out", None) or getattr(args, "trace_out", None):
        raise SystemExit(f"{command}: --metrics-out and --trace-out need the telemetry "
                         "plane (telemetry/spans.py), not ported yet (ROADMAP Queue 1 item 4.2)")
    if getattr(args, "place", False):
        raise SystemExit(f"{command}: --place serves placements through the ops server's "
                         "POST /place (telemetry/server.py), not ported yet (ROADMAP Queue 1 "
                         "item 4.2); serving.ServingEngine runs without it in code")


def _parse_tenant_list(raw: str) -> tuple[int, ...]:
    try:
        return tuple(int(x) for x in raw.split(",") if x.strip())
    except ValueError:
        raise SystemExit(
            f"--fleet-chaos-tenants must be comma-separated ints, got {raw!r}") from None


def cmd_reschedule(args) -> dict:
    _refuse_unported("reschedule", args)
    algo = _norm_algo(args.algorithm)
    if args.fleet and args.backend != "sim":
        raise SystemExit("--fleet requires the sim backend (one live cluster is one tenant; "
                         "fleet mode multiplexes hermetic tenants)")
    # every solver-shaping flag reaches the config, so the fleet validation
    # refuses what fleet mode cannot batch instead of running something else
    cfg = RescheduleConfig(
        algorithm=algo,
        max_rounds=args.rounds,
        hazard_threshold_pct=args.threshold,
        sleep_after_action_s=0.0,
        moves_per_round=args.moves_per_round,
        balance_weight=args.balance_weight,
        move_cost=args.move_cost,
        solver_backend=args.solver_backend,
        global_moves_cap=args.global_moves_cap,
        placement_unit=args.placement_unit,
        enforce_capacity=args.capacity_frac is not None,
        capacity_frac=args.capacity_frac if args.capacity_frac is not None else 1.0,
        seed=args.seed,
        backend=args.backend,
        chaos=args.chaos_profile,
        chaos_seed=args.chaos_seed,
        pipeline=args.pipeline,
        pipeline_depth=args.pipeline_depth,
        scan_block=args.scan_block,
        scan_tripwires=not args.no_scan_tripwires,
        tripwire_cost_frac=args.tripwire_cost_frac,
        tripwire_load_factor=args.tripwire_load_factor,
        tripwire_hazard_streak=args.tripwire_hazard_streak,
        elastic=args.churn_profile,
        elastic_seed=args.churn_seed,
        fleet=FleetConfig(tenants=args.fleet, plane=args.fleet_plane,
                          chaos_tenants=_parse_tenant_list(args.fleet_chaos_tenants)),
        tenant_label_budget=args.tenant_label_budget,
        forecast=_forecast_config(args),
    )
    try:
        cfg.validate()
    except ValueError as e:
        raise SystemExit(f"{'--fleet' if args.fleet else 'reschedule'}: {e}") from None
    if args.fleet:
        return _run_fleet(args, cfg)
    backend = make_backend(args.scenario, args.seed, device=args.device,
                           workmodel_path=args.workmodel)
    if args.imbalance:
        backend.inject_imbalance(backend.node_names[0])
    result = run_controller(backend, cfg, device=args.device)
    return {
        "algorithm": algo,
        "rounds": [rec.as_dict() for rec in result.rounds],
        "moves": result.moves,
        "decisions_per_sec": result.decisions_per_sec,
        "skipped_rounds": result.skipped_rounds,
        "degraded_rounds": result.degraded_rounds,
        "boundary_failures": result.boundary_failures,
        "breaker_transitions": result.breaker_transitions,
    }


def _run_fleet(args, cfg: RescheduleConfig) -> dict:
    """``reschedule --fleet N``: N tenants of the scenario under the
    multiplexed loop; prints the JAX package's keys (per-tenant round
    streams and the amortized fleet-decision cost)."""
    from kubernetes_rescheduling_tpu_torch.backends.fleet import make_fleet
    from kubernetes_rescheduling_tpu_torch.bench.fleet import run_fleet_controller

    fleet = make_fleet(args.scenario, args.fleet, seed=args.seed,
                       workmodel_path=args.workmodel, device=args.device)
    if args.imbalance:
        fleet.inject_imbalance()
    result = run_fleet_controller(fleet, cfg, device=args.device)
    return {
        "algorithm": cfg.algorithm,
        "fleet": {"tenants": args.fleet, "plane": args.fleet_plane},
        "batched_solves": result.batched_solves,
        "amortized_solve_ms_per_tenant_round": round(
            result.amortized_solve_ms_per_tenant_round, 4),
        "per_tenant": {
            name: {
                "rounds": len(r.rounds),
                "skipped_rounds": r.skipped_rounds,
                "degraded_rounds": r.degraded_rounds,
                "moves": r.moves,
                "boundary_failures": r.boundary_failures,
                "final_communication_cost": (r.rounds[-1].communication_cost
                                             if r.rounds else None),
                "final_load_std": r.rounds[-1].load_std if r.rounds else None,
            }
            for name, r in result.results.items()
        },
    }


def cmd_trace(args) -> dict:
    _refuse_unported("trace", args)
    wm = (
        Workmodel.from_file(args.workmodel)
        if args.workmodel
        else bookinfo_workmodel(replicas=args.replicas)
    )
    steps = load_trace(args.trace) if args.trace else canary_trace(steps=args.steps)
    state = state_from_workmodel(
        wm,
        node_names=[f"worker{i}" for i in range(args.nodes)],
        node_cpu_cap_m=20_000.0,
        seed=args.seed,
        device=args.device,
    )
    _, records = replay(
        state,
        wm.comm_graph(device=args.device),
        steps,
        generator=torch.Generator().manual_seed(args.seed),
        config=GlobalSolverConfig(
            sweeps=args.sweeps,
            balance_weight=args.balance_weight,
            enforce_capacity=args.capacity_frac is not None,
            capacity_frac=args.capacity_frac if args.capacity_frac is not None else 1.0,
        ),
        restarts=args.restarts,
    )
    return {
        "workmodel": wm.source,
        "trace": args.trace or f"builtin:canary[{args.steps}]",
        "balance_weight": args.balance_weight,
        "restarts": args.restarts,
        "steps": [dataclasses.asdict(r) for r in records],
        "total_moves": sum(r.moves for r in records),
        "final_cost": records[-1].cost_after_solve if records else None,
    }


def cmd_solve(args) -> dict:
    _refuse_unported("solve", args)
    backend = make_backend(args.scenario, args.seed, device=args.device,
                           workmodel_path=args.workmodel)
    state = backend.monitor()
    graph = backend.comm_graph()
    cfg = GlobalSolverConfig(
        sweeps=args.sweeps,
        balance_weight=args.balance_weight,
        capacity_frac=args.capacity_frac,
        move_cost=args.move_cost,
    )
    # the solver and the graph it takes as an argument, as the JAX package
    # tunes and runs them
    if args.placement_unit == "pod":
        solve_graph = pod_level_graph(state, graph)

        def solver(st, g, generator, c):
            return global_assign_pods(st, None, generator, c, pod_graph=g)
    elif args.sparse:
        solve_graph, solver = from_comm_graph(graph), global_assign_sparse
    else:
        solve_graph, solver = graph, global_assign
    tune_info = None
    if args.latency_budget is not None:
        cfg, tune_info = tune_sweeps(state, solve_graph, cfg, args.latency_budget, solver=solver)
    new_state, info = solver(state, solve_graph, torch.Generator().manual_seed(args.seed), cfg)
    out = {
        "scenario": args.scenario,
        "restarts": 1,
        "tp": 1,
        "communication_cost_before": float(communication_cost(state, graph)),
        "communication_cost_after": float(communication_cost(new_state, graph)),
        "load_std_before": float(load_std(state)),
        "load_std_after": float(load_std(new_state)),
        "moves_per_sweep": [int(m) for m in info["moves_per_sweep"]],
    }
    if args.move_cost > 0:
        out["move_cost"] = args.move_cost
        out["move_penalty"] = float(info["move_penalty"])
    if args.sparse:
        out["sparse"] = True
    if args.placement_unit != "service":
        out["placement_unit"] = args.placement_unit
    if tune_info is not None:
        out["autotune"] = tune_info
        out["sweeps"] = tune_info["sweeps"]
    return out


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    out = {"reschedule": cmd_reschedule, "solve": cmd_solve,
           "trace": cmd_trace}[args.command](args)
    json.dump(out, sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
