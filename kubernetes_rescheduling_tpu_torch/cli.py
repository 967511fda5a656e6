"""Command line of the port: ``reschedule`` (the control loop on the
simulator) and ``solve`` (one global rescheduling round), printing the JSON
keys of the JAX package's commands for what the port computes.

    python -m kubernetes_rescheduling_tpu_torch reschedule --algorithm car --imbalance
    python -m kubernetes_rescheduling_tpu_torch reschedule --algorithm global --scenario large
    python -m kubernetes_rescheduling_tpu_torch reschedule --algorithm global --global-moves-cap 10
    python -m kubernetes_rescheduling_tpu_torch reschedule --algorithm global --placement-unit pod
    python -m kubernetes_rescheduling_tpu_torch solve --scenario large
    python -m kubernetes_rescheduling_tpu_torch solve --scenario large --sparse
    python -m kubernetes_rescheduling_tpu_torch solve --scenario large --placement-unit pod

Both run on the card unless ``--device cpu`` is given. ``--sparse`` (and
``reschedule --solver-backend sparse``) solves on the block-local sparse
form of the scenario's graph; ``--placement-unit pod`` re-places every pod
on its own, on the pod-level sparse graph.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller
from kubernetes_rescheduling_tpu_torch.bench.harness import SCENARIOS, make_backend
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig
from kubernetes_rescheduling_tpu_torch.objectives import communication_cost, load_std
from kubernetes_rescheduling_tpu_torch.core.sparsegraph import from_comm_graph
from kubernetes_rescheduling_tpu_torch.solver import (
    GlobalSolverConfig,
    global_assign,
    global_assign_pods,
    global_assign_sparse,
)


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
                   help="spread|binpack|random|kubescheduling|communication|car|global")
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
    s.add_argument("--device", default="cuda",
                   help="torch device to solve on (default: cuda)")
    return p


def cmd_reschedule(args) -> dict:
    algo = _norm_algo(args.algorithm)
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
    )
    try:
        cfg.validate()
    except ValueError as e:
        raise SystemExit(f"reschedule: {e}")
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


def cmd_solve(args) -> dict:
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
    generator = torch.Generator().manual_seed(args.seed)
    if args.placement_unit == "pod":
        new_state, info = global_assign_pods(state, graph, generator, cfg)
    elif args.sparse:
        new_state, info = global_assign_sparse(state, from_comm_graph(graph), generator, cfg)
    else:
        new_state, info = global_assign(state, graph, generator, cfg)
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
    return out


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    out = {"reschedule": cmd_reschedule, "solve": cmd_solve}[args.command](args)
    json.dump(out, sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
