"""Command line of the port: the ``solve`` subcommand — one global
rescheduling round on a synthetic scenario, printing the same JSON keys as
the JAX package's ``solve``.

    python -m kubernetes_rescheduling_tpu_torch solve --scenario large
    python -m kubernetes_rescheduling_tpu_torch solve --scenario large --sparse
    python -m kubernetes_rescheduling_tpu_torch solve --scenario large --placement-unit pod

``--sparse`` solves on the block-local sparse form of the scenario's graph;
``--placement-unit pod`` re-places every pod on its own, on the pod-level
sparse graph.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from kubernetes_rescheduling_tpu_torch.bench.harness import SCENARIOS, make_backend
from kubernetes_rescheduling_tpu_torch.objectives import communication_cost, load_std
from kubernetes_rescheduling_tpu_torch.core.sparsegraph import from_comm_graph
from kubernetes_rescheduling_tpu_torch.solver import (
    GlobalSolverConfig,
    global_assign,
    global_assign_pods,
    global_assign_sparse,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kubernetes_rescheduling_tpu_torch",
        description="Communication-aware Kubernetes rescheduling on PyTorch/CUDA",
    )
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("solve", help="one-shot global solve")
    s.add_argument("--scenario", default="large", choices=SCENARIOS)
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


def cmd_solve(args) -> dict:
    backend = make_backend(args.scenario, args.seed, device=args.device)
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
    out = {"solve": cmd_solve}[args.command](args)
    json.dump(out, sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
