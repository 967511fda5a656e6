"""Command line of the port: the ``solve`` subcommand — one global
rescheduling round on a synthetic scenario, printing the same JSON keys as
the JAX package's ``solve``.

    python -m kubernetes_rescheduling_tpu_torch solve --scenario large
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from kubernetes_rescheduling_tpu_torch.bench.harness import SCENARIOS, make_backend
from kubernetes_rescheduling_tpu_torch.objectives import communication_cost, load_std
from kubernetes_rescheduling_tpu_torch.solver import GlobalSolverConfig, global_assign


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
    new_state, info = global_assign(
        state, graph, torch.Generator().manual_seed(args.seed), cfg
    )
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
    return out


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    out = {"solve": cmd_solve}[args.command](args)
    json.dump(out, sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
