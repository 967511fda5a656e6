"""The multichip dry run: every sharded path of the port on a (dp, tp) mesh,
held against its single-device twin — the port of the JAX package's
``__graft_entry__.dryrun_multichip``.

:func:`dryrun_multichip` runs, on tiny shapes:

- ``parallel_restarts`` (dp restarts) and ``sharded_choose_node`` (one
  node-sharded greedy decision);
- the tp dense solve, never worse than its input, and bit-identical to the
  single-device solve of the same plan at ``move_cost`` 0 and 1 (noise off,
  ``balance_weight`` 0: integer arithmetic; a swap phase every sweep);
- the tp sparse solve on an instance of at least two hub blocks
  (``bu=128, reg_tiles=1``), bit-identical to the single-device one;
- ``solve_with_restarts`` dp × tp, and the sparse dp × tp composition
  against dp-only restarts of the same plans;
- the per-pod solve with tp against its single-device twin.

The single-device twins run the plain lowering (``fused_epilogue="off"``),
as the tp solves run plain torch (the JAX package's run plain XLA). A
divergence raises ``AssertionError``; the result is a summary of what ran.

On several ranks: ``torchrun --nproc-per-node N -m
kubernetes_rescheduling_tpu_torch.parallel.dryrun [--device cpu]`` (gloo
on the CPU, NCCL on the card; tp = 2 when N is even); rank 0 prints the
summary as one JSON line. From Python without ``torchrun``:
``parallel.launch.run_group("kubernetes_rescheduling_tpu_torch.parallel.
dryrun.dryrun_multichip", (2, 2), rendezvous=...)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE
from kubernetes_rescheduling_tpu_torch.parallel.mesh import Mesh, make_mesh, world_size


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def dryrun_multichip(mesh: Mesh | None = None, *,
                     device: str | torch.device | None = DEFAULT_DEVICE) -> dict:
    """Run every check of the module docstring on ``mesh`` (shaped from the
    process group when None: tp = 2 on an even world, dp the rest) and
    return ``{"dp", "tp", "checks": [...]}``."""
    from kubernetes_rescheduling_tpu_torch.core import sparsegraph
    from kubernetes_rescheduling_tpu_torch.core.topology import synthetic_scenario
    from kubernetes_rescheduling_tpu_torch.parallel.sharded import (
        parallel_restarts,
        sharded_choose_node,
        solve_with_restarts,
    )
    from kubernetes_rescheduling_tpu_torch.parallel.sharded_solver import (
        _dense_plan,
        sharded_global_assign,
    )
    from kubernetes_rescheduling_tpu_torch.parallel.sharded_sparse import sharded_sparse_assign
    from kubernetes_rescheduling_tpu_torch.policies.hazard import detect_hazard
    from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS
    from kubernetes_rescheduling_tpu_torch.solver.global_solver import (
        GlobalSolverConfig,
        global_assign,
    )
    from kubernetes_rescheduling_tpu_torch.solver.pod_mode import (
        global_assign_pods,
        pod_level_graph,
    )
    from kubernetes_rescheduling_tpu_torch.solver.sparse_solver import (
        draw_sparse_plans,
        global_assign_sparse,
        sparse_layout,
    )

    if mesh is None:
        n = world_size()
        tp = 2 if n % 2 == 0 else 1
        mesh = make_mesh(n, shape=(n // tp, tp), device=device)
    dev = mesh.device
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    checks: list[str] = []

    def gen(seed: int = 0) -> torch.Generator:
        return torch.Generator().manual_seed(seed)

    scn = synthetic_scenario(n_pods=4 * tp * dp, n_nodes=2 * tp, seed=0, device=dev)
    S, N = scn.graph.num_services, scn.state.num_nodes

    # dp: best-of-dp restarts, one a rank
    best, _info = parallel_restarts(scn.state, scn.graph, gen(), mesh, n_restarts=dp,
                                    config=GlobalSolverConfig(sweeps=2))
    _check(best.pod_node.shape == scn.state.pod_node.shape, "parallel_restarts: shape")
    checks.append("parallel_restarts")

    # tp: one node-sharded greedy decision, every node a candidate
    _, hazard = detect_hazard(scn.state, threshold=0.0)
    choice = sharded_choose_node(POLICY_IDS["communication"], scn.state, scn.graph,
                                 torch.tensor(0, device=dev), hazard & False, None, mesh)
    _check(int(choice) >= 0, f"sharded_choose_node: {int(choice)}")
    checks.append("sharded_choose_node")

    st_sh, info_sh = sharded_global_assign(scn.state, scn.graph, gen(), mesh,
                                           GlobalSolverConfig(sweeps=2))
    _check(float(info_sh["objective_after"]) <= float(info_sh["objective_before"]) + 1e-3,
           "sharded_global_assign: the objective rose")
    checks.append("sharded_global_assign")

    # from here every sharded path against its single-device twin, the
    # same plan on both sides, bit for bit
    exact = dict(sweeps=3, noise_temp=0.0, balance_weight=0.0, swap_every=1,
                 fused_epilogue="off")
    for mc in (0.0, 1.0):
        cfg0 = GlobalSolverConfig(move_cost=mc, **exact)
        plan = _dense_plan(gen(), cfg0, S, N, tp)
        one, _ = global_assign(scn.state, scn.graph, None, cfg0, plan=plan)
        sh, _ = sharded_global_assign(scn.state, scn.graph, None, mesh, cfg0, plan=plan)
        _check(torch.equal(one.pod_node, sh.pod_node),
               f"tp-sharded dense solve diverged from its single-device twin (move_cost={mc})")
        checks.append(f"tp_dense_move_cost_{mc:g}")

    # tp sparse, sized for at least two genuine hub blocks
    scn_sp = synthetic_scenario(n_pods=1024, n_nodes=2 * tp, powerlaw=True, seed=1,
                                node_cpu_cap_m=60_000.0, device=dev)
    adj = scn_sp.graph.adj.cpu().numpy()
    iu, ju = np.nonzero(np.triu(adj, k=1))
    sg = sparsegraph.from_edges(iu, ju, adj[iu, ju], adj.shape[0], names=scn_sp.graph.names,
                                bu=128, reg_tiles=1, device=dev)
    _check(sg.num_blocks > 1 and len(sg.hub_blocks) >= 2,
           f"the dry run's sparse instance needs >= 2 hub blocks, got {sg.hub_blocks}")
    cfg_sp = GlobalSolverConfig(**exact)
    lay = sparse_layout(sg, cfg_sp)
    plan = draw_sparse_plans(gen(), cfg_sp.sweeps, lay)
    one, _ = global_assign_sparse(scn_sp.state, sg, None, cfg_sp, plan=plan)
    sh, _ = sharded_sparse_assign(scn_sp.state, sg, None, mesh, cfg_sp, plan=plan)
    _check(torch.equal(one.pod_node, sh.pod_node),
           "tp-sharded sparse solve diverged from its single-device twin")
    checks.append("tp_sparse")

    # dp × tp through the production entry
    st_c, info_c = solve_with_restarts(scn.state, scn.graph, gen(), n_restarts=dp,
                                       config=GlobalSolverConfig(sweeps=2), mesh=mesh)
    _check(int(info_c["restarts"]) == dp, f"solve_with_restarts: {int(info_c['restarts'])}")
    if "restart_objectives" in info_c:
        _check(tuple(info_c["restart_objectives"].shape) == (dp,),
               "solve_with_restarts: restart_objectives shape")
    if "objective_before" in info_c:
        _check(float(info_c["objective_after"]) <= float(info_c["objective_before"]) + 1e-3,
               "solve_with_restarts: the objective rose")
    checks.append("solve_with_restarts_dp_x_tp")

    if dp > 1 and tp > 1:
        # sparse dp × tp against dp-only restarts of the same plans
        plans = [draw_sparse_plans(gen(s), cfg_sp.sweeps, lay) for s in range(dp)]
        d_mesh = dataclasses.replace(mesh, axis_names=("dp", "tp"),
                                     shape={"dp": dp, "tp": 1}, coords={**mesh.coords, "tp": 0},
                                     groups={**mesh.groups, "tp": None},
                                     group_ranks={**mesh.group_ranks,
                                                  "tp": (mesh.rank,)})
        st_dp, _ = solve_with_restarts(scn_sp.state, None, None, n_restarts=dp, config=cfg_sp,
                                       sparse_graph=sg, plans=plans, mesh=d_mesh)
        st_ct, _ = solve_with_restarts(scn_sp.state, None, None, n_restarts=dp, config=cfg_sp,
                                       sparse_graph=sg, plans=plans, mesh=mesh)
        _check(torch.equal(st_dp.pod_node, st_ct.pod_node),
               "sparse dp×tp composition diverged from dp-only restarts")
        checks.append("sparse_dp_x_tp")

    # per-pod placement on the mesh
    pg = pod_level_graph(scn_sp.state, scn_sp.graph)
    plan = draw_sparse_plans(gen(), cfg_sp.sweeps, sparse_layout(pg, cfg_sp))
    one, _ = global_assign_pods(scn_sp.state, None, None, cfg_sp, pod_graph=pg, plan=plan)
    sh, _ = global_assign_pods(scn_sp.state, None, None, cfg_sp, pod_graph=pg, plan=plan,
                               mesh=mesh)
    _check(torch.equal(one.pod_node, sh.pod_node),
           "tp-sharded pod-mode solve diverged from its single-device twin")
    checks.append("tp_pod_mode")
    return {"dp": dp, "tp": tp, "checks": checks}


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json
    import os

    import torch.distributed as dist

    from kubernetes_rescheduling_tpu_torch.parallel.mesh import collective_backend, rank_device

    p = argparse.ArgumentParser(prog="python -m kubernetes_rescheduling_tpu_torch.parallel.dryrun")
    p.add_argument("--device", default=DEFAULT_DEVICE)
    args = p.parse_args(argv)
    dev = rank_device(args.device)
    joined = int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized()
    if joined:
        dist.init_process_group(collective_backend(dev))
    try:
        out = dryrun_multichip(device=dev)
    finally:
        if joined:
            dist.destroy_process_group()
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
