"""Best-of-N restarts and the node-sharded policy decision — the port of
``kubernetes_rescheduling_tpu.parallel.sharded``.

Two parallel axes, mapped to the domain as in the JAX package:

- **dp (restarts)**: local search is embarrassingly parallel across random
  restarts. :func:`parallel_restarts` runs R independent solves, R/dp on
  each dp rank, and selects the best ranked value on the device.
- **tp (nodes)**: the per-(service, node) scores shard along the node
  axis. :func:`sharded_choose_node` takes each shard's lexicographic
  winner and combines them after a gather; the node-sharded global solves
  are ``sharded_solver.py`` and ``sharded_sparse.py``.

On one device the restarts run one after another, as the JAX package runs
them inside a shard (batching them would multiply a working set of 400 MB
at 10k services). Each restart is one solve of the solo solver, so on the
card one replay of the graph captured for the solo solve, with that
restart's plans written into its inputs; nothing is read back to the host
between restarts, and the winner is picked by ``argmin`` on the device
(the first minimum on ties, as ``jnp.argmin``).
"""

from __future__ import annotations

import torch

from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.parallel.mesh import (
    Mesh,
    broadcast,
    gather,
    make_mesh,
    world_size,
)
from kubernetes_rescheduling_tpu_torch.policies.scoring import node_features, policy_key_table
from kubernetes_rescheduling_tpu_torch.solver.global_solver import (
    GlobalSolverConfig,
    global_assign,
)


def restart_generators(generator: torch.Generator, n: int) -> list[torch.Generator]:
    """``n`` independent CPU generators, each seeded by one draw of
    ``generator`` (the counterpart of ``jax.random.split(key, n)``):
    restart ``i`` draws the same plans whatever the mesh."""
    if generator is None:
        raise ValueError("restarts need a generator or explicit plans")
    seeds = torch.randint(0, 2**62, (n,), generator=generator).tolist()
    return [torch.Generator().manual_seed(s) for s in seeds]


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d device index, without reading it back."""
    return x.index_select(0, i.reshape(1))[0]


def parallel_restarts(
    state: ClusterState,
    graph,
    generator: torch.Generator | None,
    mesh: Mesh,
    *,
    n_restarts: int | None = None,
    config: GlobalSolverConfig = GlobalSolverConfig(),
    solver=global_assign,
    solver_tag: str = "dense",
    plans: list | None = None,
) -> tuple[ClusterState, dict[str, torch.Tensor]]:
    """Run ``n_restarts`` independent solves, ``n_restarts / dp`` on each
    rank of the mesh's ``dp`` axis, and return the best one.

    Restart ``i`` solves with the ``i``-th of :func:`restart_generators`
    (``generator``), or with ``plans[i]`` (one plan list per restart, the
    seam the tests feed from the JAX package's key stream). Selection ranks
    the gated, penalized value ``objective_after + move_penalty`` of each
    restart, so a cheap but disruptive restart cannot mask a better one.
    With dp > 1 the ranked values are gathered, and the winner's placement
    is broadcast from its rank (one host read of the winner's index).
    ``solver_tag`` names the solve in errors only: the capture cache keys
    the solver's own graph."""
    dp = mesh.shape["dp"]
    r = n_restarts or dp
    if r % dp:
        raise ValueError(f"n_restarts {r} must be a multiple of dp={dp}")
    if plans is not None and len(plans) != r:
        raise ValueError(f"{solver_tag}: {len(plans)} restart plans for {r} restarts")
    gens = restart_generators(generator, r) if plans is None else [None] * r
    r_local = r // dp
    d = mesh.coords["dp"]
    # each restart's placement lands in one buffer as it finishes: the
    # call holds R placements and one solve's outputs at a time
    pods = torch.empty((r_local, state.num_pods), dtype=state.pod_node.dtype,
                       device=state.device)
    objs, pens = [], []
    for j, i in enumerate(range(d * r_local, (d + 1) * r_local)):
        new_state, info = solver(state, graph, gens[i], config,
                                 plan=plans[i] if plans is not None else None)
        pods[j] = new_state.pod_node
        objs.append(info["objective_after"])
        pens.append(info["move_penalty"])
        del new_state, info
    objs, pens = torch.stack(objs), torch.stack(pens)
    all_objs = gather(objs, mesh, "dp").reshape(-1)
    all_pens = gather(pens, mesh, "dp").reshape(-1)
    ranked = all_objs + all_pens
    best = torch.argmin(ranked)
    if dp == 1:
        pod_node = _pick(pods, best)
    else:
        owner, local = divmod(int(best), r_local)
        pod_node = broadcast(pods[local] if owner == d else torch.empty_like(pods[0]),
                             mesh, "dp", owner)
    info = {
        "objective_after": _pick(all_objs, best),
        "move_penalty": _pick(all_pens, best),
        # the RANKED values: the named best restart is the adopted one
        "restart_objectives": ranked,
        "best_restart": best,
    }
    return state.replace(pod_node=pod_node), info


def _largest_divisor(r: int, cap: int) -> int:
    """Largest divisor of ``r`` that is <= ``cap`` — the dp extent of an
    auto-shaped mesh."""
    return max(d for d in range(1, min(cap, r) + 1) if r % d == 0)


def dp_devices(mesh: Mesh) -> tuple[int, ...]:
    """The global ranks along the mesh's ``dp`` axis at this rank's ``tp``
    index, in dp order: block ``i`` of a dp-split output is computed by
    rank ``dp_devices(mesh)[i]``."""
    return mesh.group_ranks["dp"]


def solve_with_restarts(
    state: ClusterState,
    graph: CommGraph | None,
    generator: torch.Generator | None,
    *,
    n_restarts: int = 1,
    config: GlobalSolverConfig = GlobalSolverConfig(),
    mesh: Mesh | None = None,
    tp: int = 1,
    sparse_graph=None,
    donate: bool = False,
    plans: list | None = None,
) -> tuple[ClusterState, dict[str, torch.Tensor]]:
    """The production best-of-N global solve, over the whole dp × tp ×
    dense/sparse matrix of the JAX package.

    ``sparse_graph`` (a ``SparseCommGraph``) switches every solve to the
    block-local form. ``tp > 1`` shards the node axis of every solve over
    the mesh's ``tp`` ranks (``sharded_solver`` / ``sharded_sparse``): one
    node-sharded solve with ``n_restarts <= 1``, otherwise dp restarts of
    tp-sharded solves. With ``tp == 1``: ``n_restarts <= 1`` is the solo
    solve, otherwise :func:`parallel_restarts` over the ``dp`` ranks, in
    sequence on each.

    With no mesh, one is shaped from the default process group (the
    world): ``tp`` ranks a solve and as dp the largest divisor of
    ``n_restarts`` that fits the rest. Without a process group that is a
    1 × 1 mesh running the N solves back to back (N× the time, one solve's
    memory). ``plans``: one plan list per restart (a list of one for a
    single solve). ``info["restarts"]`` is N;
    ``info["tp"]`` is there when the node axis was sharded.

    ``donate`` is accepted for the JAX package's signature and does
    nothing: torch has no buffer donation, and the solo solve writes its
    output apart from its input anyway."""
    del donate
    dev = state.device
    if mesh is not None:
        mesh_tp = mesh.shape.get("tp", 1)
        if tp != 1 and mesh_tp != tp:
            raise ValueError(f"tp={tp} conflicts with the explicit mesh's tp={mesh_tp}; "
                             "pass one or the other")
        tp = mesh_tp
    if tp > 1:
        from kubernetes_rescheduling_tpu_torch.parallel.sharded_solver import (
            sharded_global_assign,
            sharded_solve_with_restarts,
        )
        from kubernetes_rescheduling_tpu_torch.parallel.sharded_sparse import (
            sharded_sparse_assign,
            sharded_sparse_solve_with_restarts,
        )

        if mesh is None:
            n_dev = world_size()
            if n_dev % tp:
                raise ValueError(f"tp={tp} does not divide the {n_dev} available devices")
            dp = _largest_divisor(max(n_restarts, 1), max(n_dev // tp, 1))
            mesh = make_mesh(dp * tp, shape=(dp, tp), device=dev)
        if sparse_graph is not None:
            if n_restarts > 1:
                new_state, info = sharded_sparse_solve_with_restarts(
                    state, sparse_graph, generator, mesh, n_restarts=n_restarts,
                    config=config, plans=plans)
            else:
                new_state, info = sharded_sparse_assign(
                    state, sparse_graph, generator, mesh, config,
                    plan=plans[0] if plans else None)
        elif n_restarts <= 1:
            new_state, info = sharded_global_assign(state, graph, generator, mesh, config,
                                                    plan=plans[0] if plans else None)
        else:
            new_state, info = sharded_solve_with_restarts(
                state, graph, generator, mesh, n_restarts=n_restarts, config=config,
                plans=plans)
        return new_state, dict(info, restarts=torch.tensor(max(n_restarts, 1)))
    if sparse_graph is not None:
        from kubernetes_rescheduling_tpu_torch.solver.sparse_solver import global_assign_sparse

        solver, solve_graph, tag = global_assign_sparse, sparse_graph, "sparse"
    else:
        solver, solve_graph, tag = global_assign, graph, "dense"
    if n_restarts <= 1:
        new_state, info = solver(state, solve_graph, generator, config,
                                 plan=plans[0] if plans else None)
        return new_state, dict(info, restarts=torch.tensor(1))
    if mesh is None:
        dp = _largest_divisor(n_restarts, world_size())
        mesh = make_mesh(dp, shape=(dp, 1), device=dev)
    best_state, info = parallel_restarts(
        state, solve_graph, generator, mesh, n_restarts=n_restarts, config=config,
        solver=solver, solver_tag=tag, plans=plans,
    )
    return best_state, dict(info, restarts=torch.tensor(n_restarts))


def sharded_choose_node(
    policy_id: int,
    state: ClusterState,
    graph: CommGraph,
    service_idx: torch.Tensor,
    hazard_mask: torch.Tensor,
    gumbel: torch.Tensor | None,
    mesh: Mesh,
) -> torch.Tensor:
    """``policies.choose_node`` with the node axis sharded over ``tp``.

    Each shard takes the lexicographic winner of its own node columns; one
    (keys, global index) tuple a shard is gathered, and the winner among
    them is the lexicographic maximum, the lowest global index on ties
    (first-max parity). ``gumbel`` is the ``random`` policy's noise row
    (the JAX package draws it from its key). Returns the node index, -1
    when no node is a candidate."""
    tp = mesh.shape["tp"]
    n = state.num_nodes
    if n % tp:
        raise ValueError(f"num_nodes {n} must be a multiple of tp={tp}")
    f = node_features(state, graph, service_idx)
    keys = torch.stack(_policy_keys(policy_id, f, state, gumbel))  # [K, N]
    cand = state.node_valid & ~hazard_mask
    nl = n // tp
    col0 = mesh.coords["tp"] * nl
    keys_l, winners = keys[:, col0:col0 + nl], cand[col0:col0 + nl]
    for k in keys_l:
        best = torch.where(winners, k, float("-inf")).max()
        winners = winners & (k == best)
    local = torch.argmax(winners.to(torch.int32))
    local_keys = torch.where(winners.any(), keys_l[:, local], float("-inf"))
    all_keys = gather(local_keys, mesh, "tp")                               # [tp, K]
    all_idx = gather(col0 + local.to(torch.int64), mesh, "tp")              # [tp]
    winners2 = torch.ones((tp,), dtype=torch.bool, device=keys.device)
    for i in range(all_keys.shape[1]):
        k = all_keys[:, i]
        best = torch.where(winners2, k, float("-inf")).max()
        winners2 = winners2 & (k == best)
    chosen = torch.where(winners2, all_idx, torch.iinfo(torch.int64).max).min()
    return torch.where((all_keys[:, 0] > float("-inf")).any(), chosen, -1).to(torch.int32)


def _policy_keys(policy_id, f, state, gumbel):
    """The active policy's key rows from the ONE table
    (``policies.scoring.policy_key_table``) the single-device decision
    uses."""
    k1, k2 = policy_key_table(f, state, gumbel)
    pid = min(max(int(policy_id), 0), k1.shape[0] - 1)
    return [k1[pid], k2[pid]]
