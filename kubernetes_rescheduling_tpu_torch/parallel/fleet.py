"""Fleet mode, dp plane: one block of tenants a device — the port of
``kubernetes_rescheduling_tpu.parallel.fleet``.

The vmap plane (``solver.fleet`` / ``solver.fleet_global``) runs every
tenant's solo body in one captured program on one device. On a mesh the
tenant axis shards over ``dp`` instead: rank ``d`` runs the vmap plane's own
function on its contiguous block of T/dp tenants (their states, graphs,
mask, noise rows, forecast deltas, generators and plans), and ONE
``gather(..., mesh, "dp")`` in rank order hands every rank the whole
fleet's outputs — a device collective, no host read. Three planes:

- :func:`fleet_solve_dp` — the greedy decision (``solver.fleet.fleet_solve``);
- :func:`fleet_solve_proactive_dp` — the proactive decision
  (``fleet_solve_proactive``; the forecast state stays one program on each
  rank, its deltas shard here with the states);
- :func:`fleet_global_solve_dp` — the dense global solve, fleet restarts
  included (``solver.fleet_global.fleet_global_solve``). Its bundle is the
  JAX package's dp layout: each rank's flat bundle over its block, back to
  back, which :func:`decode_fleet_global_dp` re-splits.

Each rank runs the solo per-tenant bodies, so unlike the JAX package's
differently partitioned executables (its module docstring) the dp plane
equals the vmap plane bit for bit, the balance term included.

The mesh (:func:`_fleet_mesh`, the one divisibility rule): the tenant count
must be a multiple of the mesh's dp extent. Shaped from the default process
group when none is given: dp is the largest divisor of the tenant count
that divides the world, and the other axis holds the rest of the world
(ranks that share a dp index compute the same block). Without a process
group that is dp = 1, and a call is the vmap plane's call itself, with the
same capture. ``with_hbm=True`` appends this rank's allocated card memory
(MB, ``telemetry.mesh.rank_hbm_mb``) to the gathered block, and the call
also returns the per-rank vector: the mesh plane's HBM column rides the
gather the plane already makes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch.parallel.mesh import Mesh, gather, make_mesh, world_size


def _fleet_mesh(t: int, mesh: Mesh | None, *,
                device: str | torch.device | None = DEFAULT_DEVICE) -> Mesh:
    """The fleet's dp mesh (auto-shaped when ``mesh`` is None, see the
    module docstring), checked against the tenant count ``t`` — the one
    divisibility rule of the three dp planes. Shaping one makes process
    groups on every rank of the world: a caller that decides every round
    shapes it once and passes it (the fleet loop does)."""
    if mesh is None:
        world = world_size()
        dp = max(d for d in range(1, min(t, world) + 1) if t % d == 0 and world % d == 0)
        mesh = make_mesh(world, shape=(dp, world // dp), device=resolve_device(device))
    dp = mesh.shape["dp"]
    if t % dp:
        raise ValueError(f"tenant count {t} must be a multiple of dp={dp}")
    return mesh


def dp_device_names(mesh: Mesh | None = None, *, tenants: int | None = None,
                    device: str | torch.device | None = DEFAULT_DEVICE) -> tuple[str, ...]:
    """Device names along the fleet's dp axis, in dp order — the labels of
    the mesh plane's per-device readings: ``"<type>:<global rank>"`` (on one
    host rank r's card is ``cuda:r``, the costmodel's label). Resolves the
    mesh as the dp planes do, so name ``i`` runs tenant block ``i``."""
    if mesh is None:
        if tenants is None:
            raise ValueError("need a mesh or a tenant count to shape one")
        mesh = _fleet_mesh(int(tenants), None, device=device)
    return tuple(f"{mesh.device.type}:{r}" for r in mesh.group_ranks["dp"])


def _block(mesh: Mesh, t: int) -> slice:
    per = t // mesh.shape["dp"]
    d = mesh.coords["dp"]
    return slice(d * per, (d + 1) * per)


def _stacked_block(states, sl: slice):
    """Tenants ``sl`` of a stacked state."""
    return dataclasses.replace(states, **{
        f.name: getattr(states, f.name)[sl] for f in dataclasses.fields(states)
        if isinstance(getattr(states, f.name), torch.Tensor)})


def _hbm_cell(dev: torch.device) -> torch.Tensor:
    from kubernetes_rescheduling_tpu_torch.solver.compiled import to_device
    from kubernetes_rescheduling_tpu_torch.telemetry.mesh import rank_hbm_mb

    return to_device(torch.tensor([rank_hbm_mb(dev)], dtype=torch.float32), dev)


def _gather_block(parts: list[torch.Tensor], mesh: Mesh, with_hbm: bool
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """ONE gather over dp of this rank's block outputs, flattened to f32
    (and its HBM cell): ``([dp, L], hbm f32[dp] or None)``."""
    dev = parts[0].device
    flat = [p.reshape(-1).float() for p in parts]
    if with_hbm:
        flat.append(_hbm_cell(dev))
    rows = gather(torch.cat(flat), mesh, "dp")
    if with_hbm:
        return rows[:, :-1], rows[:, -1]
    return rows, None


def _decide_dp(states, graphs: Sequence, policy_id, threshold, tenant_mask, gumbel, deltas,
               mesh, with_hbm):
    from kubernetes_rescheduling_tpu_torch.solver.fleet import fleet_solve

    T = int(tenant_mask.shape[0])
    mesh = _fleet_mesh(T, mesh, device=states.device)
    sl = _block(mesh, T)
    kw = dict(deltas=deltas[sl] if deltas is not None else None,
              fn="fleet_solve_proactive" if deltas is not None else "fleet_solve")
    if mesh.groups["dp"] is None:
        dec, hz = fleet_solve(states, graphs, policy_id, threshold, tenant_mask, gumbel, **kw)
        return (dec, hz, _hbm_cell(dec.device)) if with_hbm else (dec, hz)
    dec, hz = fleet_solve(_stacked_block(states, sl), list(graphs)[sl], policy_id, threshold,
                          tenant_mask[sl], gumbel[sl] if gumbel is not None else None, **kw)
    per, n = dec.shape[0], hz.shape[1]
    rows, hbm = _gather_block([dec, hz], mesh, with_hbm)
    decisions = rows[:, :per * 4].reshape(T, 4).to(torch.int32)
    hazard = rows[:, per * 4:].reshape(T, n) > 0.5
    return (decisions, hazard, hbm) if with_hbm else (decisions, hazard)


def fleet_solve_dp(states, graphs: Sequence, policy_id: int, threshold: float,
                   tenant_mask: torch.Tensor, gumbel: torch.Tensor | None = None, *,
                   mesh: Mesh | None = None, with_hbm: bool = False):
    """:func:`solver.fleet.fleet_solve` with the tenant axis sharded over
    the mesh's ``dp`` ranks: ``(decisions i32[T, 4], hazard bool[T, N])``
    on every rank (and the per-rank HBM MB with ``with_hbm``). ``states``
    is stacked, ``graphs`` one graph a tenant, ``gumbel`` the ``random``
    policy's rows [T, N]; the tenant count must be a multiple of dp."""
    return _decide_dp(states, graphs, policy_id, threshold, tenant_mask, gumbel, None, mesh,
                      with_hbm)


def fleet_solve_proactive_dp(states, graphs: Sequence, policy_id: int, threshold: float,
                             tenant_mask: torch.Tensor, deltas: torch.Tensor,
                             gumbel: torch.Tensor | None = None, *, mesh: Mesh | None = None,
                             with_hbm: bool = False):
    """:func:`solver.fleet.fleet_solve_proactive` sharded as
    :func:`fleet_solve_dp`, the forecast ``deltas`` [T, N] with the
    states."""
    return _decide_dp(states, graphs, policy_id, threshold, tenant_mask, gumbel, deltas, mesh,
                      with_hbm)


def fleet_global_solve_dp(states, graphs: Sequence, tenant_mask: torch.Tensor, *, config,
                          generators: Sequence | None = None, plans: Sequence | None = None,
                          n_restarts: int = 1, mesh: Mesh | None = None,
                          with_hbm: bool = False):
    """:func:`solver.fleet_global.fleet_global_solve` with the tenant axis
    sharded over ``dp``: each rank solves its block (restarts included) and
    the blocks' flat bundles are gathered back to back — decode with
    :func:`decode_fleet_global_dp` (with dp = 1 that is the vmap layout).
    With ``with_hbm`` returns ``(flat, hbm f32[dp])``."""
    from kubernetes_rescheduling_tpu_torch.solver.fleet import tenant_states
    from kubernetes_rescheduling_tpu_torch.solver.fleet_global import fleet_global_solve

    T = int(tenant_mask.shape[0])
    sts = tenant_states(states, T)
    mesh = _fleet_mesh(T, mesh, device=sts[0].device)
    kw = dict(config=config, n_restarts=n_restarts)
    if mesh.groups["dp"] is None:
        flat = fleet_global_solve(sts, graphs, tenant_mask, generators=generators, plans=plans,
                                  **kw)
        return (flat, _hbm_cell(flat.device)) if with_hbm else flat
    sl = _block(mesh, T)
    flat = fleet_global_solve(sts[sl], list(graphs)[sl], tenant_mask[sl],
                              generators=list(generators)[sl] if generators is not None else None,
                              plans=list(plans)[sl] if plans is not None else None, **kw)
    rows, hbm = _gather_block([flat], mesh, with_hbm)
    return (rows.reshape(-1), hbm) if with_hbm else rows.reshape(-1)


def decode_fleet_global_dp(flat, *, tenants: int, num_services: int, dp: int):
    """Decode the dp plane's bundle: each rank's block bundle (the vmap
    layout over its T/dp tenants), back to back — re-split and merge the
    per-tenant move lists and objective rows in tenant order."""
    from kubernetes_rescheduling_tpu_torch.solver.fleet_global import decode_fleet_global

    flat = np.asarray(flat)
    if tenants % dp:
        raise ValueError(f"tenants {tenants} not divisible by dp={dp}")
    per = tenants // dp
    block = flat.reshape(dp, -1)
    moves, objs = [], []
    for d in range(dp):
        m, o = decode_fleet_global(block[d], tenants=per, num_services=num_services)
        moves.extend(m)
        objs.extend(o)
    return moves, objs
