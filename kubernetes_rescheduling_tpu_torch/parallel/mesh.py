"""Device meshes over ``torch.distributed`` — the port of
``kubernetes_rescheduling_tpu.parallel.mesh``.

The JAX package runs one program over a ``jax.sharding.Mesh`` of devices.
Here every device is one process (a rank of the default process group,
``torchrun`` style) that runs the same program, and a :class:`Mesh` is
this rank's view of the grid: the shape by axis name, its own
coordinates, the process group of each axis it belongs to, and its own
device. The collectives the sharded solvers need (:func:`gather`,
:func:`psum`, :func:`pmax`, :func:`broadcast`) go over those groups.

Sums over an axis gather every rank's part and add them in rank order,
never through an unordered reduction, so a run repeats bit for bit.

With no process group initialised the world is this one process: the
default mesh is 1 × 1, its groups are None, and every collective is the
identity. With one, every axis has a group (of one rank too), so the
collectives run even on one device. NCCL serves CUDA tensors and gloo CPU
tensors; the backend follows the device the caller names, and a process
group that lacks it is refused.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a device grid.

    ``shape``: extent by axis name, in axis order; ``coords``: this rank's
    index on each axis; ``groups``: the process group of this rank's line
    along each axis (None without a process group); ``group_ranks``: the
    global ranks of that line, in axis order; ``rank``: this rank's global
    rank; ``device``: its device."""

    axis_names: tuple[str, ...]
    shape: dict[str, int]
    coords: dict[str, int]
    groups: dict[str, object]
    group_ranks: dict[str, tuple[int, ...]]
    rank: int
    device: torch.device


def world_size() -> int:
    """Devices the program can put on a mesh: the default process group's
    ranks, or 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device: str | torch.device | None = DEFAULT_DEVICE) -> torch.device:
    """This rank's device of the kind ``device`` names: ``cuda:LOCAL_RANK``
    for CUDA (a single process is ``cuda:0``), the CPU for the CPU. A card
    asked for where none is raises."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def collective_backend(device: torch.device) -> str:
    """The backend whose collectives take tensors on ``device``."""
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(
    n_devices: int | None = None,
    axis_names: tuple[str, ...] = ("dp", "tp"),
    shape: tuple[int, ...] | None = None,
    *,
    device: str | torch.device | None = DEFAULT_DEVICE,
) -> Mesh:
    """A mesh over the first ``n_devices`` ranks of the default process
    group (all of them by default).

    The default shape puts everything on ``dp`` (restart parallelism) with
    ``tp`` (node-axis sharding) of 1; pass ``shape`` for another split.
    Without a process group this is a 1 × 1 mesh of this process, so the
    same call runs anywhere. ``device`` names the kind of device this rank
    computes on; a ``cuda`` mesh needs an NCCL process group, a CPU mesh a
    gloo one.

    Every rank of the world must call this in the same order
    (``new_group`` is collective over the world); a rank outside the first
    ``n_devices`` raises after the groups are made."""
    world = world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} available")
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name the axes {axis_names}")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev = rank_device(device)
    backend = collective_backend(dev)
    grouped = dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    if grouped and backend not in dist.get_backend():
        raise ValueError(f"a mesh on {dev.type} needs a {backend} process group; the default "
                         f"one is {dist.get_backend()}")
    if grouped and dev.type == "cuda":
        torch.cuda.set_device(dev)  # NCCL runs on the current device
    grid = torch.arange(n).reshape(shape)
    groups: dict[str, object] = {}
    group_ranks: dict[str, tuple[int, ...]] = {}
    for a, name in enumerate(axis_names):
        # every line of the grid along this axis is one group, made on
        # every rank in the same order
        for line in grid.movedim(a, -1).reshape(-1, shape[a]).tolist():
            g = dist.new_group(line, backend=backend) if grouped else None
            if rank in line:
                groups[name], group_ranks[name] = g, tuple(line)
    if rank >= n:
        raise ValueError(f"rank {rank} lies outside a mesh of {n} devices")
    where = (grid == rank).nonzero()[0].tolist()
    return Mesh(
        axis_names=tuple(axis_names),
        shape=dict(zip(axis_names, shape)),
        coords=dict(zip(axis_names, where)),
        groups=groups,
        group_ranks=group_ranks,
        rank=rank,
        device=dev,
    )


def gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, stacked in axis order:
    ``[mesh.shape[axis], *x.shape]`` (the counterpart of
    ``lax.all_gather``)."""
    g = mesh.groups[axis]
    if g is None:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x.contiguous(), group=g)
    return torch.stack(parts)


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, added in rank order (the
    counterpart of ``lax.psum``; the same value on every rank)."""
    if mesh.groups[axis] is None:
        return x
    parts = gather(x, mesh, axis)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def pmax(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``axis``."""
    if mesh.groups[axis] is None:
        return x
    return gather(x, mesh, axis).amax(dim=0)


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str, src: int) -> torch.Tensor:
    """``x`` of the rank at index ``src`` along ``axis``, on every rank of
    the line."""
    g = mesh.groups[axis]
    if g is None:
        return x
    out = x.contiguous().clone()
    dist.broadcast(out, src=mesh.group_ranks[axis][src], group=g)
    return out
