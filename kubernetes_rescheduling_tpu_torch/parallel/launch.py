"""A process group of several ranks on one host, started from Python — the
way to run the mesh code without ``torchrun`` (on the CPU, one gloo rank a
process).

:func:`run_group` starts ``world`` processes with the ``spawn`` method.
Each sets one torch thread, joins a gloo group that meets through a
rendezvous file (no TCP port to collide with another group), builds its
CPU mesh of ``shape`` and calls a function of this package by its dotted
name with ``mesh=`` that mesh (or, with ``pass_mesh=False``, without one:
an entry point that shapes its own mesh from the world). It returns every
rank's result, in rank order. A group that does not finish within ``timeout_s`` is killed and
raises ``TimeoutError``; a rank that raises makes the whole call raise.

The spawned processes import torch and this package only: the function
and its arguments (tensors, the package's dataclasses) travel as plain
pickled bytes (not through shared memory, which a container may cap).
"""

from __future__ import annotations

import datetime
import importlib
import math
import multiprocessing as mp
import os
import pickle
import queue
import time
import traceback

PACKAGE = "kubernetes_rescheduling_tpu_torch"


def _resolve(fn: str):
    if not fn.startswith(PACKAGE + "."):
        raise ValueError(f"run_group calls functions of {PACKAGE} only, not {fn!r}")
    module, name = fn.rsplit(".", 1)
    return getattr(importlib.import_module(module), name)


def _rank_main(rank, world, rendezvous, timeout_s, call, results):
    try:
        fn, shape, args, kwargs, pass_mesh = pickle.loads(call)
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            from kubernetes_rescheduling_tpu_torch.parallel.mesh import make_mesh

            if pass_mesh:
                kwargs = dict(kwargs, mesh=make_mesh(math.prod(shape), shape=shape,
                                                     device="cpu"))
            out = _resolve(fn)(*args, **kwargs)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", pickle.dumps(out)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, "error", traceback.format_exc()))


def run_group(fn: str, shape: tuple[int, ...], args=(), kwargs=None, *, rendezvous: str,
              timeout_s: float = 120.0, pass_mesh: bool = True) -> list:
    """``fn(*args, mesh=mesh, **kwargs)`` on every rank of a CPU mesh of
    ``shape`` (``math.prod(shape)`` processes; ``pass_mesh=False`` leaves
    ``mesh`` out); returns the ranks' results in rank order. ``rendezvous`` is a path the group meets through: it
    must not exist yet, and its directory must."""
    if os.path.exists(rendezvous):
        raise ValueError(f"rendezvous file {rendezvous} exists already")
    _resolve(fn)
    world = math.prod(shape)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    call = pickle.dumps((fn, tuple(shape), tuple(args), dict(kwargs or {}), pass_mesh))
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, rendezvous, timeout_s, call, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got: dict[int, object] = {}
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{fn} on a {shape} mesh: no result from ranks "
                                   f"{sorted(set(range(world)) - set(got))} in {timeout_s} s")
            try:
                rank, status, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"{fn}: a rank exited with {dead[0]} before its result")
                continue
            if status == "error":
                raise RuntimeError(f"{fn} failed on rank {rank}:\n{out}")
            got[rank] = pickle.loads(out)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [got[r] for r in range(world)]
