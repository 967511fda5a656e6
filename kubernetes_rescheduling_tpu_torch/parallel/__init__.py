"""Device-mesh parallelism — the port of ``kubernetes_rescheduling_tpu.parallel``.

The JAX package's collectives ride the TPU interconnect under XLA; here
every device is one rank of a ``torch.distributed`` process group (NCCL on
the card, gloo on the CPU), started by ``torchrun`` or by the caller:

- ``make_mesh`` — this rank's view of a (dp, tp) grid of ranks
  (dp = restarts, tp = nodes); without a process group, a 1 × 1 mesh;
- ``parallel_restarts`` — best-of-N global solves, R/dp on each dp rank
  in sequence, the best selected on the device;
- ``solve_with_restarts`` — the production entry over the whole dp × tp
  × dense/sparse matrix, auto-shaping the mesh from the world;
- ``sharded_choose_node`` — the policy decision with the node axis
  sharded over tp;
- ``sharded_global_assign`` / ``sharded_sparse_assign`` — the dense and
  sparse global solves with the node axis sharded over tp;
- ``sharded_solve_with_restarts`` — dp restarts of tp-sharded solves;
- ``fleet_solve_dp`` (and in ``parallel.fleet`` the proactive and global
  planes) — fleet mode's dp plane: a block of tenants a rank, the
  blocks' outputs gathered over dp;
- ``parallel.dryrun.dryrun_multichip`` — every sharded path against its
  single-device twin on a (dp, tp) mesh.

The JAX package's ``compat.py`` (a shim over jax versions of
``shard_map``) has no counterpart.
"""

from kubernetes_rescheduling_tpu_torch.parallel.mesh import make_mesh
from kubernetes_rescheduling_tpu_torch.parallel.sharded import (
    parallel_restarts,
    sharded_choose_node,
    solve_with_restarts,
)
from kubernetes_rescheduling_tpu_torch.parallel.sharded_solver import (
    sharded_global_assign,
    sharded_solve_with_restarts,
)
from kubernetes_rescheduling_tpu_torch.parallel.sharded_sparse import sharded_sparse_assign
from kubernetes_rescheduling_tpu_torch.parallel.fleet import fleet_solve_dp

__all__ = [
    "make_mesh",
    "parallel_restarts",
    "sharded_choose_node",
    "sharded_global_assign",
    "sharded_sparse_assign",
    "sharded_solve_with_restarts",
    "solve_with_restarts",
    "fleet_solve_dp",
]
