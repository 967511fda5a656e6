"""Sparse solver configs outside the other solver tests, pinned against
the JAX package on the CPU: 13 configs on the ``hub`` and ``plain``
instances of tests/test_torch_sparse_solver.py with key 5, at 3 sweeps
unless the config says otherwise, noise 0 and balance weight 0 (the dense
ones are in tests/test_torch_probe_dense.py).

Each pairs the port's plain path (``"off"``) with the jitted JAX solve, or
its kernel lowering (``"on"``, plain versions on the CPU) with the Pallas
interpreter, through the tests' plan injection. Bar: equal placements,
moves and swaps per sweep, and objectives within rel 1e-6.
"""

import jax
import pytest
from test_torch_probe_dense import PAIRINGS, _ids, solve_all
from test_torch_sparse_solver import assert_same_solve, hub_instance, jax_sparse_plan, \
    plain_instance

from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu.solver import sparse_solver as jss
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs
from kubernetes_rescheduling_tpu_torch.solver import sparse_solver as tss

SPARSE = [
    ("hub", "off", dict(enforce_capacity=False)),
    ("hub", "off", dict(capacity_frac=0.8, overload_weight=3.0)),
    ("hub", "off", dict(matmul_dtype="float32")),
    ("hub", "off", dict(swap_every=0)),
    ("hub", "off", dict(swap_k=8, move_cost=0.5)),
    ("hub", "off", dict(chunk_size=300)),
    ("hub", "on", dict(capacity_frac=0.8)),
    ("hub", "on", dict(sweeps=5, swap_every=2)),
    ("plain", "off", dict(capacity_frac=0.8)),
    ("plain", "off", dict(swap_k=8)),
    ("plain", "off", dict(chunk_size=300)),
    ("plain", "on", dict(enforce_capacity=False)),
    ("plain", "on", dict(swap_k=8, move_cost=0.5)),
]


KEY = jax.random.PRNGKey(5)


def _base(name: str, extra: dict) -> dict:
    return {**dict(sweeps=3, noise_temp=0.0, balance_weight=0.0,
                   chunk_size=512 if name == "hub" else 256), **extra}


@pytest.fixture(scope="module")
def sparse_instances():
    return {"hub": hub_instance(), "plain": plain_instance()}


@pytest.fixture(scope="module")
def jax_sparse_solves(sparse_instances):
    """Every case's JAX solve, by case id (the compiles overlapped, as in
    tests/test_torch_probe_dense.py)."""

    def solve(case):
        name, mode, extra = case
        j_state, j_graph = sparse_instances[name][:2]
        j_new, j_info = jss.global_assign_sparse(
            j_state, j_graph, KEY,
            jgs.GlobalSolverConfig(**_base(name, extra), fused_epilogue=PAIRINGS[mode]))
        return jax.block_until_ready(j_new), j_info

    return dict(zip(_ids(SPARSE), solve_all(solve, SPARSE)))


@pytest.mark.parametrize("name,mode,extra", SPARSE, ids=_ids(SPARSE))
def test_sparse_probe_config_matches_jax(sparse_instances, jax_sparse_solves, name, mode, extra):
    t_state, t_graph = sparse_instances[name][2:]
    j_new, j_info = jax_sparse_solves[_ids([(name, mode, extra)])[0]]
    cfg = tgs.GlobalSolverConfig(**_base(name, extra), fused_epilogue=mode)
    plan = jax_sparse_plan(KEY, cfg.sweeps, tss.sparse_layout(t_graph, cfg), t_state.num_nodes)
    t_new, t_info = tss.global_assign_sparse(t_state, t_graph, None, cfg, plan=plan)
    assert_same_solve(t_new, t_info, j_new, j_info)
