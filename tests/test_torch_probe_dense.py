"""Dense solver configs outside the other solver tests, pinned against the
JAX package on the CPU: 13 configs on ``synthetic_scenario(n_pods=256,
n_nodes=128, seed=9)`` with key 4, at 3 sweeps unless the config says
otherwise, noise 0 and balance weight 0 (the sparse ones are in
tests/test_torch_probe_sparse.py).

Each pairs the port's plain path (``"off"``) with the jitted JAX solve, or
its kernel lowering (``"on"``, plain versions on the CPU) with the Pallas
interpreter, through the tests' plan injection. Bar: equal placements,
moves and swaps per sweep, and objectives within rel 1e-6.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
from test_torch_global_solver import jax_plan

from kubernetes_rescheduling_tpu.core import topology as jtopo
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu_torch.core.topology import synthetic_scenario
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs

PAIRINGS = {"off": "off", "on": "interpret"}

DENSE = [
    ("off", dict(enforce_capacity=False)),
    ("off", dict(capacity_frac=0.8)),
    ("off", dict(capacity_frac=0.8, overload_weight=3.0)),
    ("off", dict(matmul_dtype="float32")),
    ("off", dict(swap_every=0)),
    ("off", dict(swap_k=8)),
    ("off", dict(swap_k=8, move_cost=0.5)),
    ("off", dict(chunk_size=100)),
    ("off", dict(sweeps=5, swap_every=2)),
    ("on", dict(capacity_frac=0.8, overload_weight=3.0, chunk_size=256)),
    ("on", dict(swap_k=8, move_cost=0.5, chunk_size=256)),
    ("on", dict(enforce_capacity=False, chunk_size=256)),
    ("on", dict(sweeps=5, swap_every=2, chunk_size=256)),
]

KEY = jax.random.PRNGKey(4)


def _ids(cases):
    return ["-".join([*(c[:-1]), *(f"{k}={v}" for k, v in c[-1].items())]) for c in cases]


def solve_all(solve, cases, threads: int = 4) -> list:
    """``solve`` of every case, the JAX compiles overlapped. The solver
    config is a static argument of the JAX package's jit, so every case
    compiles a program of its own (about 2-3 s of a CPU, nearly all of a
    case's time) and no two cases share one; XLA compiles outside the
    GIL, so a few threads take the module's compiles side by side."""
    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(solve, cases))


def _base(extra: dict) -> dict:
    return {**dict(sweeps=3, noise_temp=0.0, balance_weight=0.0), **extra}


@pytest.fixture(scope="module")
def dense_scenarios():
    kw = dict(n_pods=256, n_nodes=128, seed=9, mean_degree=4.0)
    return jtopo.synthetic_scenario(**kw), synthetic_scenario(**kw, device="cpu")


@pytest.fixture(scope="module")
def jax_dense_solves(dense_scenarios):
    """Every case's JAX solve, by case id."""
    j_scn = dense_scenarios[0]

    def solve(case):
        mode, extra = case
        cfg = jgs.GlobalSolverConfig(**_base(extra), fused_epilogue=PAIRINGS[mode])
        j_state, j_info = jgs.global_assign(j_scn.state, j_scn.graph, KEY, cfg)
        return cfg, jax.block_until_ready(j_state), j_info

    return dict(zip(_ids(DENSE), solve_all(solve, DENSE)))


@pytest.mark.parametrize("mode,extra", DENSE, ids=_ids(DENSE))
def test_dense_probe_config_matches_jax(dense_scenarios, jax_dense_solves, mode, extra):
    t_scn = dense_scenarios[1]
    j_cfg, j_state, j_info = jax_dense_solves[_ids([(mode, extra)])[0]]
    inline = bool(j_info["inline_mass"])
    plan = jax_plan(KEY, j_cfg, t_scn.graph.num_services, t_scn.state.num_nodes, inline=inline)
    t_state, t_info = tgs.global_assign(t_scn.state, t_scn.graph, None,
                                        tgs.GlobalSolverConfig(**_base(extra), fused_epilogue=mode),
                                        plan=plan)
    assert bool(t_info["inline_mass"]) == inline
    np.testing.assert_array_equal(t_state.pod_node.numpy(), np.asarray(j_state.pod_node))
    for k in ("moves_per_sweep", "swaps_per_sweep"):
        np.testing.assert_array_equal(t_info[k].numpy(), np.asarray(j_info[k]), err_msg=k)
    for k in ("objective_before", "objective_after"):
        assert float(t_info[k]) == pytest.approx(float(j_info[k]), rel=1e-6), k
