"""Solves of graphs whose pair weights are not integers: the port against
the JAX package, dense and sparse, on the kernel lowering and the plain
twin.

Every edge weight is scaled by 0.75. The JAX solve runs its Pallas kernels
in interpret mode ("on" pairs with "interpret") or its plain path ("off"),
and the port the same lowering on the CPU (the kernel wrappers' plain
versions) with the plan built from jax's key stream, as the other parity
tests do. The bar is the JAX package's own for whole solves
(tests/test_ops.py:149-153): >= 99% identical placements and the objective
within rel 1e-3.
"""

import dataclasses

import jax
import numpy as np
import pytest

from kubernetes_rescheduling_tpu.core import topology as jtopo
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu.solver import sparse_solver as jss
from kubernetes_rescheduling_tpu_torch.core import topology as ttopo
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs
from kubernetes_rescheduling_tpu_torch.solver import sparse_solver as tss
from tests.test_torch_global_solver import jax_plan
from tests.test_torch_sparse_solver import hub_instance, jax_sparse_plan

# the pairings of the integer-weight parity tests: the jitted JAX "off" path
# contracts M - lam * pct into one multiply-add, so it runs at
# balance_weight 0 (dense) or with noise (sparse, from the plan)
CONFIGS = {
    ("dense", "on"): dict(noise_temp=0.0, balance_weight=0.5, chunk_size=256),
    ("dense", "off"): dict(noise_temp=0.0, balance_weight=0.0),
    ("sparse", "on"): dict(noise_temp=0.0, balance_weight=0.5, chunk_size=512),
    ("sparse", "off"): dict(noise_temp=1.0, balance_weight=0.0, chunk_size=512),
}


def dense_solves(port_mode, jax_mode, extra):
    kw = dict(n_pods=256, n_nodes=128, seed=9, mean_degree=4.0)
    j_scn, t_scn = jtopo.synthetic_scenario(**kw), ttopo.synthetic_scenario(**kw, device="cpu")
    j_graph = dataclasses.replace(j_scn.graph, adj=j_scn.graph.adj * 0.75)
    t_graph = dataclasses.replace(t_scn.graph, adj=t_scn.graph.adj * 0.75)
    key = jax.random.PRNGKey(4)
    j_cfg = jgs.GlobalSolverConfig(sweeps=3, **extra, fused_epilogue=jax_mode)
    j_state, j_info = jgs.global_assign(j_scn.state, j_graph, key, j_cfg)
    inline = bool(j_info["inline_mass"])
    plan = jax_plan(key, j_cfg, t_graph.num_services, t_scn.state.num_nodes, inline=inline)
    t_state, t_info = tgs.global_assign(
        t_scn.state, t_graph, None,
        tgs.GlobalSolverConfig(sweeps=3, **extra, fused_epilogue=port_mode), plan=plan,
    )
    assert bool(t_info["inline_mass"]) == inline == (port_mode == "on")
    return t_state, t_info, j_state, j_info


def sparse_solves(port_mode, jax_mode, extra):
    j_state, j_graph, t_state, t_graph = hub_instance(weight=0.75)
    key = jax.random.PRNGKey(5)
    j_new, j_info = jss.global_assign_sparse(
        j_state, j_graph, key, jgs.GlobalSolverConfig(sweeps=3, **extra,
                                                      fused_epilogue=jax_mode))
    cfg = tgs.GlobalSolverConfig(sweeps=3, **extra, fused_epilogue=port_mode)
    lay = tss.sparse_layout(t_graph, cfg)
    assert lay.hub_groups and lay.n_chunks >= 2
    plan = jax_sparse_plan(key, cfg.sweeps, lay, t_state.num_nodes)
    t_new, t_info = tss.global_assign_sparse(t_state, t_graph, None, cfg, plan=plan)
    assert bool(t_info["hub_pass"]) and bool(j_info["hub_pass"])
    return t_new, t_info, j_new, j_info


@pytest.mark.parametrize("form", ["dense", "sparse"])
@pytest.mark.parametrize("port_mode", ["on", "off"])
def test_non_integer_solve_matches_jax(form, port_mode):
    jax_mode = "interpret" if port_mode == "on" else "off"
    solves = dense_solves if form == "dense" else sparse_solves
    t_state, t_info, j_state, j_info = solves(port_mode, jax_mode, CONFIGS[form, port_mode])
    before = float(t_info["objective_before"])
    assert before == pytest.approx(float(j_info["objective_before"]), rel=1e-6)
    same = (t_state.pod_node.numpy() == np.asarray(j_state.pod_node)).mean()
    assert same >= 0.99
    assert float(t_info["objective_after"]) == pytest.approx(
        float(j_info["objective_after"]), rel=1e-3
    )
    assert float(t_info["objective_after"]) <= before
