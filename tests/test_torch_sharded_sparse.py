"""The port's node-sharded sparse solver against the JAX package's
(tests/test_sharded_sparse.py) and against the port's single-device sparse
solve, plus the node-sharded pod solve and a global control-loop round
with ``--tp 2`` over a gloo group.

The multi-rank cases run as gloo groups of 2 or 4 spawned processes
(``parallel.launch.run_group``: one torch thread a rank, a rendezvous file
under ``tmp_path``, a timeout of their own), importing torch and the port
only. With annealing noise off and ``balance_weight`` 0 every mass and
load is an integer sum, so the bars are exact: placements and restart
selection equal, objectives at rel 1e-6 (f32 sums over the edge list may
associate differently).
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_parallel import fake_mesh
from test_torch_sparse_solver import hub_instance, jax_sparse_plan

from kubernetes_rescheduling_tpu.core import sparsegraph as jsg
from kubernetes_rescheduling_tpu.core import topology as jtopo
from kubernetes_rescheduling_tpu.parallel import make_mesh as j_make_mesh
from kubernetes_rescheduling_tpu.parallel import solve_with_restarts as j_solve
from kubernetes_rescheduling_tpu.parallel.sharded_sparse import (
    sharded_sparse_assign as j_sharded_sparse,
)
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu_torch.core import sparsegraph as tsg
from kubernetes_rescheduling_tpu_torch.core import topology as ttopo
from kubernetes_rescheduling_tpu_torch.parallel import sharded_sparse as tsp
from kubernetes_rescheduling_tpu_torch.parallel import solve_with_restarts
from kubernetes_rescheduling_tpu_torch.parallel.launch import run_group
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs
from kubernetes_rescheduling_tpu_torch.solver import pod_mode as tpm
from kubernetes_rescheduling_tpu_torch.solver import sparse_solver as tss

PKG = "kubernetes_rescheduling_tpu_torch"
GROUP_TIMEOUT_S = 120.0
EXACT = dict(noise_temp=0.0, balance_weight=0.0)


def instance(n_pods=768, n_nodes=8, seed=12):
    """tests/test_sharded_sparse.py's power-law instance, cut to 768
    services (3 sparse blocks) on 8 nodes."""
    kw = dict(n_pods=n_pods, n_nodes=n_nodes, powerlaw=True, seed=seed, node_cpu_cap_m=8_000.0)
    j_scn, t_scn = jtopo.synthetic_scenario(**kw), ttopo.synthetic_scenario(**kw, device="cpu")
    return j_scn, jsg.from_comm_graph(j_scn.graph), t_scn, tsg.from_comm_graph(t_scn.graph)


def group(tmp_path, fn, shape, *args, pass_mesh=True, **kwargs):
    outs = run_group(f"{PKG}.{fn}", shape, args, kwargs, pass_mesh=pass_mesh,
                     rendezvous=str(tmp_path / f"rdzv_{fn.rsplit('.', 1)[-1]}"),
                     timeout_s=GROUP_TIMEOUT_S)
    for st, _ in outs[1:]:
        assert torch.equal(st.pod_node, outs[0][0].pod_node)
    return outs[0]


def test_sharded_sparse_tp2_matches_jax_and_single(tmp_path):
    j_scn, j_sg, t_scn, t_sg = instance()
    assert t_sg.num_blocks > 1
    key = jax.random.PRNGKey(3)
    cfg = tgs.GlobalSolverConfig(sweeps=3, **EXACT)
    plan = jax_sparse_plan(key, cfg.sweeps, tss.sparse_layout(t_sg, cfg), 8)
    j_st, j_info = j_sharded_sparse(j_scn.state, j_sg, key, j_make_mesh(2, shape=(1, 2)),
                                    jgs.GlobalSolverConfig(sweeps=3, **EXACT))
    t_st, t_info = group(tmp_path, "parallel.sharded_sparse_assign", (1, 2), t_scn.state, t_sg,
                         None, config=cfg, plan=plan)
    np.testing.assert_array_equal(t_st.pod_node.numpy(), np.asarray(j_st.pod_node))
    assert set(t_info) == set(j_info) and int(t_info["tp"]) == 2
    for k in ("objective_before", "objective_after", "move_penalty"):
        assert float(t_info[k]) == pytest.approx(float(j_info[k]), rel=1e-6), k
    s_st, s_info = tss.global_assign_sparse(t_scn.state, t_sg, None, cfg, plan=plan)
    assert torch.equal(s_st.pod_node, t_st.pod_node)
    assert float(s_info["objective_after"]) == pytest.approx(float(t_info["objective_after"]),
                                                             rel=1e-6)


def test_sharded_sparse_hub_groups_and_move_cost(tmp_path):
    """The hub pass (a 300-arm star, ragged hub blocks) and disruption
    pricing under tp = 2: the single device's sparse decisions."""
    _, _, t_state, t_sg = hub_instance()
    assert t_sg.hub_blocks
    cfg = tgs.GlobalSolverConfig(sweeps=3, move_cost=2.0, **EXACT)
    plan = tss.draw_sparse_plans(torch.Generator().manual_seed(1), 3, tss.sparse_layout(t_sg, cfg))
    t_st, t_info = group(tmp_path, "parallel.sharded_sparse_assign", (1, 2), t_state, t_sg, None,
                         config=cfg, plan=plan)
    s_st, s_info = tss.global_assign_sparse(t_state, t_sg, None, cfg, plan=plan)
    assert torch.equal(s_st.pod_node, t_st.pod_node)
    assert float(t_info["move_penalty"]) == float(s_info["move_penalty"])
    if bool(t_info["improved"]):
        gain = float(t_info["objective_before"]) - float(t_info["objective_after"])
        assert gain > float(t_info["move_penalty"])


def test_sparse_dp_of_tp_restarts_2x2_matches_jax(tmp_path):
    """tests/test_sharded_sparse.py:183 at dp × tp = 2 × 2: two restarts of
    tp-sharded sparse solves against the JAX composed path, and the port's
    dp-only restarts of single-device sparse solves."""
    j_scn, j_sg, t_scn, t_sg = instance(seed=3)
    key = jax.random.PRNGKey(4)
    cfg = tgs.GlobalSolverConfig(sweeps=3, **EXACT)
    lay = tss.sparse_layout(t_sg, cfg)
    plans = [jax_sparse_plan(k, 3, lay, 8) for k in jax.random.split(key, 2)]
    j_st, j_info = j_solve(j_scn.state, j_scn.graph, key, n_restarts=2,
                           config=jgs.GlobalSolverConfig(sweeps=3, **EXACT), tp=2,
                           sparse_graph=j_sg)
    t_st, t_info = group(tmp_path, "parallel.sharded_sparse.sharded_sparse_solve_with_restarts",
                         (2, 2), t_scn.state, t_sg, None, n_restarts=2, config=cfg, plans=plans)
    np.testing.assert_array_equal(t_st.pod_node.numpy(), np.asarray(j_st.pod_node))
    assert int(t_info["best_restart"]) == int(j_info["best_restart"])
    np.testing.assert_allclose(t_info["restart_objectives"].numpy(),
                               np.asarray(j_info["restart_objectives"]), rtol=1e-6)
    d_st, d_info = solve_with_restarts(t_scn.state, None, None, n_restarts=2, config=cfg,
                                       sparse_graph=t_sg, plans=plans)
    assert torch.equal(d_st.pod_node, t_st.pod_node)
    assert int(d_info["best_restart"]) == int(t_info["best_restart"])


def test_pod_solve_tp2_over_a_group(tmp_path):
    """``global_assign_pods(tp=2)``: the pod graph's node-sharded solve
    over a gloo group equals the single device's pod solve."""
    t_scn = ttopo.synthetic_scenario(n_pods=600, n_nodes=12, powerlaw=True, seed=3, replicas=2,
                                     device="cpu")
    pod_graph = tpm.pod_level_graph(t_scn.state, t_scn.graph)
    assert pod_graph.num_blocks > 1
    cfg = tgs.GlobalSolverConfig(sweeps=2, **EXACT)
    plan = tss.draw_sparse_plans(torch.Generator().manual_seed(2), 2,
                                 tss.sparse_layout(pod_graph, cfg))
    t_st, t_info = group(tmp_path, "solver.pod_mode.global_assign_pods", (1, 2), t_scn.state,
                         None, None, cfg, pod_graph=pod_graph, plan=plan)
    s_st, _ = tpm.global_assign_pods(t_scn.state, None, None, cfg, pod_graph=pod_graph, plan=plan)
    assert torch.equal(s_st.pod_node, t_st.pod_node)
    assert int(t_info["tp"]) == 2 and int(t_info["restarts"]) == 1


def test_reschedule_tp2_round_over_a_group(tmp_path):
    """``reschedule --algorithm global --tp 2 --restarts 2`` in a world of 4
    (the CLI inside a process group it did not start): every rank prints
    the same rounds, and each solve adopts no worse than its input."""
    argv = ["reschedule", "--algorithm", "global", "--tp", "2", "--restarts", "2", "--rounds",
            "2", "--imbalance", "--scenario", "dense", "--device", "cpu"]
    outs = run_group(f"{PKG}.cli.run_command", (4,), (argv,), pass_mesh=False,
                     rendezvous=str(tmp_path / "rdzv"), timeout_s=GROUP_TIMEOUT_S)
    rounds = [[{k: r[k] for k in ("services_moved", "communication_cost", "load_std")}
               for r in o["rounds"]] for o in outs]
    assert all(r == rounds[0] for r in rounds) and len(rounds[0]) == 2
    assert all(r["objective_after"] <= r["objective_before"] or r["objective_before"] is None
               for r in outs[0]["rounds"])


def test_guards():
    _, _, t_scn, t_sg = instance(n_pods=512, n_nodes=12, seed=2)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="multiple of tp"):
        tsp.sharded_sparse_assign(t_scn.state, t_sg, gen, fake_mesh(1, 8))
    tiny = ttopo.synthetic_scenario(n_pods=100, n_nodes=4, seed=1, device="cpu")
    sg_tiny = tsg.from_comm_graph(tiny.graph)
    assert sg_tiny.num_blocks == 1
    with pytest.raises(ValueError, match="single-block"):
        tsp.sharded_sparse_assign(tiny.state, sg_tiny, gen, fake_mesh(2, 4))
    with pytest.raises(ValueError, match="over max_weight_bytes"):
        tsp.sharded_sparse_assign(t_scn.state, t_sg, gen, fake_mesh(1, 2),
                                  tgs.GlobalSolverConfig(max_weight_bytes=1))
    with pytest.raises(ValueError, match="n_restarts 3 must be a multiple of dp=2"):
        tsp.sharded_sparse_solve_with_restarts(t_scn.state, t_sg, gen, fake_mesh(2, 2),
                                               n_restarts=3)
