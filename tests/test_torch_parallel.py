"""The port's mesh, best-of-N restarts and node-sharded dense solve against
the JAX package's ``parallel`` on its 8 virtual CPU devices
(tests/test_parallel.py's cases).

The JAX side runs in this process; the port's multi-rank cases run as
gloo groups of 2 or 4 spawned processes (``parallel.launch.run_group``:
one torch thread a rank, a rendezvous file under ``tmp_path``, a timeout
of its own), which import torch and the port only. The port is fed the
JAX key stream's plans (``split(key, R)`` a restart, each split into the
sweeps' keys as ``global_assign`` does). Bars:

- restart selection (``best_restart``) and the placements exact; the
  ranked ``restart_objectives`` at rel 1e-6 (f32 sums of integer weights,
  the jitted JAX path at ``balance_weight`` 0, where it fuses nothing);
- the node-sharded solves with annealing noise off: placements equal to
  the JAX sharded solve's and to the port's single-device solve at
  ``balance_weight`` 0 (integer arithmetic); at 0.5 the shards' one-pass
  variance associates differently from the single device's two-pass
  one, so the bar is tests/test_ops.py's (>= 99% placements, objective
  rel 1e-3), as the JAX tests allow ulp ties there;
- ``sharded_choose_node``: the four deterministic policies exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_global_solver import jax_plan

from kubernetes_rescheduling_tpu.core import topology as jtopo
from kubernetes_rescheduling_tpu.parallel import make_mesh as j_make_mesh
from kubernetes_rescheduling_tpu.parallel import parallel_restarts as j_parallel_restarts
from kubernetes_rescheduling_tpu.parallel import sharded_choose_node as j_choose
from kubernetes_rescheduling_tpu.parallel import sharded_global_assign as j_sharded
from kubernetes_rescheduling_tpu.parallel import solve_with_restarts as j_solve
from kubernetes_rescheduling_tpu.parallel.sharded_solver import (
    sharded_solve_with_restarts as j_sharded_restarts,
)
from kubernetes_rescheduling_tpu.policies import POLICY_IDS, detect_hazard
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu_torch.core import topology as ttopo
from kubernetes_rescheduling_tpu_torch.parallel import mesh as tmesh
from kubernetes_rescheduling_tpu_torch.parallel import sharded as tsh
from kubernetes_rescheduling_tpu_torch.parallel import sharded_solver as tss
from kubernetes_rescheduling_tpu_torch.parallel.launch import run_group
from kubernetes_rescheduling_tpu_torch.policies.scoring import choose_node
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs

PKG = "kubernetes_rescheduling_tpu_torch.parallel"
GROUP_TIMEOUT_S = 120.0


def pair(**kw):
    return jtopo.synthetic_scenario(**kw), ttopo.synthetic_scenario(**kw, device="cpu")


def restart_plans(key, n, cfg, S, N):
    """The plans of JAX ``parallel_restarts``' restarts on the XLA path."""
    return [jax_plan(k, cfg, S, N, inline=False) for k in jax.random.split(key, n)]


def sharded_plan(key, cfg, S, N):
    """A node-sharded JAX solve's per-sweep compositions
    (``sharded_solver.py:404-406``: a full permutation a sweep); noise off,
    so no gumbel."""
    C = min(jgs.auto_chunk(S, cfg.chunk_size), S)
    n_chunks = -(-S // C)
    plans = []
    for sweep_key in jax.random.split(key, cfg.sweeps):
        perm_key, _ = jax.random.split(sweep_key)
        ids, _ = jgs.sweep_composition(perm_key, n_chunks * C, C, n_chunks)
        ids = torch.as_tensor(np.array(ids))
        plans.append(tgs.SweepPlan(ids, ids, torch.zeros(n_chunks, dtype=torch.int32)))
    return plans


def group(tmp_path, fn, shape, *args, **kwargs):
    """``fn`` on every rank of a gloo group of ``shape``; every rank must
    return the same placement, and rank 0's result is returned."""
    outs = run_group(f"{PKG}.{fn}", shape, args, kwargs,
                     rendezvous=str(tmp_path / f"rdzv_{fn}"), timeout_s=GROUP_TIMEOUT_S)
    for st, _ in outs[1:]:
        assert torch.equal(st.pod_node, outs[0][0].pod_node)
    return outs[0]


def same_restarts(t_info, j_info, rel=1e-6):
    assert int(t_info["best_restart"]) == int(j_info["best_restart"])
    np.testing.assert_allclose(t_info["restart_objectives"].numpy(),
                               np.asarray(j_info["restart_objectives"]), rtol=rel)


def test_make_mesh_without_a_process_group():
    m = tmesh.make_mesh(device="cpu")
    assert m.shape == {"dp": 1, "tp": 1} and m.coords == {"dp": 0, "tp": 0}
    assert m.groups == {"dp": None, "tp": None}
    x = torch.arange(3.0)
    assert torch.equal(tmesh.psum(x, m, "tp"), x)
    assert torch.equal(tmesh.gather(x, m, "dp"), x[None])
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        tmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match=r"mesh shape \(2, 1\) != 1 devices"):
        tmesh.make_mesh(1, shape=(2, 1), device="cpu")
    assert j_make_mesh(8, shape=(4, 2)).shape == {"dp": 4, "tp": 2}


def test_make_mesh_in_a_gloo_group(tmp_path):
    """A (2, 2) mesh of four ranks: each rank's dp line, in dp order."""
    outs = run_group(f"{PKG}.sharded.dp_devices", (2, 2), rendezvous=str(tmp_path / "rdzv"),
                     timeout_s=GROUP_TIMEOUT_S)
    assert outs == [(0, 2), (1, 3), (0, 2), (1, 3)]


def test_parallel_restarts_matches_jax():
    """tests/test_parallel.py:30's instance, 4 restarts on a dp=4 JAX mesh
    against the port's sequential restarts on one process."""
    j_scn, t_scn = pair(n_pods=64, n_nodes=8, seed=4, mean_degree=5.0)
    key = jax.random.PRNGKey(0)
    j_cfg = jgs.GlobalSolverConfig(sweeps=4)
    j_st, j_info = j_parallel_restarts(j_scn.state, j_scn.graph, key, j_make_mesh(4),
                                       config=j_cfg)
    plans = restart_plans(key, 4, j_cfg, 64, 8)
    t_st, t_info = tsh.parallel_restarts(t_scn.state, t_scn.graph, None,
                                         tmesh.make_mesh(device="cpu"), n_restarts=4,
                                         config=tgs.GlobalSolverConfig(sweeps=4), plans=plans)
    same_restarts(t_info, j_info)
    np.testing.assert_array_equal(t_st.pod_node.numpy(), np.asarray(j_st.pod_node))
    assert float(t_info["objective_after"]) == pytest.approx(float(j_info["objective_after"]),
                                                             rel=1e-6)
    assert set(t_info) == set(j_info)


def test_solve_with_restarts_matches_jax_over_a_dp_group(tmp_path):
    """n_restarts = 4 on the JAX auto mesh (dp = 4) against the port over a
    gloo group of dp = 2 (two restarts a rank, the winner broadcast) and
    on one process; n_restarts = 1 is the solo solve."""
    j_scn, t_scn = pair(n_pods=96, n_nodes=8, seed=7, mean_degree=4.0)
    key = jax.random.PRNGKey(2)
    cfg = dict(sweeps=3)
    j_st, j_info = j_solve(j_scn.state, j_scn.graph, key, n_restarts=4,
                           config=jgs.GlobalSolverConfig(**cfg))
    plans = restart_plans(key, 4, jgs.GlobalSolverConfig(**cfg), 96, 8)
    t_cfg = tgs.GlobalSolverConfig(**cfg)
    t_st, t_info = group(tmp_path, "parallel_restarts", (2, 1), t_scn.state, t_scn.graph, None,
                         n_restarts=4, config=t_cfg, plans=plans)
    same_restarts(t_info, j_info)
    np.testing.assert_array_equal(t_st.pod_node.numpy(), np.asarray(j_st.pod_node))
    s_st, s_info = tsh.solve_with_restarts(t_scn.state, t_scn.graph, None, n_restarts=4,
                                           config=t_cfg, plans=plans)
    assert int(s_info["restarts"]) == int(j_info["restarts"]) == 4
    assert torch.equal(s_st.pod_node, t_st.pod_node)
    one_st, one_info = tsh.solve_with_restarts(t_scn.state, t_scn.graph, None, config=t_cfg,
                                               plans=plans[:1])
    solo_st, _ = tgs.global_assign(t_scn.state, t_scn.graph, None, t_cfg, plan=plans[0])
    assert torch.equal(one_st.pod_node, solo_st.pod_node) and int(one_info["restarts"]) == 1


def test_solve_with_restarts_default_plans_follow_the_generator():
    """Without plans, restart i draws from the i-th generator seeded off
    the caller's: the same restart objectives whatever the mesh, each
    equal to its own solo solve, and the selection is their argmin."""
    t_scn = ttopo.synthetic_scenario(n_pods=64, n_nodes=8, seed=5, mean_degree=5.0,
                                     device="cpu")
    cfg = tgs.GlobalSolverConfig(sweeps=3)
    st, info = tsh.solve_with_restarts(t_scn.state, t_scn.graph,
                                       torch.Generator().manual_seed(9), n_restarts=3,
                                       config=cfg)
    gens = tsh.restart_generators(torch.Generator().manual_seed(9), 3)
    solos = [tgs.global_assign(t_scn.state, t_scn.graph, g, cfg) for g in gens]
    ranked = [float(i["objective_after"] + i["move_penalty"]) for _, i in solos]
    assert info["restart_objectives"].tolist() == ranked
    best = int(np.argmin(ranked))
    assert int(info["best_restart"]) == best
    assert torch.equal(st.pod_node, solos[best][0].pod_node)


@pytest.mark.parametrize("bw", [0.0, 0.5])
def test_sharded_global_assign_tp2(tmp_path, bw):
    """tp = 2 over a gloo group against the JAX sharded solve on a (1, 2)
    mesh and the port's single-device solve, noise off; at λ = 0 with
    disruption pricing on (tests/test_parallel.py:271's move cost 1)."""
    j_scn, t_scn = pair(n_pods=200, n_nodes=16, seed=11, mean_degree=5.0)
    key = jax.random.PRNGKey(5)
    cfg = dict(sweeps=3, noise_temp=0.0, balance_weight=bw, move_cost=1.0 if bw == 0 else 0.0)
    plan = sharded_plan(key, jgs.GlobalSolverConfig(**cfg), 200, 16)
    t_st, t_info = group(tmp_path, "sharded_global_assign", (1, 2), t_scn.state, t_scn.graph,
                         None, config=tgs.GlobalSolverConfig(**cfg), plan=plan)
    solo_st, solo_info = tgs.global_assign(
        t_scn.state, t_scn.graph, None, tgs.GlobalSolverConfig(**cfg, fused_epilogue="off"),
        plan=plan)
    assert int(t_info["tp"]) == 2
    assert float(t_info["objective_after"]) <= float(t_info["objective_before"])
    if bw == 0.0:
        j_st, j_info = j_sharded(j_scn.state, j_scn.graph, key, j_make_mesh(2, shape=(1, 2)),
                                 jgs.GlobalSolverConfig(**cfg))
        np.testing.assert_array_equal(t_st.pod_node.numpy(), np.asarray(j_st.pod_node))
        assert set(t_info) == set(j_info)
        for k in ("objective_before", "objective_after", "move_penalty"):
            assert float(t_info[k]) == pytest.approx(float(j_info[k]), rel=1e-6), k
        assert torch.equal(t_st.pod_node, solo_st.pod_node)
        assert float(t_info["objective_after"]) == float(solo_info["objective_after"])
    else:
        assert (t_st.pod_node == solo_st.pod_node).float().mean() >= 0.99
        assert float(t_info["objective_after"]) == pytest.approx(
            float(solo_info["objective_after"]), rel=1e-3)


def test_sharded_solve_with_restarts_2x2_matches_jax(tmp_path):
    """dp × tp = 2 × 2: two restarts of tp-sharded solves against JAX's on
    a (2, 2) mesh, and against the port's dp-only restarts (one process)."""
    j_scn, t_scn = pair(n_pods=200, n_nodes=16, seed=13, mean_degree=5.0)
    key = jax.random.PRNGKey(7)
    cfg = dict(sweeps=3, noise_temp=0.0, balance_weight=0.0)
    j_st, j_info = j_sharded_restarts(j_scn.state, j_scn.graph, key,
                                      j_make_mesh(4, shape=(2, 2)), n_restarts=2,
                                      config=jgs.GlobalSolverConfig(**cfg))
    plans = [sharded_plan(k, jgs.GlobalSolverConfig(**cfg), 200, 16)
             for k in jax.random.split(key, 2)]
    t_st, t_info = group(tmp_path, "sharded_solve_with_restarts", (2, 2), t_scn.state,
                         t_scn.graph, None, n_restarts=2, config=tgs.GlobalSolverConfig(**cfg),
                         plans=plans)
    same_restarts(t_info, j_info)
    np.testing.assert_array_equal(t_st.pod_node.numpy(), np.asarray(j_st.pod_node))
    assert set(t_info) == set(j_info) and int(t_info["tp"]) == 2
    d_st, d_info = tsh.solve_with_restarts(
        t_scn.state, t_scn.graph, None, n_restarts=2,
        config=tgs.GlobalSolverConfig(**cfg, fused_epilogue="off"), plans=plans)
    assert torch.equal(d_st.pod_node, t_st.pod_node)
    np.testing.assert_allclose(d_info["restart_objectives"].numpy(),
                               t_info["restart_objectives"].numpy(), rtol=1e-5)


def test_tp_composed_entry_over_a_group(tmp_path):
    """``solve_with_restarts(tp=2)`` shapes its own (dp, tp) mesh from a
    world of 4: best-of-4 over dp = 2 is never worse than one tp-sharded
    solve, and reports tp and the restarts."""
    t_scn = ttopo.synthetic_scenario(n_pods=128, n_nodes=8, seed=14, mean_degree=4.0,
                                     device="cpu")
    cfg = tgs.GlobalSolverConfig(sweeps=3)
    outs = run_group(f"{PKG}.solve_with_restarts", (4,),
                     (t_scn.state, t_scn.graph, torch.Generator().manual_seed(0)),
                     dict(n_restarts=4, config=cfg, tp=2), pass_mesh=False,
                     rendezvous=str(tmp_path / "rdzv"), timeout_s=GROUP_TIMEOUT_S)
    st, multi = outs[0]
    assert all(torch.equal(o[0].pod_node, st.pod_node) for o in outs)
    assert int(multi["restarts"]) == 4 and int(multi["tp"]) == 2
    assert multi["restart_objectives"].shape == (4,)
    assert float(multi["objective_after"]) <= float(multi["objective_before"]) + 1e-3


@pytest.mark.parametrize("policy", ["spread", "binpack", "kubescheduling", "communication"])
def test_sharded_choose_node_matches_jax(tmp_path, policy):
    """tests/test_parallel.py:253 over a tp = 4 gloo group: the sharded
    decision equals the JAX sharded one and the port's unsharded one."""
    j_scn, t_scn = pair(n_pods=64, n_nodes=8, seed=2, mean_degree=5.0)
    _, j_hazard = detect_hazard(j_scn.state, threshold=30.0)
    hazard = torch.as_tensor(np.array(j_hazard))
    assert not bool(hazard.all())
    pid, svc = POLICY_IDS[policy], torch.tensor(3)
    expected = int(j_choose(jnp.asarray(pid), j_scn.state, j_scn.graph, jnp.asarray(3),
                            j_hazard, jax.random.PRNGKey(0), j_make_mesh(8, shape=(2, 4))))
    outs = run_group(f"{PKG}.sharded_choose_node", (1, 4),
                     (pid, t_scn.state, t_scn.graph, svc, hazard, None),
                     rendezvous=str(tmp_path / "rdzv"), timeout_s=GROUP_TIMEOUT_S)
    assert [int(o) for o in outs] == [expected] * 4
    assert int(choose_node(pid, t_scn.state, t_scn.graph, svc, hazard)) == expected


def fake_mesh(dp: int, tp: int) -> tmesh.Mesh:
    """A mesh of the given shape seen from rank 0 with no process group:
    enough for the checks that run before any collective."""
    return tmesh.Mesh(("dp", "tp"), {"dp": dp, "tp": tp}, {"dp": 0, "tp": 0},
                      {"dp": None, "tp": None}, {"dp": (0,), "tp": (0,)}, 0,
                      torch.device("cpu"))


def test_indivisible_nodes_and_restarts_refused():
    t_scn = ttopo.synthetic_scenario(n_pods=32, n_nodes=6, seed=1, mean_degree=4.0,
                                     device="cpu")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="must be a multiple of tp=4"):
        tss.sharded_global_assign(t_scn.state, t_scn.graph, gen, fake_mesh(2, 4))
    with pytest.raises(ValueError, match="must be a multiple of tp=4"):
        tsh.sharded_choose_node(0, t_scn.state, t_scn.graph, torch.tensor(0),
                                torch.zeros(6, dtype=torch.bool), None, fake_mesh(2, 4))
    with pytest.raises(ValueError, match="n_restarts 3 must be a multiple of dp=2"):
        tss.sharded_solve_with_restarts(t_scn.state, t_scn.graph, gen, fake_mesh(2, 3),
                                        n_restarts=3)
    with pytest.raises(ValueError, match="n_restarts 3 must be a multiple of dp=2"):
        tsh.parallel_restarts(t_scn.state, t_scn.graph, gen, fake_mesh(2, 1), n_restarts=3)
    with pytest.raises(ValueError, match="conflicts with the explicit mesh"):
        tsh.solve_with_restarts(t_scn.state, t_scn.graph, gen, tp=2, mesh=fake_mesh(1, 3))
    with pytest.raises(ValueError, match="tp=2 does not divide the 1 available devices"):
        tsh.solve_with_restarts(t_scn.state, t_scn.graph, gen, tp=2)
