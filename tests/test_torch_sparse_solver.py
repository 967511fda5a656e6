"""The port's sparse solver against the JAX package's, decision by decision.

The per-sweep plan (block permutation, kernel seeds, gumbel noise) is
built here from JAX's own key stream — the same ``split`` / ``randint`` /
``permutation`` / ``gumbel`` calls as ``sparse_solver.py:556-584`` — and
handed to the port, so both solvers see the same random decisions. With
integer pair weights every mass is exact, so placements, per-sweep move
and swap counts must be EXACTLY equal; objectives are compared at rel
1e-6 (f32 sums over the edge list may associate differently).

The JAX package's jitted plain path fuses ``M - lam * pct`` into one
multiply-add on the CPU (ROADMAP Queue 3), so its pairing runs at
``balance_weight = 0``; at 0.5 the port is held to the JAX solve run op by
op (``jax.disable_jit``). Its Pallas-interpret lowering runs without
noise, so the port's kernel lowering is compared with noise off.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu.core import sparsegraph as jsg
from kubernetes_rescheduling_tpu.core import topology as jtopo
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu.solver import pod_mode as jpm
from kubernetes_rescheduling_tpu.solver import sparse_solver as jss
from kubernetes_rescheduling_tpu_torch import cli, convert
from kubernetes_rescheduling_tpu_torch.core import sparsegraph as tsg
from kubernetes_rescheduling_tpu_torch.core import topology as ttopo
from kubernetes_rescheduling_tpu_torch.objectives import capacity_violation
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs
from kubernetes_rescheduling_tpu_torch.solver import pod_mode as tpm
from kubernetes_rescheduling_tpu_torch.solver import sparse_solver as tss


def jax_sparse_plan(key, sweeps, layout, N):
    """The per-sweep plan from JAX's key stream (sparse_solver.py:556-584
    and :689)."""
    n_chunks, G = layout.n_chunks, len(layout.hub_groups)
    plans = []
    for sweep_key in jax.random.split(key, sweeps):
        perm_key, noise_key = jax.random.split(sweep_key)
        seeds = jax.random.randint(jax.random.fold_in(noise_key, 7), (n_chunks + G,), 0,
                                   2**31 - 1)
        if G:
            keys = jax.random.split(noise_key, n_chunks + G)
            chunk_keys, hub_keys = keys[:n_chunks], keys[n_chunks:]
        else:
            chunk_keys, hub_keys = jax.random.split(noise_key, n_chunks), []
        bp = jax.random.permutation(perm_key, n_chunks * layout.blocks_per_chunk)
        gumbel = np.stack([np.asarray(jax.random.gumbel(k, (layout.width, N)))
                           for k in chunk_keys])
        hub_gumbel = tuple(
            torch.as_tensor(np.array(jax.random.gumbel(k, (len(g) * 256, N))))
            for k, g in zip(hub_keys, layout.hub_groups)
        )
        plans.append(tss.SparseSweepPlan(
            block_perm=torch.as_tensor(np.array(bp)), seeds=torch.as_tensor(np.array(seeds)),
            gumbel=torch.as_tensor(gumbel), hub_gumbel=hub_gumbel,
        ))
    return plans


def hub_instance(weight: float = 1.0):
    """1536 services: a 300-arm star over a random mean-degree-3 background,
    bu=128, reg_tiles=8 — the star's block is a hub (ragged, wider than the
    1024 regular columns), the other five regular; 16 nodes, a quarter of
    the pods piled on node 0 (over its budget). Every edge weighs
    ``weight``."""
    S = 1536
    rng = np.random.default_rng(10)
    E = int(S * 3.0 / 2)
    src = np.concatenate([np.zeros(300, np.int64), rng.integers(0, S, size=E)])
    dst = np.concatenate([np.arange(1, 301, dtype=np.int64), rng.integers(0, S, size=E)])
    w = np.full(len(src), weight)
    kw = dict(bu=128, reg_tiles=8)
    scn = dict(n_pods=S, n_nodes=16, seed=6)
    return (jtopo.synthetic_scenario(**scn).state, jsg.from_edges(src, dst, w, S, **kw),
            ttopo.synthetic_scenario(**scn, device="cpu").state,
            tsg.from_edges(src, dst, w, S, device="cpu", **kw))


def plain_instance():
    """tests/test_sparse_solver.py:263's instance: 1024 power-law services
    on 8 nodes, identity relabeling, reg_tiles=4 — no hub blocks."""
    kw = dict(n_pods=1024, n_nodes=8, powerlaw=True, seed=12)
    j_scn, t_scn = jtopo.synthetic_scenario(**kw), ttopo.synthetic_scenario(**kw, device="cpu")
    gkw = dict(reg_tiles=4, degree_sort=False)
    return (j_scn.state, jsg.from_comm_graph(j_scn.graph, **gkw), t_scn.state,
            tsg.from_comm_graph(t_scn.graph, **gkw))


@pytest.fixture(scope="module")
def instances():
    return {"hub": hub_instance(), "plain": plain_instance()}


def assert_same_solve(t_state, t_info, j_state, j_info):
    np.testing.assert_array_equal(t_state.pod_node.numpy(), np.asarray(j_state.pod_node))
    for k in ("moves_per_sweep", "swaps_per_sweep"):
        np.testing.assert_array_equal(t_info[k].numpy(), np.asarray(j_info[k]), err_msg=k)
    for k in ("objective_before", "objective_after", "communication_cost", "move_penalty"):
        assert float(t_info[k]) == pytest.approx(float(j_info[k]), rel=1e-6), k
    assert bool(t_info["hub_pass"]) == bool(j_info["hub_pass"])


@pytest.mark.parametrize("name,port_mode,jax_mode,extra", [
    # plain path against the jitted XLA path, noise from the plan
    ("hub", "off", "off", dict(noise_temp=1.0, balance_weight=0.0)),
    # kernel lowering against the Pallas interpreter (noise off there)
    ("hub", "on", "interpret", dict(noise_temp=0.0, balance_weight=0.5)),
    # ... with disruption pricing (move penalty in the score, pod-level
    # restart bill at the adopt gate)
    ("plain", "on", "interpret", dict(noise_temp=0.0, balance_weight=0.5, move_cost=0.6)),
])
def test_solve_matches_jax(instances, name, port_mode, jax_mode, extra):
    j_state, j_graph, t_state, t_graph = instances[name]
    base = dict(sweeps=3, chunk_size=512 if name == "hub" else 256, **extra)
    key = jax.random.PRNGKey(5)
    j_new, j_info = jss.global_assign_sparse(
        j_state, j_graph, key, jgs.GlobalSolverConfig(**base, fused_epilogue=jax_mode))
    cfg = tgs.GlobalSolverConfig(**base, fused_epilogue=port_mode)
    lay = tss.sparse_layout(t_graph, cfg)
    assert bool(lay.hub_groups) == (name == "hub") and lay.n_chunks >= 2
    plan = jax_sparse_plan(key, cfg.sweeps, lay, t_state.num_nodes)
    t_new, t_info = tss.global_assign_sparse(t_state, t_graph, None, cfg, plan=plan)
    assert_same_solve(t_new, t_info, j_new, j_info)
    assert int(t_info["swaps_per_sweep"][-1]) >= 0
    assert float(t_info["objective_after"]) < float(t_info["objective_before"])


def test_plain_path_matches_unjitted_jax(instances):
    """At balance_weight 0.5 the port's plain path equals the JAX solver
    run op by op, decision for decision."""
    j_state, j_graph, t_state, t_graph = instances["plain"]
    base = dict(sweeps=2, chunk_size=256, noise_temp=0.0, balance_weight=0.5,
                fused_epilogue="off")
    key = jax.random.PRNGKey(2)
    with jax.disable_jit():
        j_new, j_info = jss._global_assign_sparse.__wrapped__(
            j_state, j_graph, key, jgs.GlobalSolverConfig(**base))
    cfg = tgs.GlobalSolverConfig(**base)
    plan = jax_sparse_plan(key, cfg.sweeps, tss.sparse_layout(t_graph, cfg), t_state.num_nodes)
    t_new, t_info = tss.global_assign_sparse(t_state, t_graph, None, cfg, plan=plan)
    assert_same_solve(t_new, t_info, j_new, j_info)


def test_sparse_equals_dense_inline_solve(instances):
    """With identity relabeling, no hub blocks, f32 weights and integer
    weights the sparse solve equals the dense inline solve; one generator
    seed draws the same block permutation and seeds for both."""
    _, _, t_state, t_graph = instances["plain"]
    graph = t_graph.to_dense()
    cfg = tgs.GlobalSolverConfig(sweeps=3, chunk_size=256, matmul_dtype="float32",
                                 fused_epilogue="on")
    d_state, d_info = tgs.global_assign(t_state, graph, torch.Generator().manual_seed(3), cfg)
    assert bool(d_info["inline_mass"])
    s_state, s_info = tss.global_assign_sparse(t_state, t_graph,
                                               torch.Generator().manual_seed(3), cfg)
    assert torch.equal(s_state.pod_node, d_state.pod_node)
    assert float(s_info["objective_after"]) == pytest.approx(
        float(d_info["objective_after"]), rel=1e-6)
    assert torch.equal(s_info["moves_per_sweep"], d_info["moves_per_sweep"])


def test_carried_across_graph_gives_the_same_solve(instances):
    j_state, j_graph, t_state, t_graph = instances["hub"]
    fields = {k: np.asarray(getattr(j_graph, k)) for k in convert.SPARSE_ARRAYS}
    fields.update({k: getattr(j_graph, k) for k in convert.SPARSE_STATIC})
    carried = convert.sparse_graph_from_arrays(fields, device="cpu")
    cfg = tgs.GlobalSolverConfig(sweeps=2, chunk_size=512, fused_epilogue="on")
    a, ia = tss.global_assign_sparse(t_state, carried, torch.Generator().manual_seed(1), cfg)
    b, ib = tss.global_assign_sparse(t_state, t_graph, torch.Generator().manual_seed(1), cfg)
    assert torch.equal(a.pod_node, b.pod_node)
    assert float(ia["objective_after"]) == float(ib["objective_after"])


@pytest.mark.parametrize("mode", ["on", "off"])
def test_never_worse_and_respects_capacity(mode):
    """tests/test_sparse_solver.py:303's tight instance, both lowerings,
    plans drawn from a generator (deterministic per seed)."""
    scn = ttopo.synthetic_scenario(n_pods=512, n_nodes=8, seed=5, node_cpu_cap_m=8000.0,
                                   imbalance_frac=0.5, powerlaw=True, device="cpu")
    sg = tsg.from_comm_graph(scn.graph)
    cfg = tgs.GlobalSolverConfig(sweeps=4, fused_epilogue=mode)
    runs = [tss.global_assign_sparse(scn.state, sg, torch.Generator().manual_seed(1), cfg)
            for _ in range(2)]
    (new_state, info), (again, _) = runs
    assert torch.equal(new_state.pod_node, again.pod_node)
    assert float(capacity_violation(new_state)) <= float(capacity_violation(scn.state)) + 1e-3
    # never worse in the objective (comm + over-budget repulsion): here the
    # solve trades communication for draining the over-budget node
    assert float(info["objective_after"]) < float(info["objective_before"])
    with pytest.raises(ValueError, match="generator"):
        tss.global_assign_sparse(scn.state, sg, None, cfg)


def test_auto_takes_the_kernels_on_the_card_at_any_size():
    """Under "auto" a CUDA solve runs the kernels whatever its size (here 20
    nodes), sparse and dense alike (a single-block sparse graph goes to the
    dense solver); on the CPU it runs the plain twin, which decides as the
    kernel lowering does with noise off."""
    scn = ttopo.synthetic_scenario(n_pods=600, n_nodes=20, powerlaw=True, seed=2, device="cpu")
    sg = tsg.from_comm_graph(scn.graph)
    auto = tgs.GlobalSolverConfig(sweeps=3, noise_temp=0.0)
    on = dataclasses.replace(auto, fused_epilogue="on")
    off = dataclasses.replace(auto, fused_epilogue="off")
    assert tss.sparse_layout(sg, auto).n_chunks >= 2 and scn.state.num_nodes < 128
    assert tgs.kernel_lowering(auto, torch.device("cuda"))
    assert tgs.kernel_lowering(on, torch.device("cpu"))
    assert not tgs.kernel_lowering(auto, torch.device("cpu"))
    assert not tgs.kernel_lowering(off, torch.device("cuda"))
    (a, ia), (b, ib) = (tss.global_assign_sparse(scn.state, sg, torch.Generator().manual_seed(4),
                                                 cfg) for cfg in (auto, on))
    assert torch.equal(a.pod_node, b.pod_node)
    assert torch.equal(ia["moves_per_sweep"], ib["moves_per_sweep"])
    assert float(ia["objective_after"]) == pytest.approx(float(ib["objective_after"]), rel=1e-6)


@pytest.mark.parametrize("mode", ["auto", "on"])
def test_non_integer_weights_take_the_kernels_on_the_card(mode):
    """Every mass kernel sums in a fixed order, so a graph whose pair
    weights are not integers takes the kernel lowering on CUDA like any
    other (nothing raises); "off" still takes the plain twin, and the CPU
    solves it."""
    scn = ttopo.synthetic_scenario(n_pods=600, n_nodes=8, powerlaw=True, seed=2, device="cpu")
    sg = tsg.from_comm_graph(scn.graph)
    src, dst = sg.perm[sg.edges_src.long()].numpy(), sg.perm[sg.edges_dst.long()].numpy()
    w = sg.edges_w.numpy() * 0.75
    weighted = tsg.from_edges(src, dst, w, sg.num_services, symmetric_input=True, device="cpu")
    assert not np.array_equal(weighted.edges_w.numpy(), np.round(weighted.edges_w.numpy()))
    cfg = tgs.GlobalSolverConfig(sweeps=2, fused_epilogue=mode)
    assert tgs.kernel_lowering(cfg, torch.device("cuda"))
    assert not tgs.kernel_lowering(dataclasses.replace(cfg, fused_epilogue="off"),
                                   torch.device("cuda"))
    _, info = tss.global_assign_sparse(scn.state, weighted, torch.Generator().manual_seed(1), cfg)
    assert float(info["objective_after"]) <= float(info["objective_before"])


def test_single_block_delegates_to_dense():
    scn = ttopo.synthetic_scenario(n_pods=120, n_nodes=6, seed=4, device="cpu")
    sg = tsg.from_comm_graph(scn.graph)
    assert sg.num_blocks == 1 and sg.dense_adj is not None
    cfg = tgs.GlobalSolverConfig(sweeps=3)
    s_state, s_info = tss.global_assign_sparse(scn.state, sg, torch.Generator().manual_seed(2),
                                               cfg)
    d_state, d_info = tgs.global_assign(scn.state, scn.graph, torch.Generator().manual_seed(2),
                                        cfg)
    assert not bool(s_info["hub_pass"])
    assert torch.equal(s_state.pod_node, d_state.pod_node)
    assert float(s_info["objective_after"]) == float(d_info["objective_after"])


def test_pods_match_jax():
    """``global_assign_pods`` at one restart: the sparse solve on the
    pod-level graph of a 2-replica mesh, plain path with the plan's noise."""
    kw = dict(n_pods=600, n_nodes=12, powerlaw=True, seed=3, replicas=2)
    j_scn, t_scn = jtopo.synthetic_scenario(**kw), ttopo.synthetic_scenario(**kw, device="cpu")
    base = dict(sweeps=2, noise_temp=1.0, fused_epilogue="off")
    key = jax.random.PRNGKey(7)
    j_new, j_info = jpm.global_assign_pods(j_scn.state, j_scn.graph, key,
                                           jgs.GlobalSolverConfig(**base))
    pod_graph = tpm.pod_level_graph(t_scn.state, t_scn.graph)
    assert_same_graph_arrays(pod_graph, jpm.pod_level_graph(j_scn.state, j_scn.graph))
    cfg = tgs.GlobalSolverConfig(**base)
    plan = jax_sparse_plan(key, cfg.sweeps, tss.sparse_layout(pod_graph, cfg),
                           t_scn.state.num_nodes)
    t_new, t_info = tpm.global_assign_pods(t_scn.state, None, None, cfg, pod_graph=pod_graph,
                                           plan=plan)
    assert_same_solve(t_new, t_info, j_new, j_info)
    assert int(t_info["restarts"]) == int(j_info["restarts"]) == 1
    # the sparse form of the service graph expands to the same pod graph
    via_sparse = tpm.pod_level_graph(t_scn.state, tsg.from_comm_graph(t_scn.graph))
    assert_same_graph_arrays(via_sparse, pod_graph)
    # best-of-2 restarts on the pod graph, fed the JAX restarts' plans
    j_best, j_rinfo = jpm.global_assign_pods(j_scn.state, j_scn.graph, key,
                                             jgs.GlobalSolverConfig(**base), n_restarts=2)
    plans = [jax_sparse_plan(k, cfg.sweeps, tss.sparse_layout(pod_graph, cfg),
                             t_scn.state.num_nodes) for k in jax.random.split(key, 2)]
    t_best, t_rinfo = tpm.global_assign_pods(t_scn.state, None, None, cfg, pod_graph=pod_graph,
                                             n_restarts=2, plans=plans)
    np.testing.assert_array_equal(t_best.pod_node.numpy(), np.asarray(j_best.pod_node))
    assert int(t_rinfo["best_restart"]) == int(j_rinfo["best_restart"])
    np.testing.assert_allclose(t_rinfo["restart_objectives"].numpy(),
                               np.asarray(j_rinfo["restart_objectives"]), rtol=1e-6)
    assert int(t_rinfo["restarts"]) == int(j_rinfo["restarts"]) == 2


def assert_same_graph_arrays(t, j):
    for name in ("w_local", "u_ids", "edges_src", "edges_dst", "edges_w", "perm", "inv"):
        np.testing.assert_array_equal(getattr(t, name).cpu().numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)
    assert (t.block_toff, t.hub_blocks, t.regular_blocks) == (
        j.block_toff, j.hub_blocks, j.regular_blocks)


@pytest.mark.parametrize("flags", [["--sparse"], ["--placement-unit", "pod"]])
def test_cli_sparse_and_pod_solves(flags, capsys):
    import json

    assert cli.main(["solve", "--scenario", "powerlaw", "--sweeps", "2", "--device", "cpu",
                     *flags]) == 0
    out = json.loads(capsys.readouterr().out)
    assert {"scenario", "restarts", "tp", "communication_cost_before",
            "communication_cost_after", "load_std_before", "load_std_after",
            "moves_per_sweep"} <= set(out)
    assert out["communication_cost_after"] <= out["communication_cost_before"]
    assert out.get("sparse", False) == ("--sparse" in flags)
    assert out.get("placement_unit", "service") == ("pod" if "pod" in flags else "service")
