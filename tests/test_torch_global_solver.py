"""The port's global solver against the JAX package's, decision by decision.

The per-sweep plan (chunk composition, kernel seeds, gumbel noise) is built
here from JAX's own key stream — the same ``split`` / ``sweep_composition``
/ ``randint`` / ``gumbel`` calls as ``global_solver.py`` — and injected into
the port, so both solvers see the same random decisions. The bar is the
JAX package's own for whole solves (tests/test_ops.py): >= 99% identical
placements and the objective within rel 1e-3.

One pairing is chosen with care: the JAX ``"off"`` path runs under jit,
where XLA contracts ``M - lam * pct`` into one fused multiply-add, while
its eager ops, its Pallas kernels and this port round the product first.
At ``balance_weight > 0`` that changes tie breaks on these tie-heavy
instances (integer masses), so the jitted ``"off"`` pairs run at
``balance_weight = 0`` (or with noise on the small instance, where the
first divergence comes late enough), and the port is held to the JAX
solver run without jit at 0.5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu.core import topology as jtopo
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu_torch.core import topology as ttopo
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.core.topology import synthetic_scenario
from kubernetes_rescheduling_tpu_torch.objectives import capacity_violation, communication_cost
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs


def jax_plan(key, cfg, S, N, *, inline):
    """The per-sweep plan from JAX's key stream (global_solver.py:655-666
    and :774-782)."""
    C = min(jgs.auto_chunk(S, cfg.chunk_size), S)
    n_chunks = -(-S // C)
    SP = n_chunks * C
    plans = []
    for sweep_key in jax.random.split(key, cfg.sweeps):
        perm_key, noise_key = jax.random.split(sweep_key)
        chunk_ids, block_rows = jgs.sweep_composition(
            perm_key, SP, C, n_chunks, block=jgs.COMPOSITION_BLOCK if inline else 1
        )
        chunk_keys = jax.random.split(noise_key, n_chunks)
        seeds = jax.random.randint(
            jax.random.fold_in(noise_key, 7), (n_chunks,), 0, 2**31 - 1
        )
        gumbel = np.stack([np.asarray(jax.random.gumbel(k, (C, N))) for k in chunk_keys])
        plans.append(tgs.SweepPlan(
            chunk_ids=torch.as_tensor(np.array(chunk_ids)),
            block_rows=torch.as_tensor(np.array(block_rows)),
            seeds=torch.as_tensor(np.array(seeds)),
            gumbel=torch.as_tensor(gumbel),
        ))
    return plans


@pytest.fixture(scope="module")
def scenarios():
    kw = dict(n_pods=256, n_nodes=128, seed=9, mean_degree=4.0)
    return jtopo.synthetic_scenario(**kw), synthetic_scenario(**kw, device="cpu")


@pytest.mark.parametrize("port_mode,jax_mode,extra", [
    ("off", "off", dict(noise_temp=0.0, balance_weight=0.0)),
    ("off", "off", dict(noise_temp=1.0, balance_weight=0.5)),
    ("on", "interpret", dict(noise_temp=0.0, balance_weight=0.5, chunk_size=256)),
    ("on", "interpret", dict(noise_temp=0.0, balance_weight=0.0, chunk_size=256)),
])
def test_solve_matches_jax(scenarios, port_mode, jax_mode, extra):
    j_scn, t_scn = scenarios
    key = jax.random.PRNGKey(4)
    base = dict(sweeps=3, **extra)
    j_cfg = jgs.GlobalSolverConfig(**base, fused_epilogue=jax_mode)
    j_state, j_info = jgs.global_assign(j_scn.state, j_scn.graph, key, j_cfg)
    inline = bool(j_info["inline_mass"])
    assert inline == (jax_mode == "interpret")
    plan = jax_plan(key, j_cfg, t_scn.graph.num_services, t_scn.state.num_nodes,
                    inline=inline)
    t_state, t_info = tgs.global_assign(
        t_scn.state, t_scn.graph, None,
        tgs.GlobalSolverConfig(**base, fused_epilogue=port_mode), plan=plan,
    )
    assert bool(t_info["inline_mass"]) == inline
    same = (t_state.pod_node.numpy() == np.asarray(j_state.pod_node)).mean()
    assert same >= 0.99
    assert float(t_info["objective_after"]) == pytest.approx(
        float(j_info["objective_after"]), rel=1e-3
    )
    assert float(t_info["objective_before"]) == pytest.approx(
        float(j_info["objective_before"]), rel=1e-6
    )
    np.testing.assert_array_equal(t_info["moves_per_sweep"].numpy(),
                                  np.asarray(j_info["moves_per_sweep"]))
    np.testing.assert_array_equal(t_info["swaps_per_sweep"].numpy(),
                                  np.asarray(j_info["swaps_per_sweep"]))


def test_off_path_matches_unjitted_jax(scenarios):
    """At balance_weight 0.5 with no noise the port equals the JAX solver
    run op by op (``jax.disable_jit``) decision for decision; only its
    jitted run, which fuses ``M - lam * pct`` into one multiply-add, breaks
    ties differently."""
    j_scn, t_scn = scenarios
    key = jax.random.PRNGKey(4)
    base = dict(sweeps=3, noise_temp=0.0, balance_weight=0.5)
    j_cfg = jgs.GlobalSolverConfig(**base, fused_epilogue="off")
    with jax.disable_jit():
        j_state, j_info = jgs.global_assign.__wrapped__(j_scn.state, j_scn.graph, key, j_cfg)
    t_state, t_info = tgs.global_assign(
        t_scn.state, t_scn.graph, None, tgs.GlobalSolverConfig(**base, fused_epilogue="off"),
        plan=jax_plan(key, j_cfg, 256, 128, inline=False),
    )
    np.testing.assert_array_equal(t_state.pod_node.numpy(), np.asarray(j_state.pod_node))
    assert float(t_info["objective_after"]) == float(j_info["objective_after"])


@pytest.mark.parametrize("scenario_fn,noise", [
    ("dense_200x20", 1.0), ("powerlaw_2000x200", 1.0), ("powerlaw_2000x200", 0.0),
])
def test_default_config_matches_jax_on_scenarios(scenario_fn, noise):
    """The default config (9 sweeps, swap every 3rd, bf16, noise 1.0 with
    plan-injected gumbel) on the named scenarios, plain path."""
    j_scn = getattr(jtopo, scenario_fn)(seed=0)
    t_scn = getattr(ttopo, scenario_fn)(seed=0, device="cpu")
    key = jax.random.PRNGKey(1)
    j_cfg = jgs.GlobalSolverConfig(noise_temp=noise, fused_epilogue="off")
    j_state, j_info = jgs.global_assign(j_scn.state, j_scn.graph, key, j_cfg)
    t_state, t_info = tgs.global_assign(
        t_scn.state, t_scn.graph, None,
        tgs.GlobalSolverConfig(noise_temp=noise, fused_epilogue="off"),
        plan=jax_plan(key, j_cfg, t_scn.graph.num_services, t_scn.state.num_nodes,
                      inline=False),
    )
    np.testing.assert_array_equal(t_state.pod_node.numpy(), np.asarray(j_state.pod_node))
    assert float(t_info["objective_after"]) == pytest.approx(
        float(j_info["objective_after"]), rel=1e-6)
    assert float(t_info["objective_after"]) <= float(t_info["objective_before"])


def test_generator_draws_deterministic_plans(scenarios):
    """Without a plan, the generator decides: same seed, same solve."""
    _, t_scn = scenarios
    cfg = tgs.GlobalSolverConfig(sweeps=2, chunk_size=64, fused_epilogue="on")
    a, ia = tgs.global_assign(t_scn.state, t_scn.graph, torch.Generator().manual_seed(3), cfg)
    b, ib = tgs.global_assign(t_scn.state, t_scn.graph, torch.Generator().manual_seed(3), cfg)
    assert torch.equal(a.pod_node, b.pod_node)
    assert float(ia["objective_after"]) == float(ib["objective_after"])
    off = dataclasses.replace(cfg, fused_epilogue="off")
    c, _ = tgs.global_assign(t_scn.state, t_scn.graph, torch.Generator().manual_seed(3), off)
    d, _ = tgs.global_assign(t_scn.state, t_scn.graph, torch.Generator().manual_seed(3), off)
    assert torch.equal(c.pod_node, d.pod_node)
    with pytest.raises(ValueError, match="generator"):
        tgs.global_assign(t_scn.state, t_scn.graph, None, cfg)
    with pytest.raises(ValueError, match="fused_epilogue"):
        tgs.global_assign(t_scn.state, t_scn.graph, torch.Generator(),
                          dataclasses.replace(cfg, fused_epilogue="interpret"))


def test_never_worse_than_input():
    scn = synthetic_scenario(n_pods=40, n_nodes=4, seed=11, device="cpu")
    before = float(communication_cost(scn.state, scn.graph))
    new_state, info = tgs.global_assign(
        scn.state, scn.graph, torch.Generator().manual_seed(0), tgs.GlobalSolverConfig(sweeps=4)
    )
    assert float(communication_cost(new_state, scn.graph)) <= before
    assert float(info["objective_after"]) <= float(info["objective_before"]) + 1e-5


@pytest.mark.parametrize("mode", ["off", "on"])
def test_respects_capacity(mode):
    scn = synthetic_scenario(
        n_pods=60, n_nodes=6, seed=5, node_cpu_cap_m=1500.0, imbalance_frac=0.5, device="cpu"
    )
    v_before = float(capacity_violation(scn.state))
    new_state, _ = tgs.global_assign(
        scn.state, scn.graph, torch.Generator().manual_seed(1),
        tgs.GlobalSolverConfig(sweeps=6, fused_epilogue=mode),
    )
    assert float(capacity_violation(new_state)) <= v_before + 1e-3


def deadlock_scenario():
    """Two full nodes; s0@n0 pairs with s2@n1, s1@n1 pairs with s3@n0: every
    improving single move busts a budget — only the s0<->s1 exchange works."""
    state = ClusterState.build(
        node_names=["n0", "n1"], node_cpu_cap=[200.0, 200.0], node_mem_cap=[1e9, 1e9],
        pod_services=[0, 1, 2, 3], pod_nodes=[0, 1, 1, 0], pod_cpu=[100.0] * 4,
        pod_mem=[1.0] * 4, device="cpu",
    )
    adj = torch.zeros((4, 4))
    adj[0, 2] = adj[2, 0] = adj[1, 3] = adj[3, 1] = 10.0
    return state, CommGraph(adj=adj, service_valid=torch.ones(4, dtype=torch.bool),
                            names=("s0", "s1", "s2", "s3"))


@pytest.mark.parametrize("noise", [0.0, 1.0])
def test_swap_phase_engages(noise):
    state, graph = deadlock_scenario()
    stuck = tgs.GlobalSolverConfig(sweeps=9, swap_every=0, noise_temp=noise, chunk_size=4)
    _, info = tgs.global_assign(state, graph, torch.Generator().manual_seed(0), stuck)
    assert float(info["objective_after"]) == 20.0
    cfg = dataclasses.replace(stuck, swap_every=1)
    new_state, info = tgs.global_assign(state, graph, torch.Generator().manual_seed(0), cfg)
    assert float(info["objective_after"]) == 0.0
    assert float(communication_cost(new_state, graph)) == 0.0
    assert int(info["swaps_per_sweep"].sum()) >= 1
    assert torch.all(new_state.node_cpu_used() <= new_state.node_cpu_cap + 1e-6)


def test_invalid_pods_untouched_and_split_replicas_kept():
    """Padding pods keep their node; a solve that finds nothing better
    leaves a split-replica input exactly as it was."""
    scn = synthetic_scenario(n_pods=30, n_nodes=5, seed=2, replicas=3, device="cpu")
    st = scn.state
    padded = ClusterState.build(
        node_names=list(st.node_names), node_cpu_cap=st.node_cpu_cap.tolist(),
        node_mem_cap=st.node_mem_cap.tolist(), pod_services=st.pod_service.tolist(),
        pod_nodes=st.pod_node.tolist(), pod_cpu=st.pod_cpu.tolist(),
        pod_mem=st.pod_mem.tolist(), pod_capacity=40, device="cpu",
    )
    new_state, info = tgs.global_assign(
        padded, scn.graph, torch.Generator().manual_seed(0), tgs.GlobalSolverConfig(sweeps=3)
    )
    assert torch.equal(new_state.pod_node[30:], padded.pod_node[30:])
    no_sweeps = tgs.GlobalSolverConfig(sweeps=0)
    same_state, info0 = tgs.global_assign(padded, scn.graph, torch.Generator(), no_sweeps)
    # without sweeps the only candidate is the first-pod collapse: adopted
    # only if strictly better, else the split input stays exactly as it was
    assert bool(info0["improved"]) or torch.equal(same_state.pod_node, padded.pod_node)


def test_prepared_weights_identical_solve(scenarios):
    _, t_scn = scenarios
    cfg = tgs.GlobalSolverConfig(sweeps=2, chunk_size=64, noise_temp=0.0)
    w = tgs.prepare_weights(t_scn.state, t_scn.graph, cfg)
    a, ia = tgs.global_assign(t_scn.state, t_scn.graph, torch.Generator().manual_seed(1), cfg)
    b, ib = tgs.global_assign(t_scn.state, t_scn.graph, torch.Generator().manual_seed(1), cfg,
                              w_mm=w)
    assert torch.equal(a.pod_node, b.pod_node)
    assert float(ia["objective_after"]) == float(ib["objective_after"])


def test_weight_budget_raises_clear_sizing_error(scenarios):
    _, t_scn = scenarios
    with pytest.raises(ValueError, match="max_weight_bytes"):
        tgs.global_assign(t_scn.state, t_scn.graph, torch.Generator(),
                          tgs.GlobalSolverConfig(max_weight_bytes=1024))


def test_move_cost_matches_jax(scenarios):
    """Disruption pricing through the whole solve, kernels' lowering."""
    j_scn, t_scn = scenarios
    key = jax.random.PRNGKey(2)
    base = dict(sweeps=2, noise_temp=0.0, balance_weight=0.5, chunk_size=256, move_cost=0.6)
    j_cfg = jgs.GlobalSolverConfig(**base, fused_epilogue="interpret")
    j_state, j_info = jgs.global_assign(j_scn.state, j_scn.graph, key, j_cfg)
    plan = jax_plan(key, j_cfg, 256, 128, inline=True)
    t_state, t_info = tgs.global_assign(
        t_scn.state, t_scn.graph, None, tgs.GlobalSolverConfig(**base, fused_epilogue="on"),
        plan=plan,
    )
    assert (t_state.pod_node.numpy() == np.asarray(j_state.pod_node)).mean() >= 0.99
    for k in ("objective_after", "move_penalty"):
        assert float(t_info[k]) == pytest.approx(float(j_info[k]), rel=1e-3)


@pytest.mark.parametrize("mode", ["auto", "on"])
def test_non_integer_weights_refuse_the_kernels_on_the_card(mode):
    """The dense mass kernel's unordered sums are exact only for integer
    pair weights: on CUDA a graph with other weights raises instead of
    solving; "off" and the CPU (ordered plain sums) still take it. The
    flag is recorded when the graph is built."""
    scn = synthetic_scenario(n_pods=60, n_nodes=6, seed=5, device="cpu")
    weighted = CommGraph(adj=scn.graph.adj * 0.75, service_valid=scn.graph.service_valid,
                         names=scn.graph.names)
    assert scn.graph.integral_weights and not weighted.integral_weights
    cfg = tgs.GlobalSolverConfig(sweeps=2, fused_epilogue=mode)
    cuda = torch.device("cuda")
    with pytest.raises(ValueError, match="integer pair weights"):
        tgs.kernel_lowering(cfg, cuda, weighted.integral_weights)
    assert tgs.kernel_lowering(cfg, cuda, scn.graph.integral_weights)
    off = dataclasses.replace(cfg, fused_epilogue="off")
    assert not tgs.kernel_lowering(off, cuda, weighted.integral_weights)
    for c in (cfg, off):
        _, info = tgs.global_assign(scn.state, weighted, torch.Generator().manual_seed(1), c)
        assert float(info["objective_after"]) <= float(info["objective_before"])
