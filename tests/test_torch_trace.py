"""The port's trace replay against the JAX package's ``bench/trace.py``.

The trace builders (``with_weights``, ``canary_trace``, ``load_trace``,
both ``drift_multipliers``) are host code and must give equal outputs. The
replays run the same random decisions in both packages — each step's sweep
plans built from the JAX key stream (``jax.random.split(key0, K)``, as
``_replay_run`` / ``_replay_sparse_run`` / ``replay`` split it) and handed
to the port — at K = 3 steps with ``balance_weight = 0``: the JAX replays
are jitted, and under jit XLA fuses ``M - lam * pct`` into one multiply-add
on the CPU, which breaks ties differently at a nonzero balance weight
(ROADMAP Queue 3). Bar: equal final placements; ``objs`` and ``befores``
within rel 1e-6 (f32 sums over the pairs associate differently in the two
packages, as in tests/test_torch_global_solver.py).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from test_torch_global_solver import jax_plan
from test_torch_sparse_solver import hub_instance, jax_sparse_plan

from kubernetes_rescheduling_tpu.bench import trace as jtr
from kubernetes_rescheduling_tpu.core import topology as jtopo
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu.telemetry.registry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu.utils.logging import StructuredLogger as JLogger
from kubernetes_rescheduling_tpu_torch import cli
from kubernetes_rescheduling_tpu_torch.bench import trace as ttr
from kubernetes_rescheduling_tpu_torch.core import topology as ttopo
from kubernetes_rescheduling_tpu_torch.solver import compiled
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs
from kubernetes_rescheduling_tpu_torch.solver import sparse_solver as tss
from kubernetes_rescheduling_tpu_torch.telemetry.registry import MetricsRegistry
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger

K = 3


def bookinfo(replicas=1):
    j_wm = jtr.bookinfo_workmodel(replicas)
    t_wm = ttr.bookinfo_workmodel(replicas)
    assert [dataclasses.astuple(s) for s in t_wm.services] == [
        dataclasses.astuple(s) for s in j_wm.services]
    assert t_wm.source == j_wm.source
    nodes = [f"worker{i}" for i in range(3)]
    j_state = jtopo.state_from_workmodel(j_wm, node_names=nodes, node_cpu_cap_m=20_000.0, seed=1)
    t_state = ttopo.state_from_workmodel(t_wm, node_names=nodes, node_cpu_cap_m=20_000.0,
                                         seed=1, device="cpu")
    return j_wm, t_wm, j_state, t_state


def test_with_weights_matches_jax_and_counts_unknown_refs():
    j_wm, t_wm, _, _ = bookinfo()
    updates = {("productpage", "reviews-v2"): 0.25, ("reviews-v3", "ratings"): 2.5,
               ("productpage", "nosuch"): 1.0, ("ghost", "ratings"): 3.0}
    j_reg, t_reg = JRegistry(), MetricsRegistry()
    j_log, t_log = JLogger(name="trace"), StructuredLogger(name="trace")
    j_g = jtr.with_weights(j_wm.comm_graph(), updates, registry=j_reg, logger=j_log)
    t_graph = t_wm.comm_graph(device="cpu")
    t_g = ttr.with_weights(t_graph, updates, registry=t_reg, logger=t_log)
    np.testing.assert_array_equal(t_g.adj.numpy(), np.asarray(j_g.adj))
    assert t_g.adj is not t_graph.adj and not torch.equal(t_g.adj, t_graph.adj)
    assert t_reg.value("trace_unknown_refs_total") == 2.0
    assert j_reg.counter("trace_unknown_refs_total").value == 2.0
    (j_rec,), (t_rec,) = j_log.records, t_log.records
    for k in ("level", "event", "dropped", "refs"):
        assert t_rec[k] == j_rec[k], k
    # a clean batch logs and counts nothing
    ttr.with_weights(t_graph, {("details", "productpage"): 1.0}, registry=t_reg, logger=t_log)
    assert t_reg.value("trace_unknown_refs_total") == 2.0 and len(t_log.records) == 1


@pytest.mark.parametrize("steps", [1, 2, 12])
def test_canary_trace_matches_jax(steps):
    j, t = jtr.canary_trace(steps), ttr.canary_trace(steps)
    assert [(s.t, s.weights) for s in t] == [(s.t, s.weights) for s in j]


def test_load_trace_matches_jax(tmp_path):
    path = tmp_path / "trace.jsonl"
    path.write_text(
        '{"t": 0.5, "weights": [["productpage", "reviews-v2", 0.9], ["a", "b", 2]]}\n'
        "\n"
        '{"weights": [["reviews-v3", "ratings", 0.1]]}\n'
        '{"t": 7}\n'
    )
    j, t = jtr.load_trace(path), ttr.load_trace(path)
    assert [(s.t, s.weights) for s in t] == [(s.t, s.weights) for s in j]
    assert [s.t for s in t] == [0.5, 1.0, 7.0]


@pytest.mark.parametrize("seed,sigma", [(0, 0.5), (3, 0.5), (5, 1.0)])
def test_drift_multipliers_match_jax(seed, sigma):
    kw = dict(n_pods=256, n_nodes=16, seed=2, powerlaw=True)
    j_scn, t_scn = jtopo.synthetic_scenario(**kw), ttopo.synthetic_scenario(**kw, device="cpu")
    j_out = jtr.drift_multipliers(j_scn.graph, 4, sigma=sigma, seed=seed)
    t_out = ttr.drift_multipliers(t_scn.graph, 4, sigma=sigma, seed=seed)
    for t, j in zip(t_out, j_out):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


def test_drift_multipliers_sparse_match_jax():
    j_state, j_graph, _, t_graph = hub_instance()
    j_sg, j_loc, j_m = jtr.drift_multipliers_sparse(j_graph, 4, seed=3)
    t_sg, t_loc, t_m = ttr.drift_multipliers_sparse(t_graph, 4, seed=3)
    np.testing.assert_array_equal(t_m, j_m)
    assert t_m.dtype == j_m.dtype and t_loc.canonical
    for name in ("edges_src", "edges_dst", "edges_w"):
        np.testing.assert_array_equal(getattr(t_sg, name).numpy(),
                                      np.asarray(getattr(j_sg, name)))
    np.testing.assert_array_equal(t_loc.base_w.numpy(), np.asarray(j_loc.base_w))


def step_keys(key0, steps):
    return jax.random.split(key0, steps)


@pytest.mark.parametrize("mode,jax_mode,noise", [("off", "off", 1.0), ("on", "interpret", 0.0)])
def test_replay_on_device_matches_jax(mode, jax_mode, noise):
    kw = dict(n_pods=256, n_nodes=32, seed=6, powerlaw=True)
    j_scn, t_scn = jtopo.synthetic_scenario(**kw), ttopo.synthetic_scenario(**kw, device="cpu")
    base = dict(sweeps=2, balance_weight=0.0, noise_temp=noise, chunk_size=256)
    j_cfg = jgs.GlobalSolverConfig(**base, fused_epilogue=jax_mode)
    cfg = tgs.GlobalSolverConfig(**base, fused_epilogue=mode)
    ii, jj, mults = jtr.drift_multipliers(j_scn.graph, K, seed=3)
    key0 = jax.random.PRNGKey(11)
    j_st, j_objs, j_bef = jtr.replay_on_device(j_scn.state, j_scn.graph, ii, jj, mults, key0,
                                               j_cfg)
    plans = [jax_plan(k, j_cfg, 256, 32, inline=mode == "on") for k in step_keys(key0, K)]
    t_st, t_objs, t_bef = ttr.replay_on_device(t_scn.state, t_scn.graph, ii, jj, mults,
                                               config=cfg, plans=plans)
    np.testing.assert_array_equal(t_st.pod_node.numpy(), np.asarray(j_st.pod_node))
    np.testing.assert_allclose(t_objs.numpy(), np.asarray(j_objs), rtol=1e-6)
    np.testing.assert_allclose(t_bef.numpy(), np.asarray(j_bef), rtol=1e-6)
    assert (t_objs <= t_bef).all() and t_objs.shape == (K,)
    # the replay leaves the graph it was given as it was
    assert torch.equal(t_scn.graph.adj, ttopo.synthetic_scenario(**kw, device="cpu").graph.adj)
    with compiled.eager():  # the eager body is the one every path runs
        e_st, e_objs, _ = ttr.replay_on_device(t_scn.state, t_scn.graph, ii, jj, mults,
                                               config=cfg, plans=plans)
    assert torch.equal(e_st.pod_node, t_st.pod_node) and torch.equal(e_objs, t_objs)


@pytest.mark.parametrize("mode,jax_mode,noise", [("off", "off", 1.0), ("on", "interpret", 0.0)])
def test_replay_on_device_sparse_matches_jax(mode, jax_mode, noise):
    j_state, j_graph, t_state, t_graph = hub_instance()
    base = dict(sweeps=2, balance_weight=0.0, noise_temp=noise, chunk_size=512)
    j_cfg = jgs.GlobalSolverConfig(**base, fused_epilogue=jax_mode)
    cfg = tgs.GlobalSolverConfig(**base, fused_epilogue=mode)
    j_sg, j_loc, mults = jtr.drift_multipliers_sparse(j_graph, K, seed=3)
    t_sg, t_loc, _ = ttr.drift_multipliers_sparse(t_graph, K, seed=3)
    key0 = jax.random.PRNGKey(12)
    j_st, j_objs, j_bef = jtr.replay_on_device_sparse(j_state, j_sg, j_loc, mults, key0, j_cfg)
    lay = tss.sparse_layout(t_sg, cfg)
    plans = [jax_sparse_plan(k, cfg.sweeps, lay, t_state.num_nodes) for k in step_keys(key0, K)]
    t_st, t_objs, t_bef = ttr.replay_on_device_sparse(t_state, t_sg, t_loc, mults,
                                                      config=cfg, plans=plans)
    np.testing.assert_array_equal(t_st.pod_node.numpy(), np.asarray(j_st.pod_node))
    np.testing.assert_allclose(t_objs.numpy(), np.asarray(j_objs), rtol=1e-6)
    np.testing.assert_allclose(t_bef.numpy(), np.asarray(j_bef), rtol=1e-6)
    assert (t_objs <= t_bef).all()


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_replay_on_device_restarts_pick_each_steps_best(kind):
    """``restarts=2``: every step is a best-of-2 over the same step body —
    the step's two one-restart replays from the previous step's placement,
    the lower ``objective_after`` adopted (the first on ties), with no
    host read between steps. Checked step by step against one-step
    single-restart replays of each plan (noise off: the plans differ in
    their compositions)."""
    cfg = tgs.GlobalSolverConfig(sweeps=2, balance_weight=0.0, noise_temp=0.0, chunk_size=512)
    gen = torch.Generator().manual_seed(4)
    if kind == "dense":
        t_scn = ttopo.synthetic_scenario(n_pods=256, n_nodes=32, seed=6, powerlaw=True,
                                         device="cpu")
        state = t_scn.state
        ii, jj, mults = ttr.drift_multipliers(t_scn.graph, 3, seed=3)
        lay = tgs.dense_layout(256, 32, cfg, "cpu")
        plans = [[tgs.draw_plans(gen, 2, lay.sp, lay.chunk, lay.n_chunks, 1) for _ in range(2)]
                 for _ in range(3)]

        def run(state, m, step_plans, restarts):
            return ttr.replay_on_device(state, t_scn.graph, ii, jj, m, config=cfg,
                                        plans=step_plans, restarts=restarts)
    else:
        _, _, state, t_graph = hub_instance()
        t_sg, t_loc, mults = ttr.drift_multipliers_sparse(t_graph, 3, seed=3)
        lay = tss.sparse_layout(t_sg, cfg)
        plans = [[tss.draw_sparse_plans(gen, 2, lay) for _ in range(2)] for _ in range(3)]

        def run(state, m, step_plans, restarts):
            return ttr.replay_on_device_sparse(state, t_sg, t_loc, m, config=cfg,
                                               plans=step_plans, restarts=restarts)
    final, objs, befs = run(state, mults, plans, 2)
    for k in range(3):
        outs = [run(state, mults[k:k + 1], [p], 1) for p in plans[k]]
        best = min(range(2), key=lambda i: float(outs[i][1][0]))
        assert float(objs[k]) == float(outs[best][1][0])
        state = outs[best][0]
    assert torch.equal(final.pod_node, state.pod_node)
    assert (objs <= befs).all()


def test_replay_on_device_sparse_refuses_single_block():
    scn = ttopo.synthetic_scenario(n_pods=120, n_nodes=6, seed=4, device="cpu")
    from kubernetes_rescheduling_tpu_torch.core.sparsegraph import from_comm_graph, trace_locator

    sg = from_comm_graph(scn.graph)
    with pytest.raises(ValueError, match="single-block"):
        ttr.replay_on_device_sparse(scn.state, sg, trace_locator(sg), np.ones((1, 1)),
                                    torch.Generator())


def jax_replay_plans(key, steps, cfg, S, N):
    """Each step's plan from ``replay``'s key stream: ``key, sub = split(key)``."""
    plans = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        plans.append(jax_plan(sub, cfg, S, N, inline=False))
    return plans


def test_replay_matches_jax():
    """The host-side replay over the canary trace on Bookinfo (2 replicas a
    service, so split placements enter the first step), record for record."""
    j_wm, t_wm, j_state, t_state = bookinfo(replicas=2)
    trace = jtr.canary_trace(6)
    base = dict(sweeps=4, balance_weight=0.0)
    key = jax.random.PRNGKey(3)
    j_final, j_recs = jtr.replay(j_state, j_wm.comm_graph(), trace, key=key,
                                 config=jgs.GlobalSolverConfig(**base))
    plans = jax_replay_plans(key, len(trace), jgs.GlobalSolverConfig(**base),
                             len(t_wm.services), 3)
    t_trace = ttr.canary_trace(6)
    t_final, t_recs = ttr.replay(t_state, t_wm.comm_graph(device="cpu"), t_trace,
                                 config=tgs.GlobalSolverConfig(**base), plans=plans)
    np.testing.assert_array_equal(t_final.pod_node.numpy(), np.asarray(j_final.pod_node))
    assert len(t_recs) == len(j_recs) == 6
    for t, j in zip(t_recs, j_recs):
        assert (t.t, t.moves) == (j.t, j.moves)
        for f in ("cost_before_solve", "cost_after_solve", "load_std_before", "load_std_after"):
            assert getattr(t, f) == pytest.approx(getattr(j, f), rel=1e-6, abs=1e-6), f


def test_replay_warns_and_runs_restarts_as_jax():
    """An unknown service in a step warns; ``replay(restarts=2)`` makes each
    step a best-of-2 and, fed the JAX replay's per-restart plans
    (``split(sub, 2)`` of each step's key), equals its records."""
    j_wm, t_wm, j_state, t_state = bookinfo(replicas=2)
    graph = t_wm.comm_graph(device="cpu")
    trace = [ttr.TraceStep(t=0.0, weights={("productpage", "nowhere"): 1.0})]
    with pytest.warns(UserWarning, match="nowhere"):
        _, recs = ttr.replay(t_state, graph, trace, generator=torch.Generator().manual_seed(0))
    assert len(recs) == 1
    base = dict(sweeps=4, balance_weight=0.0)
    key = jax.random.PRNGKey(5)
    j_final, j_recs = jtr.replay(j_state, j_wm.comm_graph(), jtr.canary_trace(4), key=key,
                                 config=jgs.GlobalSolverConfig(**base), restarts=2)
    plans, k = [], key
    for _ in range(4):
        k, sub = jax.random.split(k)
        plans.append([jax_plan(r, jgs.GlobalSolverConfig(**base), len(t_wm.services), 3,
                               inline=False) for r in jax.random.split(sub, 2)])
    t_final, t_recs = ttr.replay(t_state, graph, ttr.canary_trace(4),
                                 config=tgs.GlobalSolverConfig(**base), restarts=2, plans=plans)
    np.testing.assert_array_equal(t_final.pod_node.numpy(), np.asarray(j_final.pod_node))
    for t, j in zip(t_recs, j_recs, strict=True):
        assert (t.t, t.moves) == (j.t, j.moves)
        for f in ("cost_before_solve", "cost_after_solve", "load_std_before", "load_std_after"):
            assert getattr(t, f) == pytest.approx(getattr(j, f), rel=1e-6, abs=1e-6), f
    # observed_step is ported (ROADMAP item 4.4): the load generator's
    # observed pair weights as a trace step
    from kubernetes_rescheduling_tpu_torch.bench.loadgen import LoadGenConfig, LoadGenerator

    gen = LoadGenerator(t_wm, LoadGenConfig(entry_service="productpage",
                                            requests_per_phase=64, chunk=64), device="cpu")
    samples = gen.run(t_state, 0)
    step = ttr.observed_step(2.0, gen, samples)
    assert step.t == 2.0
    assert step.weights == gen.observed_weights(samples.edge_counts, samples.sent)
    assert step.weights[("details", "productpage")] == 1.0


def test_trace_cli_on_the_cpu(capsys, tmp_path):
    assert cli.main(["trace", "--steps", "5", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["workmodel"] == "builtin:bookinfo" and out["trace"] == "builtin:canary[5]"
    assert len(out["steps"]) == 5 and out["restarts"] == 1
    assert out["total_moves"] == sum(s["moves"] for s in out["steps"])
    assert out["final_cost"] == out["steps"][-1]["cost_after_solve"]
    assert set(out["steps"][0]) == {f.name for f in dataclasses.fields(ttr.ReplayRecord)}
    path = tmp_path / "t.jsonl"
    path.write_text('{"t": 1, "weights": [["productpage", "details", 4.0]]}\n')
    assert cli.main(["trace", "--trace", str(path), "--capacity-frac", "0.9",
                     "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["trace"] == str(path) and len(out["steps"]) == 1
    assert cli.main(["trace", "--device", "cpu", "--steps", "3", "--restarts", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["restarts"] == 2 and len(out["steps"]) == 3
    # --trace-out / --metrics-out write the spans (one trace/step span a
    # step), the registry and the run manifest
    trace_out, metrics_out = tmp_path / "x.json", tmp_path / "m.jsonl"
    assert cli.main(["trace", "--device", "cpu", "--steps", "3", "--trace-out", str(trace_out),
                     "--metrics-out", str(metrics_out)]) == 0
    capsys.readouterr()
    names = [e["name"] for e in json.loads(trace_out.read_text())["traceEvents"]]
    assert names.count("trace/step") >= 3
    assert metrics_out.read_text() and metrics_out.with_suffix(".prom").read_text()
    assert json.loads(metrics_out.with_suffix(".manifest.json").read_text())["config"][
        "command"] == "trace"
