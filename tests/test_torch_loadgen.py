"""The port's request-level load generator (``bench/loadgen.py``) against
the JAX package's, on the CPU.

- Every non-slow case of tests/test_loadgen.py runs on the port: the JAX
  test's own function re-bound to the port's names (``test_torch_slo.
  on_port``); its ``jax.random.PRNGKey(k)`` becomes the port's integer seed
  ``k`` and ``fold_in`` the port's ``derive_seed``, so each case holds the
  statistical property it states on the port's own stream. The one case
  that imports the JAX solver inside its body is rewritten here on the
  port's solver.
- Parity on jax's own draws: ``build_call_plan`` equal on µBench, a cyclic
  mesh and ``large``; the request chunk, fed the five draws the JAX kernel
  draws from ``split(fold_in(key, chunk), 5)``, gives every request's ok /
  outage / overload flag and every edge count exactly, and its latency
  within ``LATENCY_REL``; ``observed_weights`` and ``observed_graph``
  exactly.
- The chunk is deterministic: two runs on the same draws give equal bits.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_loadgen as jcases
import torch
from test_torch_slo import on_port, run_case

from kubernetes_rescheduling_tpu.bench import harness as jh
from kubernetes_rescheduling_tpu.bench import loadgen as jl
from kubernetes_rescheduling_tpu.core.state import ClusterState as JState
from kubernetes_rescheduling_tpu.core.topology import _random_workmodel as j_random_wm
from kubernetes_rescheduling_tpu_torch._random import derive_seed
from kubernetes_rescheduling_tpu_torch.backends.sim import SimBackend as TSim
from kubernetes_rescheduling_tpu_torch.bench import harness as th
from kubernetes_rescheduling_tpu_torch.bench import loadgen as tl
from kubernetes_rescheduling_tpu_torch.bench import trace as ttrace
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState as TState
from kubernetes_rescheduling_tpu_torch.core.topology import _random_workmodel as t_random_wm
from kubernetes_rescheduling_tpu_torch.core.topology import state_from_workmodel
from kubernetes_rescheduling_tpu_torch.core.workmodel import ServiceSpec as TSpec
from kubernetes_rescheduling_tpu_torch.core.workmodel import Workmodel as TWorkmodel
from kubernetes_rescheduling_tpu_torch.core.workmodel import mubench_workmodel_c
from kubernetes_rescheduling_tpu_torch.solver import GlobalSolverConfig, global_assign

# the latency of one request, port against JAX on the same draws: XLA's and
# torch's CPU f32 exp, log1p and division may differ by an ulp, and a
# latency is a product and sum of up to depth + 2 such terms
LATENCY_REL = 1e-5


class _State:
    """``ClusterState`` with the port's ``build`` on the CPU."""

    @staticmethod
    def build(**kw):
        return TState.build(device="cpu", **kw)


class _Workmodel(TWorkmodel):
    """The port's ``Workmodel`` whose graph lands on the CPU by default."""

    def comm_graph(self, device="cpu", **kw):
        return super().comm_graph(device=device, **kw)


PORT_NAMES = {
    "LoadGenConfig": tl.LoadGenConfig,
    "LoadGenerator": lambda *a, **kw: tl.LoadGenerator(*a, device="cpu", **kw),
    "build_call_plan": tl.build_call_plan,
    "new_samples": tl.new_samples,
    "ClusterState": _State,
    "SimBackend": lambda **kw: TSim(device="cpu", **kw),
    "ServiceSpec": TSpec,
    "Workmodel": _Workmodel,
    "mubench_workmodel_c": mubench_workmodel_c,
    # seeds stand for jax keys
    "jax": types.SimpleNamespace(random=types.SimpleNamespace(
        PRNGKey=lambda s: int(s), fold_in=lambda k, i: derive_seed(k, i))),
}
LEFT_OUT = {
    "test_constant_extremes_preserve_policy_ordering",           # slow in the JAX package
    "test_estimated_weights_beat_declared_on_measured_latency",  # below, on the port's solver
}
CASES = sorted(n for n, v in vars(jcases).items()
               if n.startswith("test_") and callable(v) and n not in LEFT_OUT)
PORT_CASES = on_port(jcases, PORT_NAMES)


@pytest.mark.parametrize("case", CASES)
def test_loadgen_case_on_port(case):
    run_case(PORT_CASES, case, {})


def test_estimated_weights_beat_declared_on_measured_latency():
    """tests/test_loadgen.py's case on the port's solver: when the declared
    topology and the actual traffic disagree, the solve on estimated weights
    gives a faster placement than the solve on declared ones."""
    wm = TWorkmodel(services=(TSpec(name="s0", callees=("s1", "s2")), TSpec(name="s1"),
                              TSpec(name="s2")))
    declared = ttrace.with_weights(wm.comm_graph(device="cpu"), {("s0", "s1"): 3.0})
    gen = tl.LoadGenerator(
        wm, tl.LoadGenConfig(requests_per_phase=4096, chunk=1024, jitter_sigma=0.0,
                             entry_service="s0"),
        edge_probs={("s0", "s1"): 0.05, ("s0", "s2"): 1.0}, device="cpu")
    state = state_from_workmodel(wm, node_names=["n0", "n1"], node_cpu_cap_m=20_000.0, seed=3,
                                 device="cpu")
    cfg = GlobalSolverConfig(sweeps=4, noise_temp=0.0, enforce_capacity=True,
                             capacity_frac=0.011)
    st_declared, _ = global_assign(state, declared, torch.Generator().manual_seed(0), cfg)
    samples = gen.run(state, 1)
    estimated = gen.observed_graph(samples.edge_counts, samples.sent, declared)
    st_estimated, _ = global_assign(state, estimated, torch.Generator().manual_seed(0), cfg)

    def node_of(st, svc):
        ps, pn = st.pod_service.numpy(), st.pod_node.numpy()
        return int(pn[np.flatnonzero(ps == svc)[0]])

    assert node_of(st_declared, 0) == node_of(st_declared, 1)
    assert node_of(st_estimated, 0) == node_of(st_estimated, 2)
    assert gen.measure(st_estimated, 2).latency_avg_ms < gen.measure(st_declared, 2).latency_avg_ms


# ---------------- parity on jax's draws ----------------


def jax_draws(key, chunk: int, S: int, E: int):
    """The five draws the JAX chunk of index ``i`` makes inside its jit,
    from ``split(fold_in(key, i), 5)``, as CPU tensors (the ``draws=``
    seam)."""
    def draws(i):
        k_rep, k_t, k_jit, k_drop, k_edge = jax.random.split(jax.random.fold_in(key, i), 5)
        out = (jax.random.uniform(k_rep, (chunk, S)), jax.random.uniform(k_t, (chunk,)),
               jax.random.normal(k_jit, (chunk,)), jax.random.uniform(k_drop, (chunk,)),
               jax.random.uniform(k_edge, (chunk, E)))
        return tuple(torch.from_numpy(np.array(x)) for x in out)
    return draws


@pytest.mark.parametrize("name", ["mubench", "cyclic", "large"])
def test_call_plan_equals_jax(name):
    if name == "mubench":
        wm = mubench_workmodel_c()
        rel, names = wm.directed_relation(), wm.names
    elif name == "cyclic":
        # a mesh with cycles and a dangling callee: the cycle-breaking rule
        rel = {"a": ["b", "x"], "b": ["c", "d"], "c": ["a", "d"], "d": ["b"], "e": ["a"]}
        names = ("a", "b", "c", "d", "e")
    else:
        wm = t_random_wm(10_000, np.random.default_rng(0), powerlaw=True, mean_degree=4.0)
        jwm = j_random_wm(10_000, np.random.default_rng(0), powerlaw=True, mean_degree=4.0)
        assert wm.directed_relation() == jwm.directed_relation()
        rel, names = wm.directed_relation(), wm.names
    entry = "a" if name == "cyclic" else "s0"
    t, j = tl.build_call_plan(rel, names, entry), jl.build_call_plan(rel, names, entry)
    assert t.names == j.names and t.entry == j.entry and t.depth == j.depth
    for f in ("src", "dst", "reach"):
        assert np.array_equal(getattr(t, f), getattr(j, f)) and getattr(t, f).dtype == \
            getattr(j, f).dtype, f
    if name == "large":
        assert (len(t.src), t.depth, int(t.reach.sum())) == (19_997, 21, 10_000)


def powerlaw_instance():
    """A 200-service power-law mesh on 8 nodes (seeded placement), with
    service 199 unplaced, node 3 driven to 105% CPU, and services 1 and 5
    under outage windows: every error path at once."""
    rng = np.random.default_rng(5)
    jwm = j_random_wm(200, np.random.default_rng(1), powerlaw=True, mean_degree=4.0)
    twm = t_random_wm(200, np.random.default_rng(1), powerlaw=True, mean_degree=4.0)
    S = 200
    pods = [(s, r) for s in range(S) for r in range(1 + s % 3)]
    nodes = rng.integers(0, 8, len(pods))
    nodes[[i for i, (s, _) in enumerate(pods) if s == 199]] = -1
    cpu = np.where(nodes == 3, 10_500.0 / (nodes == 3).sum(), 40.0)
    kw = dict(node_names=[f"n{i}" for i in range(8)], node_cpu_cap=[10_000.0] * 8,
              node_mem_cap=[2.0**30] * 8, node_alive=[True] * 8,
              pod_services=[s for s, _ in pods], pod_nodes=nodes.tolist(),
              pod_cpu=cpu.tolist(), pod_mem=[0.0] * len(pods),
              pod_names=[f"s{s}-{r}" for s, r in pods])
    outages = [("s1", 20.0, 80.0), ("s5", 0.0, 30.0)]
    return (jwm, JState.build(**kw)), (twm, TState.build(device="cpu", **kw)), outages


def mubench_instance():
    jb, tb = jh.make_backend("mubench", 1), th.make_backend("mubench", 1, device="cpu")
    jb.inject_imbalance(jb.node_names[0])
    tb.inject_imbalance(tb.node_names[0])
    return ((jb.workmodel, jb.monitor()), (tb.workmodel, tb.monitor()),
            [("s3", 10.0, 40.0)], jb.load.fanout_frac)


@pytest.mark.parametrize("instance", ["mubench", "powerlaw"])
def test_request_chunk_equals_jax_on_its_draws(instance):
    if instance == "mubench":
        (jwm, jst), (twm, tst), outages, fanout = mubench_instance()
    else:
        (jwm, jst), (twm, tst), outages = powerlaw_instance()
        fanout = 0.5
    chunk = 512
    jg = jl.LoadGenerator(jwm, jl.LoadGenConfig(chunk=chunk), fanout_frac=fanout)
    tg = tl.LoadGenerator(twm, tl.LoadGenConfig(chunk=chunk), fanout_frac=fanout, device="cpu")
    S, E = tg.plan.num_services, len(tg.plan.src)
    key = jax.random.PRNGKey(11)
    draws = jax_draws(key, chunk, S, E)
    # the JAX chunk's inputs, as its run() binds them
    nodes, counts = jg._placement_arrays(jst)
    t_nodes, t_counts = tg._placement_arrays(tst)
    assert np.array_equal(nodes, t_nodes) and np.array_equal(counts, t_counts)
    outage = np.zeros((S, 2), np.float32)
    for svc, a, b in outages:
        outage[tg._svc_index[svc]] = (a / 180.0, b / 180.0)
    rho = np.asarray(jst.node_cpu_pct(), dtype=np.float32) / 100.0
    n_valid = chunk - 37  # a partial chunk: padding rows count no edge
    j_out = jl._request_chunk(
        jax.random.fold_in(key, 0), jg._src, jg._dst, jg._entry, jg._proc_ms,
        jnp.asarray(nodes), jnp.asarray(counts), jnp.asarray(rho), jnp.asarray(outage),
        jg._edge_p, jnp.asarray(n_valid, jnp.int32), jg._cfg_vec, depth=jg.plan.depth,
        chunk=chunk)
    head = (tg._src, tg._dst, tg.plan.entry, tg._proc_ms,
            torch.from_numpy(nodes.astype(np.int64)), torch.from_numpy(counts),
            tst.node_cpu_pct().float() / 100.0, torch.from_numpy(outage), tg._edge_p)
    t_out = tl.request_chunk(draws(0), *head, n_valid, tg._cfg_vec, depth=tg.plan.depth)
    again = tl.request_chunk(draws(0), *head, n_valid, tg._cfg_vec, depth=tg.plan.depth)
    for a, b in zip(t_out, again):
        assert torch.equal(a, b)  # deterministic: equal bits on equal draws
    j_lat, t_lat = np.asarray(j_out[0]), t_out[0].numpy()
    np.testing.assert_allclose(t_lat, j_lat, rtol=LATENCY_REL, atol=0)
    for name, j, t in zip(("ok", "err_outage", "err_overload", "edge_count"), j_out[1:],
                          t_out[1:]):
        assert np.array_equal(np.asarray(j), t.numpy()), name
    # every path is exercised on the power-law instance
    ok, e_out, e_over = (t.numpy() for t in t_out[1:4])
    assert ok.any() and e_out.any()
    if instance == "powerlaw":
        assert e_over.any()
    # the whole phase through run(): the same stats and edge counts
    js = jg.run(jst, key, outages=outages, n_requests=1500)
    ts = tg.run(tst, 0, outages=outages, n_requests=1500, draws=draws)
    a, b = js.stats().as_dict(), ts.stats().as_dict()
    for k in a:
        if k.startswith("latency_"):
            assert b[k] == pytest.approx(a[k], rel=LATENCY_REL), k
        else:
            assert b[k] == a[k], k
    assert np.array_equal(js.edge_counts, ts.edge_counts)


def test_observed_weights_and_graph_equal_jax():
    (jwm, jst), (twm, tst), outages, fanout = mubench_instance()
    jg = jl.LoadGenerator(jwm, jl.LoadGenConfig(requests_per_phase=2048), fanout_frac=fanout,
                          edge_probs={("s0", "s3"): 0.2})
    tg = tl.LoadGenerator(twm, tl.LoadGenConfig(requests_per_phase=2048), fanout_frac=fanout,
                          edge_probs={("s0", "s3"): 0.2}, device="cpu")
    key = jax.random.PRNGKey(4)
    js = jg.run(jst, key, outages=outages)
    ts = tg.run(tst, 0, outages=outages,
                draws=jax_draws(key, tg.cfg.chunk, tg.plan.num_services, len(tg.plan.src)))
    assert np.array_equal(js.edge_counts, ts.edge_counts)
    assert tg.observed_weights(ts.edge_counts, ts.sent) == jg.observed_weights(
        js.edge_counts, js.sent)
    for prior in (50.0, 0.0):
        j_graph = jg.observed_graph(js.edge_counts, js.sent, jwm.comm_graph(),
                                    prior_requests=prior)
        base = twm.comm_graph(device="cpu")
        t_graph = tg.observed_graph(ts.edge_counts, ts.sent, base, prior_requests=prior)
        assert t_graph.names == j_graph.names
        assert np.array_equal(t_graph.adj.numpy(), np.asarray(j_graph.adj))
        # the declared pairs are enumerated once per graph object
        assert tg._declared_cache[0] is base
    assert tg.observed_graph(None, 0, base) is base


def test_chunk_generators_depend_on_seed_and_chunk_only():
    wm = mubench_workmodel_c()
    gen = tl.LoadGenerator(wm, tl.LoadGenConfig(requests_per_phase=300, chunk=128),
                           device="cpu")
    a = tl.draw_chunk(128, 20, 19, gen.chunk_generator(5, 2), torch.device("cpu"))
    b = tl.draw_chunk(128, 20, 19, gen.chunk_generator(5, 2), torch.device("cpu"))
    c = tl.draw_chunk(128, 20, 19, gen.chunk_generator(5, 3), torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert [x.shape for x in a] == [(128, 20), (128,), (128,), (128,), (128, 19)]


def test_outage_windows_refuse_duplicates_and_rate_profile_is_the_elastic_one():
    from kubernetes_rescheduling_tpu_torch.elastic import rates

    wm = mubench_workmodel_c()
    b = TSim(workmodel=wm, node_names=["w1", "w2", "w3"], seed=0, device="cpu")
    gen = tl.LoadGenerator(wm, tl.LoadGenConfig(requests_per_phase=64, chunk=64),
                           device="cpu")
    with pytest.raises(ValueError, match="multiple outage windows"):
        gen.run(b.monitor(), 0, outages=[("s1", 0.0, 1.0), ("s1", 2.0, 3.0)])
    assert tl.RateProfile is rates.RateProfile
    assert tl.service_rate_series is rates.service_rate_series


def test_loadgen_runs_on_the_card_or_raises():
    wm = mubench_workmodel_c()
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py's loadgen_large runs the chunk there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.LoadGenerator(wm)
