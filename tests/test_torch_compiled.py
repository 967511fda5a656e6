"""The compiled solve on the CPU: the score kernels' seed and temperature
passed as one-element tensors (as a captured solve passes them, from its
device tables) against the JAX package's Pallas kernels in interpret mode
with noise on, and the solve bodies that the capture cache records read
nothing back to the host.

A CUDA graph cannot be captured here; ``chip_smoke.py``'s ``solve_captured``
phase holds the captured solves against ``eager()`` on the card. What the
CPU can show is that a body is capturable: no call in it reads a tensor's
value on the host (a read inside a capture fails on the card). The test
below makes every such read raise while a body runs.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_global_solver import jax_plan
from test_torch_ops import as_jax, as_torch, score_edge_instance
from test_torch_sparse_ops import regular_instance, score_operands, slabs
from test_torch_sparse_solver import hub_instance, jax_sparse_plan

from kubernetes_rescheduling_tpu.core import topology as jtopo
from kubernetes_rescheduling_tpu.ops import fused_admission as jfa
from kubernetes_rescheduling_tpu.ops import sparse_mass as jsm
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu.solver import sparse_solver as jss
from kubernetes_rescheduling_tpu_torch.bench import trace as ttrace
from kubernetes_rescheduling_tpu_torch.core.sparsegraph import BLOCK_R
from kubernetes_rescheduling_tpu_torch.core.topology import synthetic_scenario
from kubernetes_rescheduling_tpu_torch.ops import fused_admission as tfa
from kubernetes_rescheduling_tpu_torch.ops import sparse_mass as tsm
from kubernetes_rescheduling_tpu_torch.solver import compiled
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs
from kubernetes_rescheduling_tpu_torch.solver import pod_mode as tpm
from kubernetes_rescheduling_tpu_torch.solver import sparse_solver as tss

SEED, TEMP = 9, 0.7


def scalars(kind):
    """The seed and temperature as the wrappers take them: Python numbers,
    or one-element tensors (i32 and f32, 0-d or of shape [1])."""
    if kind == "host":
        return TEMP, SEED
    shape = () if kind == "tensor" else (1,)
    return (torch.full(shape, TEMP, dtype=torch.float32),
            torch.full(shape, SEED, dtype=torch.int32))


@pytest.mark.parametrize("kind", ["tensor", "tensor[1]"])
@pytest.mark.parametrize("N", [20, 257])
@pytest.mark.parametrize("use_move_pen", [False, True])
def test_device_scalars_match_jax_score(kind, N, use_move_pen):
    """Noise on, seed and temperature as tensors: the port's chunk step
    equals the JAX package's score and admission kernels (interpret mode,
    the stateless mixer) exactly, and equals the same step given numbers."""
    C = 64
    args, _ = score_edge_instance(N, C, N)
    M, cur, home, pen, c_cpu, c_mem, valid, *nodes = args
    extra = dict(home=home, move_pen=pen) if use_move_pen else {}
    kw = dict(block_c=48, enforce_capacity=True, use_noise=True)
    j_out = jfa.fused_score_admission(
        *as_jax([M, cur, c_cpu, c_mem, valid, *nodes]), 0.5, TEMP, SEED, 10.0,
        **{k: jnp.asarray(v) for k, v in extra.items()}, interpret=True,
        noise_impl="stateless", x_dtype=jnp.float32, **kw,
    )
    t_args = as_torch([M, cur, c_cpu, c_mem, valid, *nodes])
    t_extra = {k: torch.as_tensor(v) for k, v in extra.items()}
    temp, seed = scalars(kind)
    t_out = tfa.fused_score_admission(*t_args, 0.5, temp, seed, 10.0, **t_extra,
                                      x_dtype=torch.float32, **kw)
    host = tfa.fused_score_admission(*t_args, 0.5, TEMP, SEED, 10.0, **t_extra,
                                     x_dtype=torch.float32, **kw)
    for t, j, h in zip(t_out, j_out, host):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert torch.equal(t, h)


@pytest.mark.parametrize("move_pen", [False, True])
def test_device_scalars_match_jax_sparse_mass_score(move_pen):
    """Kernel 6's plain version with the seed and temperature as tensors,
    noise on, against the JAX package's fused kernel in interpret mode;
    the gain within atol 1e-5 (XLA's CPU ``logf`` and PyTorch's differ by
    one ulp on some inputs: tests/test_torch_sparse_ops.py), everything
    else exactly."""
    jg, tg, assign, rv, rvu, toff = regular_instance(seed=3)
    blocks = np.asarray([1, 2], np.int32)
    C, N = 2 * BLOCK_R, 16
    ids = (blocks[:, None] * BLOCK_R + np.arange(BLOCK_R)).reshape(-1)
    tgt_c, rvu_c = slabs(tg, assign, rvu, toff, blocks)
    rows = list(score_operands(1 + 2 * int(move_pen), C, N))
    if not move_pen:
        rows[1], rows[2] = rows[0], None
    cur, home, pen, *rest = rows
    kw = dict(num_nodes=N, bu=tg.bu, reg_tiles=tg.reg_tiles, enforce_capacity=True,
              use_noise=True)

    def jx(a):
        return None if a is None else jnp.asarray(a)

    def tx(a):
        return None if a is None else torch.as_tensor(a)

    want = jsm.sparse_mass_score(
        jg.w_local.astype(jnp.bfloat16), jx(tgt_c), jx(rvu_c), jx(blocks), jx(toff),
        jx(rv[ids]), jx(cur), jx(home), jx(pen), *map(jx, rest), 0.5, TEMP, SEED, 10.0,
        interpret=True, noise_impl="stateless", **kw,
    )
    temp, seed = scalars("tensor")
    got = tsm.sparse_mass_score(
        tg.w_local.to(torch.bfloat16), tx(tgt_c), tx(rvu_c), tx(blocks), tx(toff),
        tx(rv[ids]), tx(cur), tx(home), tx(pen), *map(tx, rest), 0.5, temp, seed, 10.0, **kw,
    )
    for name, g, w in zip(("prop", "gain", "wants", "slack_cpu", "slack_mem"), got, want):
        w = np.asarray(w).reshape(-1)
        if name == "gain":
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_device_scalar_checks():
    """A kernel scalar is one value on the kernel's device; a seed keeps its
    u32 bits whichever way it comes."""
    cpu = torch.device("cpu")
    assert int(tfa._device_scalar(torch.tensor([7]), torch.int32, cpu)) == 7
    assert int(tfa._device_scalar(2**32 - 1, torch.int32, cpu)) == -1
    assert tfa._device_scalar(0.5, torch.float32, cpu).dtype == torch.float32
    with pytest.raises(ValueError, match="one value"):
        tfa._device_scalar(torch.zeros(2), torch.float32, cpu)
    u_int = tfa._stateless_uniform(2**31 + 5, (3, 4))
    u_tensor = tfa._stateless_uniform(tfa._device_scalar(2**31 + 5, torch.int32, cpu), (3, 4))
    assert torch.equal(u_int, u_tensor)


class HostRead(AssertionError):
    pass


@contextlib.contextmanager
def no_host_reads():
    """Every way a tensor's value reaches the host raises inside."""
    def refuse(self, *a, **k):
        raise HostRead("a solve body read a tensor back to the host")

    names = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    try:
        for n in names:
            setattr(torch.Tensor, n, refuse)
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


@pytest.mark.parametrize("read", ["bool", "float", "item", "tolist", "index", "numpy"])
def test_guard_catches_a_host_read(read):
    x = torch.tensor([1.0, 2.0])
    reads = {"bool": lambda: bool(x[0]), "float": lambda: float(x[0]),
             "item": lambda: x[0].item(), "tolist": lambda: x.tolist(),
             "index": lambda: [0, 1][torch.tensor(1)], "numpy": lambda: x.numpy()}
    with pytest.raises(HostRead), no_host_reads():
        reads[read]()
    assert bool(x[0])  # restored


@pytest.fixture
def guarded_bodies(monkeypatch):
    """Run every solve body through the capture cache's seam with host
    reads refused; ``make_body`` (set-up before a capture) may read."""
    calls = []

    def run(self, fn, key, inputs, make_body, operands=()):
        body = make_body()
        calls.append(fn)
        with no_host_reads():
            return body(inputs)

    monkeypatch.setattr(compiled.GraphCache, "run", run)
    return calls


@pytest.mark.parametrize("mode,extra", [
    ("on", dict(chunk_size=256)),                      # inline mass
    ("on", dict(chunk_size=64, move_cost=0.5)),        # materialized, pricing
    ("off", dict(noise_temp=1.0, balance_weight=0.5)),  # plain, drawn noise
])
def test_dense_body_reads_nothing_back(guarded_bodies, mode, extra):
    scn = synthetic_scenario(n_pods=256, n_nodes=32, seed=4, replicas=2, device="cpu")
    cfg = tgs.GlobalSolverConfig(sweeps=3, fused_epilogue=mode, **extra)
    _, info = tgs.global_assign(scn.state, scn.graph, torch.Generator().manual_seed(0), cfg)
    assert guarded_bodies == ["global_assign"]
    assert float(info["objective_after"]) <= float(info["objective_before"])


@pytest.mark.parametrize("mode", ["on", "off"])
def test_sparse_body_reads_nothing_back(guarded_bodies, mode):
    _, _, t_state, t_graph = hub_instance()
    cfg = tgs.GlobalSolverConfig(sweeps=3, chunk_size=512, fused_epilogue=mode)
    _, info = tss.global_assign_sparse(t_state, t_graph, torch.Generator().manual_seed(0), cfg)
    assert guarded_bodies == ["global_assign_sparse"]
    assert bool(info["hub_pass"])


def test_replay_bodies_read_nothing_back(guarded_bodies):
    scn = synthetic_scenario(n_pods=256, n_nodes=32, seed=4, device="cpu")
    cfg = tgs.GlobalSolverConfig(sweeps=2, chunk_size=256, fused_epilogue="on")
    ii, jj, mults = ttrace.drift_multipliers(scn.graph, 2, seed=3)
    ttrace.replay_on_device(scn.state, scn.graph, ii, jj, mults,
                            torch.Generator().manual_seed(0), cfg)
    _, _, t_state, t_graph = hub_instance()
    sg2, loc, mults = ttrace.drift_multipliers_sparse(t_graph, 2, seed=3)
    ttrace.replay_on_device_sparse(t_state, sg2, loc, mults, torch.Generator().manual_seed(0),
                                   tgs.GlobalSolverConfig(sweeps=2, chunk_size=512))
    assert guarded_bodies == ["replay_on_device"] * 2 + ["replay_on_device_sparse"] * 2


def test_pod_replay_body_reads_nothing_back(guarded_bodies):
    scn = synthetic_scenario(n_pods=1536, n_nodes=32, seed=4, replicas=3, powerlaw=True,
                             mean_degree=2.0, device="cpu")
    n_calls = len(tpm.call_pairs(scn.graph)[0])
    mults = np.random.default_rng(3).lognormal(0.0, 0.5, (2, n_calls)).astype(np.float32)
    ttrace.replay_on_device_pods(scn.state, scn.graph, mults, torch.Generator().manual_seed(0),
                                 tgs.GlobalSolverConfig(sweeps=2, fused_epilogue="on"))
    # the pod replay shares the sparse replay's capture label and phases
    assert guarded_bodies == ["replay_on_device_sparse"] * 2


def test_eager_context_and_cpu_solves_bypass_the_cache():
    """On the CPU the body runs every call and nothing is captured or
    kept; ``eager()`` nests and restores."""
    scn = synthetic_scenario(n_pods=64, n_nodes=8, seed=1, device="cpu")
    cfg = tgs.GlobalSolverConfig(sweeps=2)
    cache = compiled.CACHE
    n0 = len(cache)
    a, _ = tgs.global_assign(scn.state, scn.graph, torch.Generator().manual_seed(2), cfg)
    with compiled.eager():
        with compiled.eager():
            assert compiled._EAGER.get()
        assert compiled._EAGER.get()
        b, _ = tgs.global_assign(scn.state, scn.graph, torch.Generator().manual_seed(2), cfg)
    assert not compiled._EAGER.get()
    assert torch.equal(a.pod_node, b.pod_node)
    assert len(cache) == n0
    with pytest.raises(ValueError, match="several devices"):
        cache.run("x", (), {"a": torch.zeros(1), "b": torch.zeros(1, device="meta")},
                  lambda: (lambda t: t))


def test_cache_key_holds_operand_identity():
    """Operands key by identity (the same tensor, the same key; an equal
    copy, another), inputs by shape and dtype only."""
    a = torch.zeros(4)
    key = compiled.GraphCache._full_key
    inputs = {"x": torch.ones(3)}
    assert key("f", (1,), inputs, (a,)) == key("f", (1,), {"x": torch.zeros(3)}, (a,))
    assert key("f", (1,), inputs, (a,)) != key("f", (1,), inputs, (a.clone(),))
    assert key("f", (1,), inputs, (a,)) != key("f", (1,), {"x": torch.ones(4)}, (a,))
    assert key("f", (1,), inputs, (a, None)) == key("f", (1,), inputs, (a,))


@pytest.mark.parametrize("mode,jax_mode", [("off", "off"), ("on", "interpret")])
def test_plan_tables_reproduce_the_jax_solve(mode, jax_mode):
    """The plans as stacked device tables (seeds i32, temperatures f32,
    gumbel noise) drive the solve as the plan list did: equal to the JAX
    solve, noise from the plan on the plain path."""
    j_scn = jtopo.synthetic_scenario(n_pods=256, n_nodes=128, seed=9)
    t_scn = synthetic_scenario(n_pods=256, n_nodes=128, seed=9, device="cpu")
    key = jax.random.PRNGKey(4)
    base = dict(sweeps=3, balance_weight=0.0, chunk_size=256,
                noise_temp=1.0 if mode == "off" else 0.0)
    j_cfg = jgs.GlobalSolverConfig(**base, fused_epilogue=jax_mode)
    j_state, j_info = jgs.global_assign(j_scn.state, j_scn.graph, key, j_cfg)
    plan = jax_plan(key, j_cfg, 256, 128, inline=mode == "on")
    cfg = tgs.GlobalSolverConfig(**base, fused_epilogue=mode)
    lay = tgs.dense_layout(256, 128, cfg, "cpu")
    t = tgs.dense_plan_inputs(plan, lay, cfg, torch.device("cpu"))
    assert t["seeds"].dtype == torch.int32 and t["temps"].dtype == torch.float32
    assert ("gumbel" in t) == (mode == "off")
    t_state, t_info = tgs.global_assign(t_scn.state, t_scn.graph, None, cfg, plan=plan)
    np.testing.assert_array_equal(t_state.pod_node.numpy(), np.asarray(j_state.pod_node))
    np.testing.assert_array_equal(t_info["moves_per_sweep"].numpy(),
                                  np.asarray(j_info["moves_per_sweep"]))


def test_sparse_plan_tables_hold_hub_noise():
    """On the plain sparse path with noise, each hub group's gumbel noise
    is its own stacked table; drawn from the generator when the plan has
    none, the same generator seed gives the same solve."""
    _, _, t_state, t_graph = hub_instance()
    cfg = tgs.GlobalSolverConfig(sweeps=2, chunk_size=512, fused_epilogue="off")
    lay = tss.sparse_layout(t_graph, cfg)
    key = jax.random.PRNGKey(5)
    plan = jax_sparse_plan(key, cfg.sweeps, lay, t_state.num_nodes)
    t = tss.sparse_plan_inputs(plan, lay, cfg, t_state.num_nodes, torch.device("cpu"))
    assert [k for k in t if k.startswith("hub_gumbel")] == [
        f"hub_gumbel_{g}" for g in range(len(lay.hub_groups))]
    assert t["hub_gumbel_0"].shape == (2, len(lay.hub_groups[0]) * BLOCK_R, t_state.num_nodes)
    runs = [tss.global_assign_sparse(t_state, t_graph, torch.Generator().manual_seed(3), cfg)
            for _ in range(2)]
    assert torch.equal(runs[0][0].pod_node, runs[1][0].pod_node)
    j_state, j_graph, _, _ = hub_instance()
    j_new, _ = jss.global_assign_sparse(j_state, j_graph, key,
                                        jgs.GlobalSolverConfig(sweeps=2, chunk_size=512,
                                                               fused_epilogue="off"))
    t_new, _ = tss.global_assign_sparse(t_state, t_graph, None, cfg, plan=plan)
    np.testing.assert_array_equal(t_new.pod_node.numpy(), np.asarray(j_new.pod_node))
