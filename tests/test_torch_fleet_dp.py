"""Fleet mode's dp plane in the port (``parallel/fleet.py``: a block of
tenants a rank, the blocks gathered over dp), against the JAX package's dp
planes on its 8 forced CPU devices (tests/test_fleet.py:111-121,
tests/test_fleet_v2.py:160-195, tests/test_elastic.py:219-238) and against
the port's vmap plane.

The port's ranks run as gloo groups of 2 or 4 spawned processes
(``parallel.launch.run_group``, each with its own timeout), fed the same
numpy-seeded tenants as the JAX side; the global plane is fed the JAX key
stream's plans (tests/test_torch_global_solver.py::jax_plan). Bars: the
greedy and proactive decisions and hazard masks exactly; the global
plane's moves exactly and its objectives at rel 1e-6 against JAX (f32 sums
in another order, ``balance_weight`` 0 as tests/test_fleet_v2.py's dp
case), and bit for bit against the port's vmap plane, the balance term on
too (each rank runs the solo bodies); every rank returns the same outputs.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_elastic import twin_problem
from test_torch_fleet import fleets, jax_keys, snapshots
from test_torch_fleet_restarts import restart_plans
from test_torch_global_solver import jax_plan
from test_torch_sim_device import strip

from kubernetes_rescheduling_tpu.parallel import fleet as jdp
from kubernetes_rescheduling_tpu.solver import fleet as jfleet
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu_torch.config import FleetConfig, RescheduleConfig
from kubernetes_rescheduling_tpu_torch.elastic.buckets import device_view
from kubernetes_rescheduling_tpu_torch.parallel import fleet as tdp
from kubernetes_rescheduling_tpu_torch.parallel import mesh as tmesh
from kubernetes_rescheduling_tpu_torch.parallel.launch import run_group
from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS
from kubernetes_rescheduling_tpu_torch.solver import fleet as tfleet
from kubernetes_rescheduling_tpu_torch.solver import fleet_global as tfg
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs
from kubernetes_rescheduling_tpu_torch.solver.round_loop import decide
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry

PKG = "kubernetes_rescheduling_tpu_torch"
GROUP_TIMEOUT_S = 120.0


def group(tmp_path, fn, world, *args, mesh_shape=None, **kwargs):
    """``fn`` on every rank of a gloo group of ``world`` ranks, with an
    explicit (dp, tp) mesh when ``mesh_shape`` is given, else shaping its
    own; returns the ranks' results."""
    shape = mesh_shape or (world,)
    return run_group(f"{PKG}.{fn}", shape, args, kwargs, pass_mesh=mesh_shape is not None,
                     rendezvous=str(tmp_path / f"rdzv_{fn.rsplit('.', 1)[-1]}"),
                     timeout_s=GROUP_TIMEOUT_S)


def same_outputs(outs, want):
    for out in outs:
        assert len(out) == len(want)
        for a, b in zip(out, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("world,mesh_shape", [(2, (2, 1)), (4, None)], ids=["dp2", "auto4"])
def test_fleet_solve_dp_matches_jax_and_vmap(tmp_path, world, mesh_shape):
    """tests/test_fleet.py:111: 4 tenants, one masked, the communication
    policy; over an explicit dp = 2 mesh and over a world of 4 that shapes
    dp = 4 itself."""
    jf, tf = fleets(4)
    j_states, j_graphs = snapshots(jf)
    t_states, t_graphs = snapshots(tf)
    mask = np.array([True, True, False, True])
    pid = POLICY_IDS["communication"]
    j_d, j_h = jdp.fleet_solve_dp(jfleet.stack_tenants(j_states), jfleet.stack_tenants(j_graphs),
                                  jnp.asarray(pid), jnp.asarray(30.0), jax_keys(4),
                                  jnp.asarray(mask))
    st = tfleet.stack_tenants(t_states)
    tmask = torch.from_numpy(mask)
    vmap = tfleet.fleet_solve(st, t_graphs, pid, 30.0, tmask)
    outs = group(tmp_path, "parallel.fleet.fleet_solve_dp", world, st, t_graphs, pid, 30.0,
                 tmask, mesh_shape=mesh_shape)
    same_outputs(outs, vmap)
    np.testing.assert_array_equal(vmap[0].numpy(), np.asarray(j_d))
    np.testing.assert_array_equal(vmap[1].numpy(), np.asarray(j_h))


def test_fleet_solve_proactive_dp_matches_jax_and_vmap(tmp_path):
    """The proactive dp plane on 4 tenants over dp = 2, each tenant's
    forecast delta row sharded with its state: equal to JAX's
    ``fleet_solve_proactive_dp`` and to the port's vmap plane."""
    jf, tf = fleets(4, seed=3)
    j_states, j_graphs = snapshots(jf)
    t_states, t_graphs = snapshots(tf)
    n = t_states[0].num_nodes
    deltas = np.random.default_rng(7).normal(0.0, 8.0, (4, n)).astype(np.float32)
    mask = np.array([True, False, True, True])
    pid = POLICY_IDS["communication"]
    j_d, j_h = jdp.fleet_solve_proactive_dp(
        jfleet.stack_tenants(j_states), jfleet.stack_tenants(j_graphs), jnp.asarray(pid),
        jnp.asarray(30.0), jax_keys(4), jnp.asarray(mask), jnp.asarray(deltas))
    st = tfleet.stack_tenants(t_states)
    args = (st, t_graphs, pid, 30.0, torch.from_numpy(mask), torch.from_numpy(deltas))
    vmap = tfleet.fleet_solve_proactive(*args)
    outs = group(tmp_path, "parallel.fleet.fleet_solve_proactive_dp", 2, *args,
                 mesh_shape=(2, 1))
    same_outputs(outs, vmap)
    np.testing.assert_array_equal(vmap[0].numpy(), np.asarray(j_d))
    np.testing.assert_array_equal(vmap[1].numpy(), np.asarray(j_h))


@pytest.mark.parametrize("R,world", [(1, 2), (2, 4)], ids=["R1-dp2", "R2-world4"])
def test_fleet_global_solve_dp_matches_jax_and_vmap(tmp_path, R, world):
    """tests/test_fleet_v2.py:160: the 2-tenant fleet, ``balance_weight`` 0,
    ``move_cost`` 0.5, restarts R; JAX's dp plane (dp = 2 on its 8 devices)
    against the port's over a world of 2 (dp = 2) and of 4 (dp = 2, the
    other axis replicating the blocks)."""
    jf, tf = fleets(2, imbalance=False)
    j_states, j_graphs = snapshots(jf)
    t_states, t_graphs = snapshots(tf)
    keys = jax_keys(2, seed=3)
    base = dict(sweeps=3, balance_weight=0.0, move_cost=0.5)
    j_cfg = jgs.GlobalSolverConfig(**base)
    S, N = t_graphs[0].num_services, t_states[0].num_nodes
    j_flat = jdp.fleet_global_solve_dp(jfleet.stack_tenants(j_states),
                                       jfleet.stack_tenants(j_graphs), keys,
                                       jnp.ones((2,), bool), config=j_cfg, n_restarts=R)
    j_moves, j_objs = jdp.decode_fleet_global_dp(np.asarray(j_flat), tenants=2,
                                                 num_services=S, dp=2)
    plans = ([jax_plan(k, j_cfg, S, N, inline=False) for k in keys] if R == 1
             else [restart_plans(k, R, j_cfg, S, N) for k in keys])
    cfg = tgs.GlobalSolverConfig(**base)
    mask = torch.ones(2, dtype=torch.bool)
    vmap = tfg.fleet_global_solve(t_states, t_graphs, mask, config=cfg, plans=plans,
                                  n_restarts=R)
    outs = run_group(f"{PKG}.parallel.fleet.fleet_global_solve_dp", (world,),
                     (t_states, t_graphs, mask), dict(config=cfg, plans=plans, n_restarts=R),
                     pass_mesh=False, rendezvous=str(tmp_path / "rdzv"),
                     timeout_s=GROUP_TIMEOUT_S)
    # dp = 2 blocks of one tenant: the per-block layout, which decodes to
    # the vmap plane's moves and objectives
    moves, objs = tdp.decode_fleet_global_dp(outs[0].numpy(), tenants=2, num_services=S, dp=2)
    for o in outs:  # NaN rows too (the restart fan-out's absent keys)
        np.testing.assert_array_equal(o.numpy(), outs[0].numpy())
    assert (moves, objs) == tfg.decode_fleet_global(vmap.numpy(), tenants=2, num_services=S)
    assert any(moves) and moves == j_moves
    for a, b in zip(objs, j_objs):
        assert (a[0] is None) == (b[0] is None) and a[2] == b[2]
        for x, y in ((a[1], b[1]), (a[3], b[3])) + (((a[0], b[0]),) if R == 1 else ()):
            assert x == pytest.approx(y, rel=1e-6)


def test_fleet_global_dp_equals_vmap_under_balance(tmp_path):
    """With the balance term on, the port's dp plane still equals its vmap
    plane bit for bit (each rank runs the solo bodies; the JAX package's
    differently partitioned executables may land on another near-tie
    optimum there, tests/test_fleet_v2.py:202)."""
    _, tf = fleets(4, seed=6)
    t_states, t_graphs = snapshots(tf)
    cfg = tgs.GlobalSolverConfig(sweeps=3, balance_weight=0.5)
    seeds = [3, 4, 5, 6]
    mask = torch.tensor([True, True, False, True])

    def gens():
        return [torch.Generator().manual_seed(s) for s in seeds]

    vmap = tfg.fleet_global_solve(t_states, t_graphs, mask, config=cfg, generators=gens())
    outs = group(tmp_path, "parallel.fleet.fleet_global_solve_dp", 2, t_states, t_graphs, mask,
                 mesh_shape=(2, 1), config=cfg, generators=gens())
    S = t_graphs[0].num_services
    want = tfg.decode_fleet_global(vmap.numpy(), tenants=4, num_services=S)
    for out in outs:
        assert tdp.decode_fleet_global_dp(out.numpy(), tenants=4, num_services=S, dp=2) == want
    assert any(want[0])


def test_decode_and_mesh_divisibility():
    """The one divisibility rule: a tenant count dp does not divide is
    refused by the decode (JAX's message) and by the mesh check; with no
    process group the auto mesh is dp = 1 and the dp call is the vmap
    call."""
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        tdp.decode_fleet_global_dp(np.zeros(12, np.float32), tenants=3, num_services=1, dp=2)
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        jdp.decode_fleet_global_dp(np.zeros(12, np.float32), tenants=3, num_services=1, dp=2)
    fake = tmesh.Mesh(("dp", "tp"), {"dp": 2, "tp": 1}, {"dp": 0, "tp": 0},
                      {"dp": None, "tp": None}, {"dp": (0, 1), "tp": (0,)}, 0,
                      torch.device("cpu"))
    with pytest.raises(ValueError, match="tenant count 3 must be a multiple of dp=2"):
        tdp._fleet_mesh(3, fake)
    auto = tdp._fleet_mesh(3, None, device="cpu")
    assert auto.shape == {"dp": 1, "tp": 1}
    assert tdp.dp_device_names(tenants=3, device="cpu") == ("cpu:0",)
    assert tdp.dp_device_names(fake) == ("cpu:0", "cpu:1")
    _, tf = fleets(3)
    t_states, t_graphs = snapshots(tf)
    st, mask = tfleet.stack_tenants(t_states), torch.ones(3, dtype=torch.bool)
    same_outputs([tdp.fleet_solve_dp(st, t_graphs, 3, 30.0, mask)],
                 tfleet.fleet_solve(st, t_graphs, 3, 30.0, mask))
    dec, hz, hbm = tdp.fleet_solve_dp(st, t_graphs, 3, 30.0, mask, with_hbm=True)
    assert hbm.tolist() == [0.0] and dec.shape == (3, 4) and hz.shape[0] == 3


def test_mask_twin_fleet_dp_plane(tmp_path):
    """tests/test_elastic.py:219 (the churned, bucket-padded dp plane): two
    padded tenants over dp = 2 decide as the solo decision on their
    unpadded twins, row for row, and as the vmap plane."""
    st, gr, pst, pgr = twin_problem()
    est2, egr2, pst2, pgr2 = twin_problem(seed=5)
    states = tfleet.stack_tenants([device_view(pst), device_view(pst2)])
    graphs = [pgr, pgr2]
    pid, mask = POLICY_IDS["communication"], torch.ones(2, dtype=torch.bool)
    vmap = tfleet.fleet_solve(states, graphs, pid, 30.0, mask)
    outs = group(tmp_path, "parallel.fleet.fleet_solve_dp", 2, states, graphs, pid, 30.0, mask,
                 mesh_shape=(2, 1))
    same_outputs(outs, vmap)
    for row, (s, g) in enumerate([(st, gr), (est2, egr2)]):
        most, _h, victim, svc, target = decide(s, g, pid, 30.0)
        assert vmap[0][row].tolist() == [int(most), int(victim), int(svc), int(target)]


def records(result) -> dict:
    return {name: [strip(r) for r in r_.rounds] for name, r_ in result.results.items()}


@pytest.mark.parametrize("kw", [
    dict(algorithm="communication", max_rounds=4),
    dict(algorithm="global", max_rounds=2, global_solver_iters=2, solver_restarts=2,
         balance_weight=0.5),
    dict(algorithm="communication", max_rounds=3, elastic="steady"),
], ids=["greedy", "global-restarts", "churn"])
def test_fleet_loop_dp_over_a_group_equals_vmap(tmp_path, kw):
    """``run_fleet_controller`` with ``plane="dp"`` on every rank of a gloo
    group of 2: each rank's records equal the vmap run's, every field but
    timing (churn too: every rank churns its whole fleet alike)."""
    cfg = dict(kw, sleep_after_action_s=0.0, seed=2)
    _, tf = fleets(4, seed=1)
    vmap = tdp_free_run(tf, RescheduleConfig(**cfg, fleet=FleetConfig(tenants=4)))
    _, tf = fleets(4, seed=1)
    dp_cfg = RescheduleConfig(**cfg, fleet=FleetConfig(tenants=4, plane="dp"))
    outs = run_group(f"{PKG}.bench.fleet.run_fleet_controller", (2,), (tf, dp_cfg),
                     dict(device="cpu"), pass_mesh=False, rendezvous=str(tmp_path / "rdzv"),
                     timeout_s=GROUP_TIMEOUT_S)
    assert all(records(o) == records(vmap) for o in outs)
    assert sum(len(r) for r in records(vmap).values()) == 4 * cfg["max_rounds"]


def tdp_free_run(fleet, cfg):
    from kubernetes_rescheduling_tpu_torch.bench.fleet import run_fleet_controller

    return run_fleet_controller(fleet, cfg, device="cpu", registry=TRegistry())


def test_fleet_loop_dp_one_process_feeds_the_mesh_plane():
    """Without a process group the dp loop is the vmap loop (records equal)
    and feeds a one-device mesh plane every round: the bounded families,
    and no added read (the counted transfer sites equal the vmap run's)."""
    cfg = dict(algorithm="global", max_rounds=2, sleep_after_action_s=0.0,
               global_solver_iters=2)
    _, tf = fleets(2)
    reg_v = TRegistry()
    from kubernetes_rescheduling_tpu_torch.bench.fleet import run_fleet_controller

    vmap = run_fleet_controller(tf, RescheduleConfig(**cfg, fleet=FleetConfig(tenants=2)),
                                device="cpu", registry=reg_v)
    _, tf = fleets(2)
    reg_d = TRegistry()
    dp = run_fleet_controller(tf, RescheduleConfig(**cfg, fleet=FleetConfig(tenants=2,
                                                                          plane="dp")),
                              device="cpu", registry=reg_d)
    assert records(dp) == records(vmap)
    for site in ("fleet_decision", "fleet_metrics"):
        assert reg_d.value("device_transfers_total", site=site) == \
            reg_v.value("device_transfers_total", site=site) == 2
    assert reg_d.gauge("mesh_devices").value == 1
    assert reg_d.gauge("mesh_imbalance_ratio").value == 1.0
    _, tf = fleets(2)
    reg_o = TRegistry()
    off = run_fleet_controller(tf, RescheduleConfig(**cfg, device_rollup=False,
                                                    fleet=FleetConfig(tenants=2, plane="dp")),
                               device="cpu", registry=reg_o)
    assert records(off) == records(vmap) and reg_o.value("mesh_devices") == 0


def test_cli_dp_plane_writes_and_prints_on_rank0_only(tmp_path, monkeypatch, capsys):
    """``reschedule --fleet 2 --fleet-plane dp`` on the CPU: rank 0 prints
    the fleet's JSON and writes ``--metrics-out``; any other rank (``RANK``
    as ``torchrun`` sets it) runs the same loop but prints, serves and
    writes nothing."""
    from kubernetes_rescheduling_tpu_torch import cli as t_cli

    argv = ["reschedule", "--fleet", "2", "--fleet-plane", "dp", "--rounds", "2",
            "--imbalance", "--serve", "0", "--bundle-dir", str(tmp_path / "b"),
            "--device", "cpu", "--metrics-out"]
    monkeypatch.setenv("RANK", "1")
    assert t_cli.main(argv + [str(tmp_path / "rank1.jsonl")]) == 0
    assert capsys.readouterr().out == ""
    assert not (tmp_path / "rank1.jsonl").exists()
    monkeypatch.setenv("RANK", "0")
    assert t_cli.main(argv + [str(tmp_path / "rank0.jsonl")]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["fleet"] == {"tenants": 2, "plane": "dp"} and out["batched_solves"] == 2
    assert (tmp_path / "rank0.jsonl").exists()
