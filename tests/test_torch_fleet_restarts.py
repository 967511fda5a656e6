"""Fleet restarts in the port (``solver/fleet_global.py`` with ``n_restarts``
R > 1, and the fleet loop's global rounds at ``solver_restarts`` R), against
the JAX package's ``fleet_global_solve(n_restarts=R)`` (a ``lax.scan`` over
``split(key, R)`` a tenant, tests/test_fleet_v2.py:126/160) and against the
port's own solo ``solve_with_restarts``.

Inputs: the 2-tenant µBench fleet of tests/test_fleet_v2.py; each restart's
per-sweep plans are built from the JAX key stream (``split(fold_in(key,
t), R)``, each split into its sweeps as ``global_assign`` does:
tests/test_torch_global_solver.py::jax_plan) and fed through the plan seam.

Bars: moves (services, targets, first-moved-pod order) exactly; the adopted
``objective_after`` and ``move_penalty`` at rel 1e-6 against JAX (f32 sums
in another order; ``balance_weight`` 0 and ``move_cost`` 0.5, the
configuration of tests/test_fleet_v2.py's dp cases), bit for bit against
the port's solo ``solve_with_restarts`` (the same solo bodies and the same
``argmin``), at ``balance_weight`` 0.5 too. ``objective_before`` and
``improved`` ride as NaN and decode to None, as in the JAX package.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_compiled import guarded_bodies  # noqa: F401 (fixture)
from test_torch_fleet import fleets, jax_keys, snapshots
from test_torch_fleet_global import solo_changed_moves
from test_torch_global_solver import jax_plan
from test_torch_sim_device import strip

from kubernetes_rescheduling_tpu.solver import fleet as jfleet
from kubernetes_rescheduling_tpu.solver import fleet_global as jfg
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu_torch import cli as t_cli
from kubernetes_rescheduling_tpu_torch._random import round_generator, tenant_seed
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.fleet import run_fleet_controller as t_run_fleet
from kubernetes_rescheduling_tpu_torch.config import FleetConfig, RescheduleConfig
from kubernetes_rescheduling_tpu_torch.parallel import sharded as tsh
from kubernetes_rescheduling_tpu_torch.solver import compiled
from kubernetes_rescheduling_tpu_torch.solver import fleet as tfleet
from kubernetes_rescheduling_tpu_torch.solver import fleet_global as tfg
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry

BASE = dict(sweeps=3, balance_weight=0.0, move_cost=0.5)


def restart_plans(key, R, cfg, S, N):
    """One JAX tenant's R restart plan lists (``split(key, R)``)."""
    return [jax_plan(k, cfg, S, N, inline=False) for k in jax.random.split(key, R)]


def port_fleet(t_states, t_graphs, mask, cfg, R, **kw):
    flat = tfg.fleet_global_solve(tfleet.stack_tenants(t_states), t_graphs,
                                  torch.from_numpy(mask), config=cfg, n_restarts=R, **kw)
    return flat, tfg.decode_fleet_global(flat.numpy(), tenants=len(t_states),
                                         num_services=t_graphs[0].num_services)


@pytest.mark.parametrize("R", [2, 3])
def test_fleet_restarts_match_jax(R):
    """JAX ``fleet_global_solve(n_restarts=R)`` on the 2-tenant fleet against
    the port fed the same restarts' plans: the same moves in the same order,
    the same adopted objective and penalty."""
    jf, tf = fleets(2, imbalance=False)
    j_states, j_graphs = snapshots(jf)
    t_states, t_graphs = snapshots(tf)
    keys = jax_keys(2, seed=3)
    mask = np.ones(2, bool)
    j_cfg = jgs.GlobalSolverConfig(**BASE)
    j_flat = jfg.fleet_global_solve(jfleet.stack_tenants(j_states),
                                    jfleet.stack_tenants(j_graphs), keys, jnp.asarray(mask),
                                    config=j_cfg, n_restarts=R)
    S, N = t_graphs[0].num_services, t_states[0].num_nodes
    j_moves, j_objs = jfg.decode_fleet_global(np.asarray(j_flat), tenants=2, num_services=S)
    plans = [restart_plans(k, R, j_cfg, S, N) for k in keys]
    _, (moves, objs) = port_fleet(t_states, t_graphs, mask, tgs.GlobalSolverConfig(**BASE), R,
                                  plans=plans)
    assert any(moves)
    assert moves == j_moves
    for t in range(2):
        assert objs[t][0] is None and objs[t][2] is None
        assert j_objs[t][0] is None and j_objs[t][2] is None
        assert objs[t][1] == pytest.approx(j_objs[t][1], rel=1e-6)
        assert objs[t][3] == pytest.approx(j_objs[t][3], rel=1e-6)


@pytest.mark.parametrize("R", [2, 3])
@pytest.mark.parametrize("bw", [0.0, 0.5])
def test_fleet_restarts_equal_port_solo(R, bw):
    """Each live tenant equals the port's solo ``solve_with_restarts(
    n_restarts=R)`` on its generator bit for bit (targets, first pods,
    adopted objective, penalty); the masked slot emits nothing."""
    _, tf = fleets(3, seed=2, imbalance=bw > 0)
    t_states, t_graphs = snapshots(tf)
    cfg = tgs.GlobalSolverConfig(sweeps=3, balance_weight=bw, move_cost=0.5)
    seeds = [21, 22, 23]
    mask = np.array([True, False, True])
    _, (moves, objs) = port_fleet(t_states, t_graphs, mask, cfg, R,
                                  generators=[round_generator(s, 0) for s in seeds])
    assert moves[1] == [] and objs[1] == (0.0, 0.0, False, 0.0)
    for t in (0, 2):
        st, info = tsh.solve_with_restarts(t_states[t], t_graphs[t], round_generator(seeds[t], 0),
                                           n_restarts=R, config=cfg)
        assert moves[t] == solo_changed_moves(t_states[t], st)
        assert objs[t] == (None, float(info["objective_after"]), None,
                           float(info["move_penalty"]))
    assert any(moves)


def test_fleet_restarts_nan_rows_decode_to_none():
    """The bundle's objective rows: NaN before / improved for live tenants
    (the restart fan-out's absent keys), zeros for a masked slot; decoded
    to None and to the masked no-op."""
    _, tf = fleets(2, seed=5, imbalance=False)
    t_states, t_graphs = snapshots(tf)
    cfg = tgs.GlobalSolverConfig(sweeps=2)
    flat, (_, objs) = port_fleet(t_states, t_graphs, np.array([True, False]), cfg, 2,
                                 generators=[round_generator(s, 0) for s in (1, 2)])
    S = t_graphs[0].num_services
    rows = flat.numpy()[4 * S:].reshape(2, tfg.OBJ_ROWS)
    assert np.isnan(rows[0, tfg.OBJ_BEFORE]) and np.isnan(rows[0, tfg.OBJ_IMPROVED])
    assert np.isfinite(rows[0, tfg.OBJ_AFTER]) and np.isfinite(rows[0, tfg.OBJ_PENALTY])
    assert not rows[1].any()
    assert objs[0][0] is None and objs[0][2] is None
    assert objs[1] == (0.0, 0.0, False, 0.0)


def test_fleet_restart_body_reads_nothing_back(guarded_bodies):  # noqa: F811
    """The restart fan-out's body reads nothing back to the host (a read
    inside a capture fails on the card)."""
    _, tf = fleets(2, imbalance=False)
    t_states, t_graphs = snapshots(tf)
    port_fleet(t_states, t_graphs, np.ones(2, bool), tgs.GlobalSolverConfig(sweeps=2), 2,
               generators=[round_generator(s, 0) for s in (1, 2)])
    assert guarded_bodies == ["fleet_global_solve"]


def test_fleet_restarts_one_capture_key(monkeypatch):
    """Every round of a fleet global run at R = 2 hands the capture cache
    one key, which holds R: a fleet round at R restarts is one replay."""
    keys = []
    real = compiled.GraphCache.run

    def record(self, fn, key, inputs, make_body, operands=()):
        keys.append(compiled.GraphCache._full_key(fn, key, inputs, operands))
        return real(self, fn, key, inputs, make_body, operands)

    monkeypatch.setattr(compiled.GraphCache, "run", record)
    _, tf = fleets(2)
    cfg = RescheduleConfig(algorithm="global", max_rounds=3, sleep_after_action_s=0.0,
                           global_solver_iters=2, solver_restarts=2,
                           fleet=FleetConfig(tenants=2))
    t_run_fleet(tf, cfg, device="cpu", registry=TRegistry())
    assert len(keys) == 3 and len(set(keys)) == 1
    assert keys[0][0] == "fleet_global_solve" and keys[0][1][-1] == 2


@pytest.mark.parametrize("bw", [0.0, 0.5])
def test_fleet_loop_restarts_equal_solo_loops(bw):
    """The fleet loop at ``solver_restarts`` 2: tenant ``t``'s records equal
    a solo ``run_controller`` of seed ``tenant_seed(seed, t)`` at the same
    restarts, every field but timing."""
    kw = dict(algorithm="global", max_rounds=3, sleep_after_action_s=0.0,
              global_solver_iters=2, solver_restarts=2, balance_weight=bw, seed=4)
    _, tf = fleets(2, seed=1, imbalance=bw > 0)
    fl = t_run_fleet(tf, RescheduleConfig(**kw, fleet=FleetConfig(tenants=2)), device="cpu",
                     registry=TRegistry())
    _, sf = fleets(2, seed=1, imbalance=bw > 0)
    for i, (name, backend) in enumerate(sf):
        solo = t_run(backend, RescheduleConfig(**{**kw, "seed": tenant_seed(4, i)}),
                     device="cpu", registry=TRegistry())
        assert [strip(r) for r in solo.rounds] == [strip(r) for r in fl.results[name].rounds]
        assert all(r.objective_before is None for r in fl.results[name].rounds)


def test_cli_fleet_restarts(capsys):
    """``reschedule --fleet 2 --restarts 2`` runs (it was refused before the
    port carried fleet restarts)."""
    assert t_cli.main(["reschedule", "--fleet", "2", "--algorithm", "global", "--restarts",
                       "2", "--rounds", "2", "--scenario", "mubench", "--imbalance",
                       "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["fleet"] == {"tenants": 2, "plane": "vmap"}
    assert out["batched_solves"] == 2
    for row in out["per_tenant"].values():
        assert row["rounds"] == 2
