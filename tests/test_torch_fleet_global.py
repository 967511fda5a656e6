"""Fleet mode's global plane in the port (``solver/fleet_global.py`` and the
loop's global rounds), against the JAX package's (tests/test_fleet_v2.py:126,
:238, :375, :419, :509, :585, :607) and against the port's own solo solve.

Inputs: each tenant's per-sweep plans are built from the JAX key stream
(``fold_in(key, t)``, then the round) as
tests/test_torch_global_solver.py::jax_plan builds them.

Bars: moves (services, targets and their order), placements and counts
exactly; objectives exactly where both sides sum in one order, rel 1e-6
where the JAX side's sums run in another; against the JAX package's
Pallas-interpreted solo solve, the kernel lowering's bars of
tests/test_torch_global_solver.py (placements ≥ 99% identical, objective
rel 1e-3: the fused commit adds load deltas in another f32 order). The
port's fleet solve equals its own solo solve bit for bit on both lowerings.
The JAX comparisons run at ``balance_weight`` 0: the JAX package's jitted
and op-by-op runs break ties differently at 0.5 (ROADMAP Queue 3); the
port's fleet is held to its solo run at 0.5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_compiled import guarded_bodies  # noqa: F401 (fixture)
from test_torch_controller import DECISIONS
from test_torch_fleet import fleets, jax_keys, snapshots
from test_torch_global_solver import jax_plan
from test_torch_sim_device import strip

from kubernetes_rescheduling_tpu.backends.fleet import FleetBackend as JFleetBackend
from kubernetes_rescheduling_tpu.bench.fleet import run_fleet_controller as j_run_fleet
from kubernetes_rescheduling_tpu.bench.harness import make_backend as j_make
from kubernetes_rescheduling_tpu.config import FleetConfig as JFleetConfig
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.solver import fleet as jfleet
from kubernetes_rescheduling_tpu.solver import fleet_global as jfg
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu_torch._random import round_generator, tenant_seed
from kubernetes_rescheduling_tpu_torch.backends.fleet import FleetBackend
from kubernetes_rescheduling_tpu_torch.bench.boundary import BoundaryClient
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.fleet import run_fleet_controller as t_run_fleet
from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend as t_make
from kubernetes_rescheduling_tpu_torch.config import FleetConfig, RescheduleConfig
from kubernetes_rescheduling_tpu_torch.solver import compiled
from kubernetes_rescheduling_tpu_torch.solver import fleet as tfleet
from kubernetes_rescheduling_tpu_torch.solver import fleet_global as tfg
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry


def solo_changed_moves(state, new_state):
    """The solo global round's move extraction: changed services in
    first-moved-pod order."""
    old, new = state.pod_node.numpy(), new_state.pod_node.numpy()
    changed, seen = [], set()
    for i in np.flatnonzero(state.pod_valid.numpy() & (old != new)):
        s = int(state.pod_service[i])
        if s not in seen:
            seen.add(s)
            changed.append((s, int(new[i])))
    return changed


def port_solve(t_states, t_graphs, mask, cfg, plans=None, generators=None):
    flat = tfg.fleet_global_solve(tfleet.stack_tenants(t_states), t_graphs,
                                  torch.from_numpy(mask), config=cfg, plans=plans,
                                  generators=generators)
    return tfg.decode_fleet_global(flat.numpy(), tenants=len(t_states),
                                   num_services=t_graphs[0].num_services)


def assert_solo_equal(t_states, t_graphs, cfg, moves, objs, live, plans=None, seeds=None):
    """The fleet's tenants against the port's solo ``global_assign``."""
    for t in live:
        gen = round_generator(seeds[t], 0) if seeds is not None else None
        state, info = tgs.global_assign(t_states[t], t_graphs[t], gen, cfg,
                                        plan=plans[t] if plans is not None else None)
        assert moves[t] == solo_changed_moves(t_states[t], state)
        assert objs[t] == (float(info["objective_before"]), float(info["objective_after"]),
                           bool(info["improved"]), float(info["move_penalty"]))


def test_fleet_global_solve_bit_exact_vs_solo():
    """tests/test_fleet_v2.py:126 at n_restarts=1, plain lowering: the fleet
    bundle decodes to the JAX fleet's moves and objectives and to the
    port's solo solves; the masked slot emits nothing. (No imbalance: at
    balance weight 0 the cordon pile-up is already optimal.)"""
    jf, tf = fleets(3, imbalance=False)
    j_states, j_graphs = snapshots(jf)
    t_states, t_graphs = snapshots(tf)
    base = dict(sweeps=3, balance_weight=0.0, move_cost=0.5)
    keys = jax_keys(3, seed=7)
    mask = np.array([True, False, True])
    j_flat = jfg.fleet_global_solve(jfleet.stack_tenants(j_states),
                                    jfleet.stack_tenants(j_graphs), keys, jnp.asarray(mask),
                                    config=jgs.GlobalSolverConfig(**base))
    S, N = t_graphs[0].num_services, t_states[0].num_nodes
    j_moves, j_objs = jfg.decode_fleet_global(np.asarray(j_flat), tenants=3, num_services=S)
    plans = [jax_plan(k, jgs.GlobalSolverConfig(**base), S, N, inline=False) for k in keys]
    cfg = tgs.GlobalSolverConfig(**base)
    moves, objs = port_solve(t_states, t_graphs, mask, cfg, plans=plans)
    assert moves[1] == [] and objs[1] == (0.0, 0.0, False, 0.0)
    assert moves == j_moves
    for t in (0, 2):
        assert moves[t]
        assert objs[t][2] == j_objs[t][2]
        for a, b in zip(objs[t][:2] + objs[t][3:], j_objs[t][:2] + j_objs[t][3:]):
            assert a == pytest.approx(b, rel=1e-6)
    assert_solo_equal(t_states, t_graphs, cfg, moves, objs, (0, 2), plans=plans)


@pytest.mark.parametrize("extra", [
    dict(fused_epilogue="off", balance_weight=0.5, move_cost=0.5),
    dict(fused_epilogue="on", noise_temp=0.0, balance_weight=0.5),
], ids=["off", "on"])
def test_fleet_global_solve_equals_port_solo(extra):
    """Both lowerings (the kernels' plain versions on the CPU) at balance
    weight 0.5: each tenant equals the port's solo solve of the same
    generator, bit for bit."""
    _, tf = fleets(3, seed=2)
    t_states, t_graphs = snapshots(tf)
    cfg = tgs.GlobalSolverConfig(sweeps=3, **extra)
    seeds = [11, 12, 13]
    mask = np.ones(3, bool)
    moves, objs = port_solve(t_states, t_graphs, mask, cfg,
                             generators=[round_generator(s, 0) for s in seeds])
    assert_solo_equal(t_states, t_graphs, cfg, moves, objs, range(3), seeds=seeds)
    assert any(moves)


def test_fleet_global_kernel_lowering_vs_jax_interpret():
    """The ``"on"`` fleet solve against the JAX package's solo
    Pallas-interpreted solve per tenant (tests/test_fleet_v2.py:126 pins
    JAX fleet = JAX solo exactly), at the kernel lowering's bars."""
    jf, tf = fleets(2, seed=4, imbalance=False)
    j_states, j_graphs = snapshots(jf)
    t_states, t_graphs = snapshots(tf)
    base = dict(sweeps=3, noise_temp=0.0, balance_weight=0.0)
    keys = jax_keys(2, seed=5)
    S, N = t_graphs[0].num_services, t_states[0].num_nodes
    j_cfg = jgs.GlobalSolverConfig(**base, fused_epilogue="interpret")
    plans = [jax_plan(k, j_cfg, S, N, inline=False) for k in keys]
    flat = tfg.fleet_global_solve(tfleet.stack_tenants(t_states), t_graphs,
                                  torch.ones(2, dtype=torch.bool),
                                  config=tgs.GlobalSolverConfig(**base, fused_epilogue="on"),
                                  plans=plans)
    moves, objs = tfg.decode_fleet_global(flat.numpy(), tenants=2, num_services=S)
    for t in range(2):
        j_state, j_info = jgs.global_assign(j_states[t], j_graphs[t], keys[t], j_cfg)
        j_moves = solo_changed_moves(
            t_states[t], t_states[t].replace(pod_node=torch.as_tensor(np.array(j_state.pod_node))))
        placed = {s: n for s, n in j_moves}
        mine = {s: n for s, n in moves[t]}
        same = sum(placed.get(s, -1) == mine.get(s, -1) for s in range(S)) / S
        assert same >= 0.99
        assert objs[t][1] == pytest.approx(float(j_info["objective_after"]), rel=1e-3)
        assert objs[t][0] == pytest.approx(float(j_info["objective_before"]), rel=1e-6)


def test_fleet_global_restarts_refused():
    """Fleet restarts are carried (tests/test_torch_fleet_restarts.py holds
    them against JAX and the solo solve): what is refused is a restart
    without its plans or a generator, and a plan count other than R."""
    _, tf = fleets(2)
    t_states, t_graphs = snapshots(tf)
    mask = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="generator or explicit plans"):
        tfg.fleet_global_solve(t_states, t_graphs, mask, n_restarts=2)
    cfg = tgs.GlobalSolverConfig(sweeps=2)
    with pytest.raises(ValueError, match="tenant 0: 1 restart plans for 2 restarts"):
        tfg.fleet_global_solve(t_states, t_graphs, mask, config=cfg, n_restarts=2,
                               plans=[[None], [None]])
    flat = tfg.fleet_global_solve(t_states, t_graphs, mask, config=cfg, n_restarts=2,
                                  generators=[round_generator(s, 0) for s in (1, 2)])
    _, objs = tfg.decode_fleet_global(flat.numpy(), tenants=2,
                                      num_services=t_graphs[0].num_services)
    assert all(o[0] is None and o[2] is None for o in objs)


def test_fleet_global_one_capture_key(monkeypatch):
    """tests/test_fleet_v2.py:238's counterpart: every round of a fleet
    global run hands the capture cache one key (tenant count, shapes,
    config, lowering, the adjacencies' identities)."""
    keys = []
    real = compiled.GraphCache.run

    def record(self, fn, key, inputs, make_body, operands=()):
        keys.append(compiled.GraphCache._full_key(fn, key, inputs, operands))
        return real(self, fn, key, inputs, make_body, operands)

    monkeypatch.setattr(compiled.GraphCache, "run", record)
    _, tf = fleets(4)
    cfg = RescheduleConfig(algorithm="global", max_rounds=3, sleep_after_action_s=0.0,
                           global_solver_iters=2, fleet=FleetConfig(tenants=4))
    t_run_fleet(tf, cfg, device="cpu", registry=TRegistry())
    assert len(keys) == 3 and len(set(keys)) == 1 and keys[0][0] == "fleet_global_solve"


def test_fleet_bodies_read_nothing_back(guarded_bodies):  # noqa: F811
    """The fleet's device bodies read nothing back to the host (a read
    inside a capture fails on the card): the greedy decision, the global
    solve on both lowerings and the fleet scan block."""
    _, tf = fleets(2)
    cfg = RescheduleConfig(algorithm="random", max_rounds=2, sleep_after_action_s=0.0,
                           fleet=FleetConfig(tenants=2))
    t_run_fleet(tf, cfg, device="cpu", registry=TRegistry())
    t_run_fleet(fleets(2)[1], dataclasses.replace(cfg, scan_block=2), device="cpu",
                registry=TRegistry())
    t_states, t_graphs = snapshots(fleets(2)[1])
    for mode in ("off", "on"):
        tfg.fleet_global_solve(t_states, t_graphs, torch.ones(2, dtype=torch.bool),
                               config=tgs.GlobalSolverConfig(sweeps=2, fused_epilogue=mode),
                               generators=[round_generator(1, 0), round_generator(2, 0)])
    assert guarded_bodies == ["fleet_solve"] * 2 + ["fleet_scan_rounds"] + \
        ["fleet_global_solve"] * 2


# ---------------- the multiplexed global loop ----------------


def global_plans(seed: int, t: int, S: int, N: int, sweeps: int):
    """Tenant ``t``'s ``solver_plans`` seam: the JAX fleet's global round
    key is ``fold_in(fold_in(key, t), round)``, handed to the solver whole."""
    cfg = jgs.GlobalSolverConfig(sweeps=sweeps)

    def plans(rnd: int):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), t), rnd)
        return jax_plan(key, cfg, S, N, inline=False)
    return plans


def test_fleet_global_controller_matches_n_solo_controllers():
    """tests/test_fleet_v2.py:375: the port's global fleet loop equals the
    JAX one (balance weight 0, the JAX key stream's plans) tenant by
    tenant, and — at balance weight 0.5, on its own draws — the port's
    solo global loops of seeds ``tenant_seed(seed, t)``."""
    seed, rounds, sweeps = 0, 3, 9
    jf, tf = fleets(3, imbalance=False)
    kw = dict(algorithm="global", max_rounds=rounds, sleep_after_action_s=0.0, seed=seed)
    j = j_run_fleet(jf, JConfig(**kw, fleet=JFleetConfig(tenants=3)),
                    key=jax.random.PRNGKey(seed), registry=JRegistry())
    S, N = tf.backends[0].comm_graph().num_services, len(tf.backends[0].node_names)
    t = t_run_fleet(tf, RescheduleConfig(**kw, fleet=FleetConfig(tenants=3)), device="cpu",
                    registry=TRegistry(),
                    solver_plans=[global_plans(seed, i, S, N, sweeps) for i in range(3)])
    for name in t.tenants:
        tr, jr = t.results[name].rounds, j.results[name].rounds
        assert len(tr) == len(jr) == rounds
        for a, b in zip(tr, jr):
            for k in DECISIONS:
                if k in ("objective_before", "objective_after"):
                    assert getattr(a, k) == pytest.approx(getattr(b, k), rel=1e-6)
                else:
                    assert getattr(a, k) == getattr(b, k), (name, a.round, k)
            assert a.communication_cost == b.communication_cost
            assert a.load_std == pytest.approx(b.load_std, rel=1e-6)
    assert tf.events() == jf.events()
    assert any(r.moved for res in t.results.values() for r in res.rounds)
    # the port's own solo loops at balance weight 0.5
    kw.update(balance_weight=0.5, move_cost=0.25)
    _, tf = fleets(3, seed=1)
    t = t_run_fleet(tf, RescheduleConfig(**kw, fleet=FleetConfig(tenants=3)), device="cpu",
                    registry=TRegistry())
    _, sf = fleets(3, seed=1)
    for i, (name, backend) in enumerate(sf):
        solo = t_run(backend, RescheduleConfig(**{**kw, "seed": tenant_seed(seed, i)}),
                     device="cpu", registry=TRegistry())
        assert [strip(r) for r in solo.rounds] == [strip(r) for r in t.results[name].rounds]


def _hetero(package):
    """tests/test_fleet_v2.py:419's two tenants: µBench, and µBench with one
    more service deployed."""
    make, kw = (j_make, {}) if package == "jax" else (t_make, {"device": "cpu"})

    def small():
        b = make("mubench", 1, **kw)
        b.inject_imbalance(b.node_names[0])
        return b

    big = make("mubench", 2, **kw)
    big.deploy_service(dataclasses.replace(big.workmodel.services[0], name="extra-svc",
                                           replicas=2))
    big.inject_imbalance(big.node_names[0])
    return small, big


@pytest.mark.parametrize("algorithm", ["communication", "global"])
def test_fleet_heterogeneous_tenants_match_unpadded_solo(algorithm):
    """tests/test_fleet_v2.py:419: two tenants of different sizes padded to
    one shared power-of-two bucket; the smaller tenant's records equal its
    unpadded solo run's, and the JAX fleet's decisions."""
    reg = TRegistry()
    small, big = _hetero("torch")
    kw = dict(algorithm=algorithm, max_rounds=3, sleep_after_action_s=0.0, seed=5)
    res = t_run_fleet(FleetBackend(backends=[small(), big]),
                      RescheduleConfig(**kw, fleet=FleetConfig(tenants=2)), device="cpu",
                      registry=reg)
    svc_cap = int(reg.gauge("fleet_bucket_services").value)
    assert svc_cap >= 21 and svc_cap & (svc_cap - 1) == 0
    solo = t_run(small(), RescheduleConfig(**{**kw, "seed": tenant_seed(5, 0)}), device="cpu",
                 registry=TRegistry())
    fr = res.results["tenant0"].rounds
    assert len(fr) == len(solo.rounds) == 3
    for a, b in zip(solo.rounds, fr):
        sa, sb = strip(a), strip(b)
        if algorithm == "global":
            # the solver's objectives are over the padded shapes' sums: equal
            # to the unpadded ones within f32 order
            for k in ("objective_before", "objective_after"):
                assert sb.pop(k) == pytest.approx(sa.pop(k), rel=1e-6)
        assert sa == sb
    if algorithm == "communication":
        j_small, j_big = _hetero("jax")
        j = j_run_fleet(JFleetBackend(backends=[j_small(), j_big]),
                        JConfig(**kw, fleet=JFleetConfig(tenants=2)),
                        key=jax.random.PRNGKey(5), registry=JRegistry())
        for a, b in zip(fr, j.results["tenant0"].rounds):
            assert (a.most_hazard, a.service, a.target, a.moved) == \
                (b.most_hazard, b.service, b.target, b.moved)
            assert a.communication_cost == b.communication_cost


@pytest.mark.parametrize("algorithm", ["communication", "global"])
def test_fleet_one_transfer_per_round(algorithm):
    """tests/test_fleet_v2.py:509: per executed round exactly one
    ``fleet_decision`` read and one ``fleet_metrics`` read, on both
    planes."""
    reg = TRegistry()
    cfg = RescheduleConfig(algorithm=algorithm, max_rounds=3, sleep_after_action_s=0.0,
                           balance_weight=0.5, fleet=FleetConfig(tenants=2))
    t_run_fleet(fleets(2)[1], cfg, device="cpu", registry=reg)
    transfers = reg.counter("device_transfers_total", labelnames=("site",))
    assert transfers.labels(site="fleet_decision").value == 3
    assert transfers.labels(site="fleet_metrics").value == 3
    assert transfers.labels(site="round_end").value == 0
    assert transfers.labels(site="fence").value == 0


def test_solver_cache_evicts_on_churn():
    """tests/test_fleet_v2.py:585."""
    reg = TRegistry()
    _, tf = fleets(2)
    ba = BoundaryClient(tf.backends[0], tenant="tenant0", registry=reg)
    slot = ba.solver_cache("sparse_graph")
    slot["graph"], slot["value"] = "g-old", "v-old"
    assert ba.evict_solver_caches(reason="churn") == 1
    assert ba.solver_cache("sparse_graph") == {}
    evs = reg.counter("solver_cache_evictions_total", labelnames=("reason",))
    assert evs.labels(reason="churn").value == 1
    ba.solver_cache("sparse_graph").clear()
    tf.backends[0]._solver_caches.clear()
    assert ba.evict_solver_caches(reason="churn") == 0


@pytest.mark.parametrize("algorithm", ["communication", "global"])
def test_fleet_loop_evicts_caches_under_deploy_waves(algorithm):
    """tests/test_fleet_v2.py:607: a deploy-waves fleet soak counts cache
    evictions when churn rewrites a tenant's graph, and no stale slot
    survives; on the global plane the staged adjacency keeps the capture
    key to one a bucket shape."""
    reg = TRegistry()
    _, tf = fleets(2)
    for t, b in enumerate(tf.backends):
        BoundaryClient(b, tenant=f"tenant{t}").solver_cache("sparse_graph")["value"] = \
            f"stale-{t}"
    cfg = RescheduleConfig(algorithm=algorithm, max_rounds=6, sleep_after_action_s=0.0,
                           global_solver_iters=2, fleet=FleetConfig(tenants=2),
                           elastic="deploy-waves", elastic_seed=3)
    res = t_run_fleet(tf, cfg, device="cpu", registry=reg)
    evs = reg.counter("solver_cache_evictions_total", labelnames=("reason",))
    assert sum(evs.labels(reason=r).value for r in ("churn", "promotion")) >= 1
    caches = getattr(tf.backends[0], "_solver_caches", {})
    assert all("stale" not in str(v) for v in caches.values())
    for r in res.results.values():
        assert len(r.rounds) + r.skipped_rounds == 6
    assert any(rec.churn and rec.churn["events"] for r in res.results.values()
               for rec in r.rounds)
