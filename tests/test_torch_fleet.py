"""Fleet mode's greedy plane and multiplexed loop in the port, against the
JAX package's (tests/test_fleet.py:83-493) and against the port's own solo
loop.

Inputs: ``make_fleet`` of both packages builds the same tenants from the
same seeds; the ``random`` policy's noise rows are the JAX key stream's
(tenant ``t``, round ``r``: ``gumbel(split(fold_in(fold_in(key, t), r))[1],
(N,))``), fed to the port through the per-tenant ``gumbel_rows`` seams.

Bars: decisions, hazard masks, moves, landings, skips and counts are
exactly equal; the communication cost is exactly equal (integer pair
counts); the load std is within rel 1e-6 (an f32 std whose reductions may
run in another order). Against the port's solo loop on the same noise
rows every record field but timing is equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_controller import DECISIONS
from test_torch_sim_device import strip

from kubernetes_rescheduling_tpu.backends.fleet import make_fleet as j_make_fleet
from kubernetes_rescheduling_tpu.bench.fleet import run_fleet_controller as j_run_fleet
from kubernetes_rescheduling_tpu.config import FleetConfig as JFleetConfig
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.solver import fleet as jfleet
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu_torch import cli as t_cli
from kubernetes_rescheduling_tpu_torch._random import tenant_seed
from kubernetes_rescheduling_tpu_torch.backends.fleet import FleetBackend
from kubernetes_rescheduling_tpu_torch.backends.fleet import make_fleet as t_make_fleet
from kubernetes_rescheduling_tpu_torch.bench.boundary import BoundaryClient
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.fleet import run_fleet_controller as t_run_fleet
from kubernetes_rescheduling_tpu_torch.config import FleetConfig, RescheduleConfig
from kubernetes_rescheduling_tpu_torch.objectives.metrics import (
    comm_edge_list,
    communication_cost,
    load_std,
)
from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS
from kubernetes_rescheduling_tpu_torch.solver import compiled
from kubernetes_rescheduling_tpu_torch.solver import fleet as tfleet
from kubernetes_rescheduling_tpu_torch.solver.round_loop import decide
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry

POLICIES = ["spread", "binpack", "random", "kubescheduling", "communication"]


def fleets(n=3, seed=0, imbalance=True):
    """The same µBench fleet in both packages, by default with every
    tenant's cordon imbalance injected."""
    jf, tf = j_make_fleet("mubench", n, seed=seed), t_make_fleet("mubench", n, seed=seed,
                                                                 device="cpu")
    if imbalance:
        jf.inject_imbalance()
        tf.inject_imbalance()
    return jf, tf


def snapshots(fleet):
    return [b.monitor() for b in fleet.backends], [b.comm_graph() for b in fleet.backends]


def jax_keys(n, seed=0):
    return jnp.stack([jax.random.fold_in(jax.random.PRNGKey(seed), t) for t in range(n)])


def jax_fleet_gumbel(seed: int, t: int, n: int):
    """Tenant ``t``'s ``gumbel_rows`` seam: the noise row the JAX fleet loop
    draws for the tenant in round ``rnd``."""
    def rows(rnd: int, i: int) -> torch.Tensor:
        assert i == 0
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), t), rnd)
        return torch.tensor(np.asarray(jax.random.gumbel(jax.random.split(key)[1], (n,))))
    return rows


# ---------------- the batched decision ----------------


@pytest.mark.parametrize("policy", POLICIES)
def test_fleet_solve_bit_exact_vs_solo(policy):
    """tests/test_fleet.py:83: the fleet decision equals the JAX fleet
    decision (JAX's noise rows for ``random``) and the port's solo
    ``decide`` per tenant, exactly."""
    jf, tf = fleets(3)
    j_states, j_graphs = snapshots(jf)
    t_states, t_graphs = snapshots(tf)
    keys = jax_keys(3)
    mask = np.ones(3, bool)
    j_dec, j_hz = jfleet.fleet_solve(jfleet.stack_tenants(j_states),
                                     jfleet.stack_tenants(j_graphs),
                                     jnp.asarray(POLICY_IDS[policy]), jnp.asarray(30.0), keys,
                                     jnp.asarray(mask))
    n = t_states[0].num_nodes
    gumbel = torch.stack([torch.tensor(np.asarray(jax.random.gumbel(k, (n,)))) for k in keys])
    t_dec, t_hz = tfleet.fleet_solve(tfleet.stack_tenants(t_states), t_graphs,
                                     POLICY_IDS[policy], 30.0, torch.from_numpy(mask),
                                     gumbel if policy == "random" else None)
    np.testing.assert_array_equal(t_dec.numpy(), np.asarray(j_dec))
    np.testing.assert_array_equal(t_hz.numpy(), np.asarray(j_hz))
    for t in range(3):
        g = gumbel[t] if policy == "random" else None
        most, hz, victim, svc, target = decide(t_states[t], t_graphs[t], POLICY_IDS[policy],
                                               30.0, g)
        assert t_dec[t].tolist() == [int(most), int(victim), int(svc), int(target)]
        assert torch.equal(t_hz[t], hz)


def test_padded_tenant_slot_never_emits_moves():
    """tests/test_fleet.py:127: a masked slot is the no-op row, all-False
    hazard, whatever its state; the JAX package packs the same rows."""
    jf, tf = fleets(3)
    j_states, j_graphs = snapshots(jf)
    t_states, t_graphs = snapshots(tf)
    mask = np.array([True, False, True])
    st = tfleet.stack_tenants(t_states)
    for rnd in range(1, 4):
        j_dec, _ = jfleet.fleet_solve(jfleet.stack_tenants(j_states),
                                      jfleet.stack_tenants(j_graphs),
                                      jnp.asarray(POLICY_IDS["communication"]),
                                      jnp.asarray(30.0), jax_keys(3, rnd), jnp.asarray(mask))
        dec, hz = tfleet.fleet_solve(st, t_graphs, POLICY_IDS["communication"], 30.0,
                                     torch.from_numpy(mask))
        np.testing.assert_array_equal(dec.numpy(), np.asarray(j_dec))
        assert dec[1].tolist() == [-1, -1, 0, -1]
        assert not hz[1].any()


def test_fleet_solve_one_capture_key(monkeypatch):
    """The counterpart of tests/test_fleet.py:151 (one trace in steady
    state): every round of a fleet hands the capture cache the same key, so
    on the card it captures once and replays."""
    keys = []
    real = compiled.GraphCache.run

    def record(self, fn, key, inputs, make_body, operands=()):
        keys.append(compiled.GraphCache._full_key(fn, key, inputs, operands))
        return real(self, fn, key, inputs, make_body, operands)

    monkeypatch.setattr(compiled.GraphCache, "run", record)
    _, tf = fleets(5)
    cfg = RescheduleConfig(algorithm="communication", max_rounds=5, sleep_after_action_s=0.0,
                           fleet=FleetConfig(tenants=5))
    t_run_fleet(tf, cfg, device="cpu", registry=TRegistry())
    assert len(keys) == 5 and len(set(keys)) == 1 and keys[0][0] == "fleet_solve"


def test_fleet_solve_proactive_refused():
    """The proactive fleet plane is carried on one device; sharding its
    tenants over devices (``plane="dp"``) waits with multi-device."""
    RescheduleConfig(algorithm="proactive", fleet=FleetConfig(tenants=2)).validate()
    with pytest.raises(ValueError, match=r"ROADMAP Queue 1 item 5\b"):
        RescheduleConfig(algorithm="proactive",
                         fleet=FleetConfig(tenants=2, plane="dp")).validate()


def test_stack_tenants_rejects_mismatched_shapes():
    """tests/test_fleet.py:163."""
    _, tf = fleets(2)
    states, _ = snapshots(tf)
    small = states[1].replace(pod_node=states[1].pod_node[:-1])
    with pytest.raises(ValueError, match="tenant 1 .*common capacity"):
        tfleet.stack_tenants([states[0], small])
    with pytest.raises(ValueError, match="at least one"):
        tfleet.stack_tenants([])


def test_fleet_metrics_matches_solo_objectives():
    """tests/test_fleet.py:171: the fleet's per-tenant pair equals the JAX
    fleet's (cost exact, load std rel 1e-6) and the port's solo metrics."""
    jf, tf = fleets(3)
    j_states, j_graphs = snapshots(jf)
    t_states, t_graphs = snapshots(tf)
    j_m = np.asarray(jfleet.fleet_metrics(jfleet.stack_tenants(j_states),
                                          jfleet.stack_tenants(j_graphs)))
    edges = [comm_edge_list(g) for g in t_graphs]
    for stacked in (tfleet.stack_tenants(t_states), t_states):
        t_m = tfleet.fleet_metrics(stacked, t_graphs, edges).numpy()
        np.testing.assert_array_equal(t_m[:, 0], j_m[:, 0])
        np.testing.assert_allclose(t_m[:, 1], j_m[:, 1], rtol=1e-6)
    for t in range(3):
        assert t_m[t, 0] == float(communication_cost(t_states[t], t_graphs[t]))
        assert t_m[t, 1] == float(load_std(t_states[t]))


# ---------------- the multiplexed loop ----------------


@pytest.mark.parametrize("policy", ["communication", "random"])
def test_fleet_controller_matches_n_solo_controllers(policy):
    """tests/test_fleet.py:192: the port's fleet loop equals the JAX fleet
    loop tenant by tenant (the JAX key stream's noise), and the port's own
    solo loops on the same rows."""
    seed, rounds = 3, 4
    jf, tf = fleets(3, seed=1)
    kw = dict(algorithm=policy, max_rounds=rounds, sleep_after_action_s=0.0, seed=seed)
    j = j_run_fleet(jf, JConfig(**kw, fleet=JFleetConfig(tenants=3)),
                    key=jax.random.PRNGKey(seed), registry=JRegistry())
    n = len(tf.backends[0].node_names)
    t = t_run_fleet(tf, RescheduleConfig(**kw, fleet=FleetConfig(tenants=3)), device="cpu",
                    registry=TRegistry(),
                    gumbel_rows=[jax_fleet_gumbel(seed, i, n) for i in range(3)])
    assert t.tenants == j.tenants == ("tenant0", "tenant1", "tenant2")
    for name in t.tenants:
        tr, jr = t.results[name].rounds, j.results[name].rounds
        assert len(tr) == len(jr) == rounds
        for a, b in zip(tr, jr):
            for k in DECISIONS:
                assert getattr(a, k) == getattr(b, k), (name, a.round, k)
            assert a.communication_cost == b.communication_cost
            assert a.load_std == pytest.approx(b.load_std, rel=1e-6)
    assert tf.events() == jf.events()
    # the port's own solo loops, on the same noise rows
    _, sf = fleets(3, seed=1)
    for i, (name, backend) in enumerate(sf):
        solo = t_run(backend, RescheduleConfig(**{**kw, "seed": tenant_seed(seed, i)}),
                     device="cpu", registry=TRegistry(),
                     gumbel_rows=jax_fleet_gumbel(seed, i, n))
        assert [strip(r) for r in solo.rounds] == [strip(r) for r in t.results[name].rounds]


def test_fleet_round_accounting_and_metrics():
    """tests/test_fleet.py:225: per-tenant accounting, the registry's
    per-tenant families, one batched decision a round, and the /healthz
    fleet block (tests/test_fleet.py:340, kept on the result)."""
    reg = TRegistry()
    _, tf = fleets(3)
    cfg = RescheduleConfig(algorithm="communication", max_rounds=3, sleep_after_action_s=0.0,
                           fleet=FleetConfig(tenants=3))
    res = t_run_fleet(tf, cfg, device="cpu", registry=reg)
    assert res.tenants == ("tenant0", "tenant1", "tenant2")
    assert reg.gauge("fleet_tenants").value == 3
    rounds_c = reg.counter("fleet_rounds_total", labelnames=("tenant",))
    for name, r in res.results.items():
        assert len(r.rounds) + r.skipped_rounds == 3
        assert rounds_c.labels(tenant=name).value == len(r.rounds)
    assert res.batched_solves == 3
    assert res.device_solve_s > 0
    assert res.amortized_solve_ms_per_tenant_round > 0
    assert set(res.health) == set(res.tenants)
    for row in res.health.values():
        assert row == {"breaker": "closed", "rounds": 3, "skipped_rounds": 0,
                       "degraded_rounds": 0}


def test_cli_fleet_reschedule(capsys):
    """tests/test_fleet.py:359 on the port: ``reschedule --fleet``."""
    assert t_cli.main(["reschedule", "--fleet", "2", "--rounds", "2", "--imbalance",
                       "--scenario", "mubench", "--seed", "1", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["fleet"] == {"tenants": 2, "plane": "vmap"}
    assert set(out["per_tenant"]) == {"tenant0", "tenant1"}
    for row in out["per_tenant"].values():
        assert row["rounds"] + row["skipped_rounds"] == 2
    assert out["batched_solves"] == 2


@pytest.mark.parametrize("argv,match", [
    (["--backend", "k8s"], "sim backend"),
    (["--moves-per-round", "3"], "greedy"),
    (["--algorithm", "global", "--solver-backend", "sparse"], "sparse"),
    (["--fleet-plane", "dp"], r"ROADMAP Queue 1 item 5\b"),
    (["--fleet-chaos-tenants", "2", "--chaos-profile", "soak"], "chaos tenant 2 out of range"),
    (["--algorithm", "proactive", "--fleet-plane", "dp"], r"ROADMAP Queue 1 item 5\b"),
    (["--pipeline", "--scan-block", "4"], "mutually exclusive"),
], ids=["k8s", "multi-move", "sparse", "dp", "chaos-tenants", "proactive", "pipeline"])
def test_cli_fleet_refusals(argv, match):
    """tests/test_fleet.py:376-400: what fleet mode cannot batch exits with
    its reason, what the JAX package refuses of a carried plane (a chaos
    tenant out of range, a pipelined fleet scan) is refused for its reason,
    and what the port does not carry names its ROADMAP item."""
    with pytest.raises(SystemExit, match=match):
        t_cli.main(["reschedule", "--fleet", "2", "--device", "cpu", *argv])


# ---------------- config and backend surfaces ----------------


def test_fleet_config_validation():
    """tests/test_fleet.py:417: what the JAX package accepts and refuses,
    and the port's refusals naming their ROADMAP items."""
    FleetConfig(tenants=4).validate()
    with pytest.raises(ValueError, match="plane"):
        FleetConfig(plane="pmap").validate()
    with pytest.raises(ValueError, match="out of range"):
        FleetConfig(tenants=2, chaos_tenants=(2,)).validate()
    with pytest.raises(ValueError, match=r"ROADMAP Queue 1 item 5\b"):
        FleetConfig(tenants=4, plane="dp").validate()
    # chaos tenants are carried
    FleetConfig(tenants=4, chaos_tenants=(0, 3)).validate()
    RescheduleConfig(chaos="soak", fleet=FleetConfig(tenants=4, chaos_tenants=(3,))).validate()
    RescheduleConfig(algorithm="global", fleet=FleetConfig(tenants=2)).validate()
    RescheduleConfig(moves_per_round="all", fleet=FleetConfig(tenants=2)).validate()
    RescheduleConfig(algorithm="proactive", fleet=FleetConfig(tenants=2)).validate()
    with pytest.raises(ValueError, match=r"ROADMAP Queue 1 item 5\b"):
        RescheduleConfig(algorithm="proactive",
                         fleet=FleetConfig(tenants=2, plane="dp")).validate()
    # the pipelined fleet is carried; the JAX package refuses it only as it
    # refuses any pipelined run
    RescheduleConfig(pipeline=True, fleet=FleetConfig(tenants=2)).validate()
    RescheduleConfig(algorithm="global", pipeline=True, fleet=FleetConfig(tenants=2)).validate()
    with pytest.raises(ValueError, match="mutually exclusive"):
        RescheduleConfig(pipeline=True, scan_block=4, fleet=FleetConfig(tenants=2)).validate()
    with pytest.raises(ValueError, match="depth must be 2"):
        RescheduleConfig(pipeline=True, pipeline_depth=3,
                         fleet=FleetConfig(tenants=2)).validate()
    with pytest.raises(ValueError, match="greedy"):
        RescheduleConfig(moves_per_round=2, fleet=FleetConfig(tenants=2)).validate()
    with pytest.raises(ValueError, match="sparse"):
        RescheduleConfig(algorithm="global", solver_backend="sparse",
                         fleet=FleetConfig(tenants=2)).validate()
    with pytest.raises(ValueError, match="move_cost"):
        RescheduleConfig(algorithm="global", global_moves_cap=2,
                         fleet=FleetConfig(tenants=2)).validate()
    with pytest.raises(ValueError, match="placement_unit"):
        RescheduleConfig(algorithm="global", placement_unit="pod",
                         fleet=FleetConfig(tenants=2)).validate()
    with pytest.raises(ValueError, match="fleet mode does not compose with solver_tp yet"):
        RescheduleConfig(algorithm="global", solver_tp=2,
                         fleet=FleetConfig(tenants=2)).validate()
    with pytest.raises(ValueError, match=r"fleet restarts.*ROADMAP Queue 1 item 5\b"):
        RescheduleConfig(algorithm="global", solver_restarts=2,
                         fleet=FleetConfig(tenants=2)).validate()
    # the loop holds the fleet gate even with the fleet block off
    with pytest.raises(ValueError, match="greedy"):
        t_run_fleet(t_make_fleet("mubench", 2, device="cpu"),
                    RescheduleConfig(moves_per_round=2), device="cpu")
    with pytest.raises(ValueError, match="backend has 2 tenants"):
        t_run_fleet(t_make_fleet("mubench", 2, device="cpu"),
                    RescheduleConfig(fleet=FleetConfig(tenants=3)), device="cpu")


def test_fleet_backend_surface():
    """tests/test_fleet.py:463."""
    fleet = t_make_fleet("mubench", 2, seed=0, device="cpu")
    assert fleet.num_tenants == 2
    assert fleet.tenant_names == ["tenant0", "tenant1"]
    assert [len(b.node_names) for b in fleet.backends] == [3, 3]
    with pytest.raises(ValueError, match="unique"):
        FleetBackend(backends=fleet.backends, tenant_names=["a", "a"])
    with pytest.raises(ValueError, match="at least one"):
        FleetBackend(backends=[])
    with pytest.raises(ValueError, match=">= 1"):
        t_make_fleet("mubench", 0, device="cpu")


def test_solver_cache_is_tenant_aware():
    """tests/test_fleet.py:493: two tenants over one backend keep separate
    cache slots; the solo controller (tenant None) keeps its own."""
    _, tf = fleets(1)
    backend = tf.backends[0]
    ba, bb = BoundaryClient(backend, tenant="a"), BoundaryClient(backend, tenant="b")
    ca, cb = ba.solver_cache("sparse_graph"), bb.solver_cache("sparse_graph")
    assert ca is not cb
    ca["graph"], ca["value"] = "ga", "va"
    cb["graph"], cb["value"] = "gb", "vb"
    for _ in range(3):
        assert ba.solver_cache("sparse_graph")["value"] == "va"
        assert bb.solver_cache("sparse_graph")["value"] == "vb"
    assert ba.solver_cache("pod_graph") == {}
    assert BoundaryClient(backend).solver_cache("sparse_graph") == {}
