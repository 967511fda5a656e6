"""The global wave cap (``global_moves_cap=k``) and the host form of the
objective's balance terms, against the JAX package on the CPU.

``_top_gain_moves`` and ``_individual_move_gains`` are host numpy in both
packages; their ties and their 1e-9 threshold depend on the dtypes of the
arrays they read (f32 loads and capacities, f64 per-service sums, i64
replica counts), so the triples are compared exactly, gains included.

The JAX package's own property test of ``_top_gain_moves``
(tests/test_properties.py::test_top_gain_moves_invariants) checks its
``(service, target, gain)`` triples against ``(service, target)`` pairs and
so fails on every instance; the property is stated on pairs here.
"""

import json

import numpy as np
import pytest
import torch
from test_torch_controller import _global_plans, assert_same_records

from kubernetes_rescheduling_tpu.bench import controller as jc
from kubernetes_rescheduling_tpu.bench.harness import make_backend as j_make
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.core.state import ClusterState as JState
from kubernetes_rescheduling_tpu.core.state import CommGraph as JGraph
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu_torch.bench import controller as tc
from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend as t_make
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState as TState
from kubernetes_rescheduling_tpu_torch.core.state import CommGraph as TGraph
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry


def gain_instance(seed: int, *, tight: bool = False):
    """tests/test_properties.py:270's instance (8 services, 3 nodes, random
    relations, one pod a service, CPU in [0, 100)) in both packages, with a
    random candidate list; ``tight`` gives every pod memory and caps that
    bind, for the capacity-enforced form."""
    rng = np.random.default_rng(seed)
    s, n = 8, 3
    names = [f"s{i}" for i in range(s)]
    rel = {names[i]: [names[j] for j in range(s) if i != j and rng.random() < 0.4]
           for i in range(s)}
    cpu = (rng.random(s) * 100).tolist()
    kw = dict(
        node_names=[f"n{i}" for i in range(n)],
        node_cpu_cap=[160.0 if tight else 1000.0] * n,
        node_mem_cap=[3e8 if tight else 2**30] * n,
        pod_services=list(range(s)),
        pod_nodes=rng.integers(0, n, s).tolist(),
        pod_cpu=cpu,
        pod_mem=(rng.random(s) * 1e8).tolist() if tight else [0.0] * s,
        pod_names=[f"{nm}-0" for nm in names],
    )
    changed = [(int(i), int(rng.integers(0, n)))
               for i in rng.permutation(s)[: rng.integers(1, s)]]
    k = int(rng.integers(1, 7))
    j = (JState.build(**kw), JGraph.from_relation(rel, names=names))
    t = (TState.build(**kw, device="cpu"), TGraph.from_relation(rel, names=names, device="cpu"))
    return j, t, changed, k


@pytest.mark.parametrize("tight", [False, True], ids=["free", "capacity"])
def test_wave_cap_selection_matches_jax(tight):
    """20 seeded instances each: equal ``(service, target, gain)`` triples
    from ``_top_gain_moves`` and ``_individual_move_gains``, at λ = 0.5
    (with capacity enforced on tight caps in the second case), and the
    property on pairs: ⊆ changed, ≤ k, strictly improving, in changed's
    order."""
    kw = dict(balance_weight=0.5, enforce_capacity=tight, capacity_frac=0.9 if tight else 1.0,
              overload_weight=2.0 if tight else 10.0)
    jcfg, tcfg = jgs.GlobalSolverConfig(**kw), tgs.GlobalSolverConfig(**kw)
    picked = 0
    for seed in range(20):
        (js, jg), (ts, tg), changed, k = gain_instance(seed, tight=tight)
        want = jc._top_gain_moves(changed, js, jg, jcfg, k)
        got = tc._top_gain_moves(changed, ts, tg, tcfg, k)
        assert got == want, seed
        assert tc._individual_move_gains(changed, ts, tg, tcfg) == jc._individual_move_gains(
            changed, js, jg, jcfg), seed
        pairs = [(s, t) for s, t, _ in got]
        assert len(pairs) <= k and all(p in changed for p in pairs)
        idx = [changed.index(p) for p in pairs]
        assert idx == sorted(idx)
        assert all(g > 1e-9 for _, _, g in got)
        picked += len(got)
    assert picked > 0


def test_balance_terms_numpy_and_torch_agree():
    """The objective's balance terms in one expression: the torch form the
    solvers use and the numpy form the wave cap ranks with agree within
    f32 rounding, and the numpy form equals the JAX package's numpy
    evaluation exactly."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        n = int(rng.integers(2, 40))
        loads = (rng.random(n) * 3000).astype(np.float32)
        cap = np.where(rng.random(n) < 0.1, 1.0, rng.random(n) * 2000 + 100).astype(np.float32)
        valid = rng.random(n) < 0.8
        lam, ow = float(rng.random()), float(rng.random() * 10)
        host = tgs.pct_balance_terms(loads, cap, valid, lam, ow, xp=np)
        assert host == jgs.pct_balance_terms(loads, cap, valid, lam, ow, xp=np)
        dev = tgs.pct_balance_terms(torch.as_tensor(loads), torch.as_tensor(cap),
                                    torch.as_tensor(valid), lam, ow)
        assert float(dev) == pytest.approx(float(host), rel=1e-5, abs=1e-4)


def capped_pair(cap, rounds, registry=None):
    """tests/test_bench.py:423's run in both packages: µBench seed 2 with
    worker1 piled, global rounds at λ = 0.5."""
    seed = 2
    jb, tb = j_make("mubench", seed), t_make("mubench", seed, device="cpu")
    jb.inject_imbalance("worker1")
    tb.inject_imbalance("worker1")
    kw = dict(algorithm="global", max_rounds=rounds, sleep_after_action_s=0.0,
              balance_weight=0.5, global_moves_cap=cap, seed=seed)
    j = jc.run_controller(jb, JConfig(**kw), registry=JRegistry())
    plans, _ = _global_plans(tb, seed, 9, "dense")
    t = tc.run_controller(tb, TConfig(**kw), device="cpu", solver_plans=plans,
                          registry=registry or TRegistry())
    return jb, tb, j, t


def test_capped_controller_matches_jax_and_converges():
    """Cap 2 for 12 rounds: record for record as the JAX package (moved
    services, objectives, costs), at most 2 services a round, the solver
    objective never rising, and the last wave empty."""
    reg = TRegistry()
    jb, tb, j, t = capped_pair(2, 12, registry=reg)
    assert_same_records(t, j)
    assert tb.events == jb.events
    assert all(len(r.services_moved) <= 2 for r in t.rounds)
    objs = [r.communication_cost + 0.5 * r.load_std for r in t.rounds]
    assert all(b <= a + 1e-5 for a, b in zip(objs, objs[1:]))
    assert t.rounds[-1].services_moved == ()
    # one read of the scoring inputs per capped round, timed as "select"
    assert reg.value("device_transfers_total", site="move_gains") == len(t.rounds)
    assert all("select" in r.phase_s for r in t.rounds)


def test_uncapped_round_moves_every_changed_service():
    jb, tb, j, t = capped_pair("all", 2)
    assert_same_records(t, j)
    assert any(len(r.services_moved) > 2 for r in t.rounds)


def test_gain_env_reads_only_the_changed_rows():
    """The scoring inputs come home in one transfer holding only the
    adjacency rows of the changed services."""
    (_, _), (ts, tg), changed, _ = gain_instance(4)
    reg = TRegistry()
    env = tc._move_scoring_env(ts, tg, tgs.GlobalSolverConfig(), [s for s, _ in changed],
                               registry=reg)
    assert sorted(env.adj) == sorted({s for s, _ in changed})
    assert reg.value("device_transfers_total", site="move_gains") == 1
    for s, row in env.adj.items():
        np.testing.assert_array_equal(row, tg.adj[s].numpy())


def test_cli_global_moves_cap(capsys):
    """``reschedule --global-moves-cap k`` as in the JAX command."""
    from kubernetes_rescheduling_tpu_torch import cli

    assert cli.main(["reschedule", "--algorithm", "global", "--scenario", "mubench",
                     "--imbalance", "--rounds", "3", "--balance-weight", "0.5",
                     "--global-moves-cap", "2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert len(out["rounds"]) == 3 and out["moves"] >= 1
    assert all(len(r["services_moved"]) <= 2 for r in out["rounds"])
