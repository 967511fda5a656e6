"""The port's latency-budget autotuner against the JAX package's
``solver/autotune.py``.

With both ``_device_ms_per_round`` replaced by the same timing model, the
two ``tune_sweeps`` must make the same decision and report the same
``info``, rounding included. The measurement itself runs here on the CPU
(its chained solves eager, timed by the host clock): each solve of a chain
takes the previous one's state and draws its plans from the generator of
``(seed, i)``.
"""

import json

import pytest

from kubernetes_rescheduling_tpu.solver import autotune as jat
from kubernetes_rescheduling_tpu.solver import global_solver as jgs
from kubernetes_rescheduling_tpu_torch import cli
from kubernetes_rescheduling_tpu_torch._random import round_generator
from kubernetes_rescheduling_tpu_torch.core.topology import synthetic_scenario
from kubernetes_rescheduling_tpu_torch.solver import autotune as tat
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs

MODELS = {
    "linear": lambda sweeps: 4.0 + 2.5 * sweeps,
    "fractional": lambda sweeps: 0.123456 + 1.0 / 3.0 * sweeps,
    "flat": lambda sweeps: 7.0,            # per-sweep cost clamps to 1e-3 ms
    "steep": lambda sweeps: 30.0 * sweeps,  # fixed cost clamps to 0
}


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("budget", [0.5, 10.0, 100.0, 1000.0])
def test_same_decision_and_info_as_jax(monkeypatch, model, budget):
    ms = MODELS[model]
    monkeypatch.setattr(jat, "_device_ms_per_round",
                        lambda solver, state, graph, config: ms(config.sweeps))
    monkeypatch.setattr(tat, "_device_ms_per_round",
                        lambda solver, state, graph, config: ms(config.sweeps))
    j_cfg, j_info = jat.tune_sweeps(None, None, jgs.GlobalSolverConfig(balance_weight=0.5),
                                    budget)
    t_cfg, t_info = tat.tune_sweeps(None, None, tgs.GlobalSolverConfig(balance_weight=0.5),
                                    budget)
    assert t_info == j_info
    assert t_cfg.sweeps == j_cfg.sweeps == t_info["sweeps"]
    assert t_cfg.balance_weight == 0.5
    assert 1 <= t_cfg.sweeps <= 64


def test_budget_must_be_positive():
    for tune in (jat.tune_sweeps, tat.tune_sweeps):
        with pytest.raises(ValueError, match="latency budget"):
            tune(None, None, None, 0.0)


def test_chained_solves_feed_each_other_on_the_cpu():
    """Every chain: k solves, each on the previous one's output state, with
    the generator of ``(seed, i)``; a warm chain (seed 7), then two timed
    ones (8, 9) for each of k1 = 2 and k2 = 8."""
    scn = synthetic_scenario(n_pods=64, n_nodes=8, seed=3, device="cpu")
    calls = []

    def solver(st, g, generator, cfg):
        new, info = tgs.global_assign(st, g, generator, cfg)
        calls.append((st, new, generator.initial_seed()))
        return new, info

    cfg = tgs.GlobalSolverConfig(sweeps=2)
    ms = tat._device_ms_per_round(solver, scn.state, scn.graph, cfg)
    assert isinstance(ms, float)
    chains, i = [], 0
    for k in (8, 8, 8, 2, 2, 2):
        chains.append(calls[i:i + k])
        i += k
    assert i == len(calls)
    for chain, seed in zip(chains, (7, 8, 9, 7, 8, 9)):
        assert chain[0][0] is scn.state
        for (_, out, _), (nxt, _, _) in zip(chain, chain[1:]):
            assert nxt is out
        assert [s for *_, s in chain] == [round_generator(seed, j).initial_seed()
                                          for j in range(len(chain))]


def test_tune_sweeps_measures_on_the_cpu():
    scn = synthetic_scenario(n_pods=64, n_nodes=8, seed=3, device="cpu")
    cfg, info = tat.tune_sweeps(scn.state, scn.graph, tgs.GlobalSolverConfig(), 50.0)
    assert cfg.sweeps == info["sweeps"] >= 1
    assert info["measured_lo"][0] == 3 and info["measured_hi"][0] == 9
    assert info["per_sweep_ms"] > 0 and info["fixed_ms"] >= 0


@pytest.mark.parametrize("flags", [[], ["--sparse"], ["--placement-unit", "pod"]])
def test_solve_latency_budget_cli_on_the_cpu(flags, capsys):
    assert cli.main(["solve", "--scenario", "dense", "--latency-budget", "40",
                     "--device", "cpu", *flags]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["sweeps"] == out["autotune"]["sweeps"] == len(out["moves_per_sweep"])
    assert set(out["autotune"]) == {"budget_ms", "per_sweep_ms", "fixed_ms", "measured_lo",
                                    "measured_hi", "sweeps", "predicted_round_ms"}
    assert out["autotune"]["budget_ms"] == 40.0
    assert out["communication_cost_after"] <= out["communication_cost_before"]


def test_solve_restarts_matches_jax_and_tp_needs_devices(monkeypatch, capsys):
    """``solve --restarts 2`` on µBench, fed the JAX command's per-restart
    plans (``split(PRNGKey(seed), 2)``), prints the JAX command's keys and
    values: the same restart objectives (rel 1e-6: f32 sums of integer
    weights), costs and load spreads; ``--tp 2`` on one device fails with
    the JAX package's message."""
    import jax
    from test_torch_global_solver import jax_plan

    from kubernetes_rescheduling_tpu import cli as jcli

    assert jcli.main(["solve", "--scenario", "mubench", "--restarts", "2", "--seed", "3"]) == 0
    j_out = json.loads(capsys.readouterr().out)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    plans = [jax_plan(k, jgs.GlobalSolverConfig(), 20, 3, inline=False) for k in keys]
    real = cli.solve_with_restarts
    monkeypatch.setattr(cli, "solve_with_restarts",
                        lambda *a, **kw: real(*a, **kw, plans=plans))
    assert cli.main(["solve", "--scenario", "mubench", "--restarts", "2", "--seed", "3",
                     "--device", "cpu"]) == 0
    t_out = json.loads(capsys.readouterr().out)
    assert set(t_out) == set(j_out) and t_out["restarts"] == 2 and t_out["tp"] == 1
    assert t_out["restart_objectives"] == pytest.approx(j_out["restart_objectives"], rel=1e-6)
    for k in ("communication_cost_before", "communication_cost_after", "load_std_before",
              "load_std_after"):
        assert t_out[k] == pytest.approx(j_out[k], rel=1e-6), k
    with pytest.raises(ValueError, match="tp=2 does not divide the 1 available devices"):
        cli.main(["solve", "--scenario", "mubench", "--tp", "2", "--device", "cpu"])
