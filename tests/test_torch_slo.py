"""SLO v2 on the port: tests/test_slo.py's cases run against the port's
history plane (``telemetry/timeseries.py``), error-budget engine
(``telemetry/slo.py``), watchdog, ops plane and serving engine (CPU).

Each case is the JAX test's own function, re-bound to a copy of its
module's globals in which every name the case reads from the JAX package
names the port's counterpart (``ObsConfig`` names the port's flat
``RescheduleConfig``, which carries the ``obs`` block under the same field
names; the serving engine and ``make_backend`` run on the CPU). The
assertions are the JAX test's, unchanged; a case that imports the JAX
package's ``telemetry.report`` or ``cli`` inside its body gets the port's
(:func:`port_modules`; the CLI runs on the CPU). Left out: the two ``slow``
variants, whose invariants the fast soaks below pin.

Besides the cases: the port's and the JAX package's engines fed the same
counters give the same budget/burn table, tick for tick.
"""

import functools
import inspect
import types

import pytest
import test_slo as jcases

from kubernetes_rescheduling_tpu.telemetry import slo as jslo
from kubernetes_rescheduling_tpu.telemetry import timeseries as jts
from kubernetes_rescheduling_tpu.telemetry.registry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu_torch import config as tconfig
from kubernetes_rescheduling_tpu_torch import telemetry as ttel
from kubernetes_rescheduling_tpu_torch.bench import loadgen as tloadgen
from kubernetes_rescheduling_tpu_torch.bench import serve as tserve
from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend as t_make
from kubernetes_rescheduling_tpu_torch.serving import ServingEngine as TServingEngine
from kubernetes_rescheduling_tpu_torch.telemetry import fleet_rollup as troll
from kubernetes_rescheduling_tpu_torch.telemetry import server as tserver
from kubernetes_rescheduling_tpu_torch.telemetry import slo as tslo
from kubernetes_rescheduling_tpu_torch.telemetry import timeseries as tts
from kubernetes_rescheduling_tpu_torch.telemetry import watchdog as twatchdog

# what the JAX cases' names stand for on the port
PORT_NAMES = {
    "ObsConfig": tconfig.RescheduleConfig,
    "RescheduleConfig": tconfig.RescheduleConfig,
    "ServingConfig": tconfig.ServingConfig,
    "SloConfig": tconfig.SloConfig,
    "ServingEngine": functools.partial(TServingEngine, device="cpu"),
    "make_backend": lambda scenario, seed=0, **kw: t_make(scenario, seed, device="cpu", **kw),
    "open_loop_arrivals": tloadgen.open_loop_arrivals,
    "run_serve_soak": tserve.run_serve_soak,
    "MetricsRegistry": ttel.MetricsRegistry,
    "get_registry": ttel.get_registry,
    "set_registry": ttel.set_registry,
    "TenantSeries": troll.TenantSeries,
    "OpsPlane": tserver.OpsPlane,
    "RULE_FAST_BURN": tslo.RULE_FAST_BURN,
    "RULE_SLOW_BURN": tslo.RULE_SLOW_BURN,
    "SloEngine": tslo.SloEngine,
    "SloSpec": tslo.SloSpec,
    "budget_burn_frac": tslo.budget_burn_frac,
    "default_specs": tslo.default_specs,
    "SeriesStore": tts.SeriesStore,
    "series_key": tts.series_key,
    "SLORules": twatchdog.SLORules,
    "Watchdog": twatchdog.Watchdog,
}


def on_port(module, names: dict):
    """``module``'s functions re-bound to a copy of its globals with
    ``names`` substituted: a case calls the port where it called the JAX
    package, helpers included."""
    g = dict(vars(module))
    g.update(names)
    for k, v in list(g.items()):
        if isinstance(v, types.FunctionType) and v.__module__ == module.__name__:
            g[k] = types.FunctionType(v.__code__, g, v.__name__, v.__defaults__, v.__closure__)
            g[k].__kwdefaults__ = v.__kwdefaults__
    return g


def run_case(cases: dict, name: str, fixtures: dict) -> None:
    fn = cases[name]
    fn(**{p: fixtures[p] for p in inspect.signature(fn).parameters})


def cpu_cli(argv):
    """The port's CLI on the CPU (``--device cpu`` after a run command)."""
    from kubernetes_rescheduling_tpu_torch import cli as tcli

    argv = list(argv)
    if argv and argv[0] in ("bench", "reschedule", "solve", "trace"):
        argv += ["--device", "cpu"]
    return tcli.main(argv)


def port_modules(monkeypatch) -> None:
    """A JAX case's imports inside its body of the JAX package's CLI,
    harness, load generator, logger, ops server and reports resolve to the
    port's (the CLI and the harness on the CPU) for the case's duration."""
    import sys

    from kubernetes_rescheduling_tpu_torch.bench import harness as th
    from kubernetes_rescheduling_tpu_torch.bench import loadgen as tl
    from kubernetes_rescheduling_tpu_torch.telemetry import report as treport
    from kubernetes_rescheduling_tpu_torch.utils import logging as tlogging

    swaps = {
        "telemetry.report": treport,
        "telemetry.server": tserver,
        "utils.logging": tlogging,
        "bench.loadgen": tl,
        "bench.harness": types.SimpleNamespace(
            ExperimentConfig=th.ExperimentConfig,
            run_experiment=functools.partial(th.run_experiment, device="cpu"),
            make_backend=lambda scenario, seed=0, **kw: th.make_backend(scenario, seed,
                                                                        device="cpu", **kw)),
        "cli": types.SimpleNamespace(main=cpu_cli),
    }
    for name, module in swaps.items():
        monkeypatch.setitem(sys.modules, f"kubernetes_rescheduling_tpu.{name}", module)


LEFT_OUT = {
    "test_burn_soak_long",                   # slow variant
    "test_clean_soak_long_zero_burn",        # slow variant
}
CASES = sorted(n for n, v in vars(jcases).items()
               if n.startswith("test_") and callable(v) and n not in LEFT_OUT)
PORT_CASES = on_port(jcases, PORT_NAMES)


@pytest.fixture()
def registry():
    prev = ttel.set_registry(ttel.MetricsRegistry())
    try:
        yield ttel.get_registry()
    finally:
        ttel.set_registry(prev)


@pytest.mark.parametrize("case", CASES)
def test_slo_case_on_port(case, registry, tmp_path, monkeypatch, capsys):
    port_modules(monkeypatch)
    run_case(PORT_CASES, case, {"registry": registry, "tmp_path": tmp_path,
                                "monkeypatch": monkeypatch, "capsys": capsys})


def _feed(store_mod, slo_mod, registry_cls, ticks):
    reg = registry_cls()
    store = store_mod.SeriesStore(capacity=64, max_series=8, registry=reg)
    engine = slo_mod.SloEngine(slo_mod.default_specs(objective=0.95), store, registry=reg,
                               budget_window=32, fast_window=4, fast_burn=3.0,
                               slow_window=12, slow_burn=1.5)
    tables, fired = [], []
    for tick, snap in enumerate(ticks, start=1):
        store.sample(snap, tick)
        fired.append(sorted(engine.evaluate(tick)))
        tables.append(engine.table())
    return tables, fired, reg.expose()


def test_engine_tables_equal_jax():
    """The same counter stream through both packages' store and engine:
    equal budget/burn tables, firing rules and exposition at every tick."""
    import numpy as np

    rng = np.random.default_rng(3)
    ok = bad = deg = 0
    ticks = []
    for t in range(60):
        ok += int(rng.integers(5, 10))
        bad += int(rng.integers(0, 6 if 20 <= t < 30 else 2))
        deg += int(t % 9 == 0)
        ticks.append([
            {"metric": "rounds_total", "type": "counter", "labels": {"algorithm": "c"},
             "value": float(ok)},
            {"metric": "degraded_rounds_total", "type": "counter",
             "labels": {"algorithm": "c"}, "value": float(deg)},
            {"metric": "serving_placements_total", "type": "counter",
             "labels": {"outcome": "placed"}, "value": float(ok)},
            {"metric": "serving_placements_total", "type": "counter",
             "labels": {"outcome": "shed"}, "value": float(bad)},
        ])
    j = _feed(jts, jslo, JRegistry, ticks)
    t = _feed(tts, tslo, ttel.MetricsRegistry, ticks)
    assert t == j
    assert any(j[1]), "no burn rule fired: the stream does not exercise the engine"
