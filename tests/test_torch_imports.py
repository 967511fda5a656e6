"""The port stands alone: it never imports jax or the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "kubernetes_rescheduling_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "kubernetes_rescheduling_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys, kubernetes_rescheduling_tpu_torch\n"
        "import kubernetes_rescheduling_tpu_torch.cli, kubernetes_rescheduling_tpu_torch.convert\n"
        "import kubernetes_rescheduling_tpu_torch.solver.global_solver\n"
        "import kubernetes_rescheduling_tpu_torch.solver.sparse_solver\n"
        "import kubernetes_rescheduling_tpu_torch.solver.pod_mode\n"
        "import kubernetes_rescheduling_tpu_torch.solver.compiled\n"
        "import kubernetes_rescheduling_tpu_torch.solver.autotune\n"
        "import kubernetes_rescheduling_tpu_torch.bench.trace\n"
        "import kubernetes_rescheduling_tpu_torch.ops.sparse_mass\n"
        "import kubernetes_rescheduling_tpu_torch.bench.harness\n"
        "import kubernetes_rescheduling_tpu_torch.bench.profile\n"
        "import kubernetes_rescheduling_tpu_torch.bench.controller\n"
        "import kubernetes_rescheduling_tpu_torch.bench.boundary\n"
        "import kubernetes_rescheduling_tpu_torch.bench.round_end\n"
        "import kubernetes_rescheduling_tpu_torch.bench.scan\n"
        "import kubernetes_rescheduling_tpu_torch.backends.sim_device\n"
        "import kubernetes_rescheduling_tpu_torch.backends.chaos\n"
        "import kubernetes_rescheduling_tpu_torch.backends\n"
        "import kubernetes_rescheduling_tpu_torch.telemetry.tripwire\n"
        "import kubernetes_rescheduling_tpu_torch.elastic\n"
        "import kubernetes_rescheduling_tpu_torch.elastic.engine\n"
        "import kubernetes_rescheduling_tpu_torch.elastic.rates\n"
        "import kubernetes_rescheduling_tpu_torch.backends.base\n"
        "import kubernetes_rescheduling_tpu_torch.config\n"
        "import kubernetes_rescheduling_tpu_torch.core.quantities\n"
        "import kubernetes_rescheduling_tpu_torch.policies.proactive\n"
        "import kubernetes_rescheduling_tpu_torch.solver.round_loop\n"
        "import kubernetes_rescheduling_tpu_torch.telemetry\n"
        "import kubernetes_rescheduling_tpu_torch.utils.retry\n"
        "import kubernetes_rescheduling_tpu_torch.solver.fleet\n"
        "import kubernetes_rescheduling_tpu_torch.solver.fleet_global\n"
        "import kubernetes_rescheduling_tpu_torch.backends.fleet\n"
        "import kubernetes_rescheduling_tpu_torch.bench.fleet\n"
        "import kubernetes_rescheduling_tpu_torch.telemetry.fleet_rollup\n"
        "import kubernetes_rescheduling_tpu_torch.utils.logging\n"
        "import kubernetes_rescheduling_tpu_torch.forecast\n"
        "import kubernetes_rescheduling_tpu_torch.forecast.model\n"
        "import kubernetes_rescheduling_tpu_torch.forecast.plane\n"
        "import kubernetes_rescheduling_tpu_torch.forecast.fleet\n"
        "import kubernetes_rescheduling_tpu_torch.oracle.forecast\n"
        "import kubernetes_rescheduling_tpu_torch.serving\n"
        "import kubernetes_rescheduling_tpu_torch.serving.kernel\n"
        "import kubernetes_rescheduling_tpu_torch.serving.engine\n"
        "import kubernetes_rescheduling_tpu_torch.bench.loadgen\n"
        "import kubernetes_rescheduling_tpu_torch.bench.serve\n"
        "import kubernetes_rescheduling_tpu_torch.telemetry.registry\n"
        "import kubernetes_rescheduling_tpu_torch.telemetry.spans\n"
        "import kubernetes_rescheduling_tpu_torch.telemetry.attribution\n"
        "import kubernetes_rescheduling_tpu_torch.telemetry.manifest\n"
        "import kubernetes_rescheduling_tpu_torch.telemetry.flight_recorder\n"
        "import kubernetes_rescheduling_tpu_torch.telemetry.timeseries\n"
        "import kubernetes_rescheduling_tpu_torch.telemetry.watchdog\n"
        "import kubernetes_rescheduling_tpu_torch.telemetry.slo\n"
        "import kubernetes_rescheduling_tpu_torch.telemetry.mesh\n"
        "import kubernetes_rescheduling_tpu_torch.telemetry.server\n"
        "import kubernetes_rescheduling_tpu_torch.objectives.metrics\n"
        "import kubernetes_rescheduling_tpu_torch.traces\n"
        "import kubernetes_rescheduling_tpu_torch.traces.corpus\n"
        "import kubernetes_rescheduling_tpu_torch.traces.adapters\n"
        "import kubernetes_rescheduling_tpu_torch.forecast.dataset\n"
        "import kubernetes_rescheduling_tpu_torch.backends.replay\n"
        "import kubernetes_rescheduling_tpu_torch.backends.k8s\n"
        "import kubernetes_rescheduling_tpu_torch.bench.shadow\n"
        "import kubernetes_rescheduling_tpu_torch.bench.reconcile\n"
        "import kubernetes_rescheduling_tpu_torch.telemetry.report\n"
        "import kubernetes_rescheduling_tpu_torch.telemetry.perf_ledger\n"
        "import kubernetes_rescheduling_tpu_torch.telemetry.costmodel\n"
        "import kubernetes_rescheduling_tpu_torch.bench.sinks\n"
        "import kubernetes_rescheduling_tpu_torch.bench.plots\n"
        "import kubernetes_rescheduling_tpu_torch.utils.profiling\n"
        "import kubernetes_rescheduling_tpu_torch.ops.work\n"
        "import kubernetes_rescheduling_tpu_torch.parallel\n"
        "import kubernetes_rescheduling_tpu_torch.parallel.launch\n"
        "import kubernetes_rescheduling_tpu_torch.oracle\n"
        "import kubernetes_rescheduling_tpu_torch.oracle.optimum\n"
        "import kubernetes_rescheduling_tpu_torch.bench, kubernetes_rescheduling_tpu_torch.utils\n"
        "from kubernetes_rescheduling_tpu_torch.bench import run_experiment, CsvSink\n"
        "from kubernetes_rescheduling_tpu_torch.utils import CheckpointManager\n"
        "from kubernetes_rescheduling_tpu_torch.telemetry import OpsPlane, run_manifest\n"
        "OpsPlane.from_config(kubernetes_rescheduling_tpu_torch.config.RescheduleConfig())\n"
        "run_manifest()\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "assert 'matplotlib' not in sys.modules\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_bench_help_leaves_matplotlib_out():
    """The card's machine has no matplotlib: the CLI and ``bench --help``
    import it nowhere (``bench/plots.py`` imports it inside each chart)."""
    code = (
        "import sys, contextlib, io\n"
        "from kubernetes_rescheduling_tpu_torch import cli\n"
        "import kubernetes_rescheduling_tpu_torch.bench.plots\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    try:\n"
        "        cli.main(['bench', '--help'])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0\n"
        "assert '--observe-weights' in buf.getvalue()\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported'\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_port_file_imports_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = {
        str(p.relative_to(REPO)): mods
        for p in files
        if (mods := [m for m in _imported_modules(p) if _forbidden(m)])
    }
    assert not bad


def test_chip_smoke_alone_fails_without_the_package(tmp_path):
    """Copied alone into an empty directory, the smoke script cannot find
    the port and exits non-zero without printing a result (on a box
    without a card it stops even earlier)."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _entry_points():
    from kubernetes_rescheduling_tpu_torch import cli, convert
    from kubernetes_rescheduling_tpu_torch.backends.fleet import make_fleet
    from kubernetes_rescheduling_tpu_torch.backends.k8s import K8sBackend
    from kubernetes_rescheduling_tpu_torch.backends.replay import ReplayBackend
    from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller
    from kubernetes_rescheduling_tpu_torch.bench.fleet import run_fleet_controller
    from kubernetes_rescheduling_tpu_torch.bench.harness import (
        ExperimentConfig,
        make_backend,
        make_fleet_problem,
        mubench_reference_placements,
        run_chaos_soak,
        run_experiment,
        sparse_problem,
    )
    from kubernetes_rescheduling_tpu_torch.bench.loadgen import LoadGenerator
    from kubernetes_rescheduling_tpu_torch.bench.multichip import bench_multichip
    from kubernetes_rescheduling_tpu_torch.config import ForecastConfig, RescheduleConfig
    from kubernetes_rescheduling_tpu_torch.parallel.dryrun import dryrun_multichip
    from kubernetes_rescheduling_tpu_torch.core import sparsegraph, topology
    from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
    from kubernetes_rescheduling_tpu_torch.core.workmodel import ServiceSpec, Workmodel
    from kubernetes_rescheduling_tpu_torch.forecast import FleetForecastPlane, ForecastPlane
    from kubernetes_rescheduling_tpu_torch.parallel import make_mesh
    from kubernetes_rescheduling_tpu_torch.serving import ServingEngine
    from kubernetes_rescheduling_tpu_torch.solver import run_rounds
    from kubernetes_rescheduling_tpu_torch.telemetry import OpsPlane
    from kubernetes_rescheduling_tpu_torch.traces import load_shadow_trace, window_state
    from kubernetes_rescheduling_tpu_torch.utils.checkpoint import load_state

    shadow = REPO / "tests" / "fixtures" / "shadow"

    def cpu_mubench():
        return topology.mubench_scenario(device="cpu")

    return {
        "make_backend": lambda: make_backend("dense", 0),
        "make_backend mubench": lambda: make_backend("mubench", 0),
        "mubench_scenario": lambda: topology.mubench_scenario(),
        "run_rounds": lambda: run_rounds(cpu_mubench().state, cpu_mubench().graph, 4),
        "run_controller": lambda: run_controller(make_backend("mubench", 0, device="cpu"),
                                                 RescheduleConfig(max_rounds=1)),
        "cli reschedule": lambda: cli.main(["reschedule", "--rounds", "1"]),
        "cli reschedule global": lambda: cli.main(["reschedule", "--algorithm", "global"]),
        "run_controller scanned": lambda: run_controller(
            make_backend("mubench", 0, device="cpu"), RescheduleConfig(max_rounds=2,
                                                                       scan_block=2)),
        "run_controller pipelined": lambda: run_controller(
            make_backend("mubench", 0, device="cpu"), RescheduleConfig(max_rounds=2,
                                                                       pipeline=True)),
        "run_controller churned": lambda: run_controller(
            make_backend("mubench", 0, device="cpu"), RescheduleConfig(
                max_rounds=2, elastic="diurnal-autoscale")),
        "make_fleet": lambda: make_fleet("mubench", 2),
        "make_fleet_problem": lambda: make_fleet_problem(2, 20, 4),
        "run_fleet_controller": lambda: run_fleet_controller(
            make_fleet("mubench", 2, device="cpu"), RescheduleConfig(max_rounds=1)),
        "cli reschedule --fleet": lambda: cli.main(["reschedule", "--fleet", "2"]),
        "cli reschedule --scan-block": lambda: cli.main(["reschedule", "--scan-block", "2"]),
        "cli reschedule --pipeline": lambda: cli.main(["reschedule", "--pipeline"]),
        "cli reschedule --churn-profile": lambda: cli.main(
            ["reschedule", "--churn-profile", "deploy-waves"]),
        "synthetic_scenario": lambda: topology.synthetic_scenario(n_pods=20, n_nodes=4),
        "powerlaw_2000x200": lambda: topology.powerlaw_2000x200(),
        "ClusterState.build": lambda: ClusterState.build(
            node_names=["a"], node_cpu_cap=[1.0], node_mem_cap=[1.0], pod_services=[0],
            pod_nodes=[0], pod_cpu=[1.0], pod_mem=[1.0],
        ),
        "CommGraph.from_relation": lambda: CommGraph.from_relation({"a": ["b"]}),
        "graph_from_arrays": lambda: convert.graph_from_arrays(
            {"adj": [[0.0]], "service_valid": [True]}
        ),
        "cli solve": lambda: cli.main(["solve", "--scenario", "dense"]),
        "cli solve --sparse": lambda: cli.main(["solve", "--scenario", "dense", "--sparse"]),
        "sparse_problem": lambda: sparse_problem(300, 4),
        "sparsegraph.from_edges": lambda: sparsegraph.from_edges([0], [1], [1.0], 2),
        "sparsegraph.from_workmodel": lambda: sparsegraph.from_workmodel(
            Workmodel(services=(ServiceSpec("a", callees=("b",)), ServiceSpec("b")))
        ),
        "load_state": lambda: load_state("round_000001"),
        "sparse_graph_from_arrays": lambda: convert.sparse_graph_from_arrays(
            {k: [] for k in convert.SPARSE_ARRAYS + convert.SPARSE_STATIC}
        ),
        "trace_locator_from_arrays": lambda: convert.trace_locator_from_arrays(
            {"coo": [], "w_rows": [], "w_cols": [], "base_w": []}
        ),
        "cli trace": lambda: cli.main(["trace", "--steps", "2"]),
        "cli solve --latency-budget": lambda: cli.main(
            ["solve", "--scenario", "dense", "--latency-budget", "100"]),
        "ForecastPlane": lambda: ForecastPlane(ForecastConfig()),
        "FleetForecastPlane": lambda: FleetForecastPlane(ForecastConfig(), 2),
        "ServingEngine": lambda: ServingEngine(make_backend("mubench", 0, device="cpu")),
        "run_controller proactive": lambda: run_controller(
            make_backend("mubench", 0, device="cpu"), RescheduleConfig(
                max_rounds=1, algorithm="proactive")),
        "cli reschedule --algorithm proactive": lambda: cli.main(
            ["reschedule", "--algorithm", "proactive"]),
        "run_chaos_soak": lambda: run_chaos_soak(rounds=1),
        "run_controller chaos": lambda: run_controller(
            make_backend("mubench", 0, device="cpu"), RescheduleConfig(max_rounds=1,
                                                                       chaos="soak")),
        "run_fleet_controller pipelined": lambda: run_fleet_controller(
            make_fleet("mubench", 2, device="cpu"), RescheduleConfig(max_rounds=1,
                                                                     pipeline=True)),
        "cli reschedule --chaos-profile": lambda: cli.main(
            ["reschedule", "--chaos-profile", "soak"]),
        "cli reschedule --fleet --pipeline": lambda: cli.main(
            ["reschedule", "--fleet", "2", "--pipeline", "--fleet-chaos-tenants", "1",
             "--chaos-profile", "soak"]),
        "cli reschedule --serve --place": lambda: cli.main(
            ["reschedule", "--serve", "0", "--place", "--metrics-out", "unused.jsonl"]),
        "run_chaos_soak ops": lambda: run_chaos_soak(rounds=1, ops=OpsPlane.from_config(
            RescheduleConfig(), bundle_dir=None)),
        "window_state": lambda: window_state(load_shadow_trace(shadow), 0),
        "ClusterTrace.comm_graph": lambda: load_shadow_trace(shadow).comm_graph(),
        "ReplayBackend": lambda: ReplayBackend(load_shadow_trace(shadow)),
        "K8sBackend": lambda: K8sBackend(workmodel=Workmodel(services=(ServiceSpec("a"),)),
                                         core_api=object(), apps_api=object(),
                                         custom_api=object()),
        "cli reschedule --shadow": lambda: cli.main(["reschedule", "--shadow", str(shadow)]),
        "LoadGenerator": lambda: LoadGenerator(Workmodel(services=(ServiceSpec("s0"),))),
        "run_experiment": lambda: run_experiment(ExperimentConfig(repeats=1, rounds=1)),
        "mubench_reference_placements": lambda: mubench_reference_placements(),
        "cli bench": lambda: cli.main(["bench", "--repeats", "1", "--rounds", "1"]),
        "cli reschedule --perf-ledger": lambda: cli.main(
            ["reschedule", "--perf-ledger", "unused.jsonl"]),
        "make_mesh": lambda: make_mesh(),
        "cli solve --restarts": lambda: cli.main(["solve", "--restarts", "2"]),
        "cli trace --restarts": lambda: cli.main(["trace", "--steps", "2", "--restarts", "2"]),
        "cli reschedule --restarts": lambda: cli.main(
            ["reschedule", "--algorithm", "global", "--restarts", "2"]),
        "cli reschedule --fleet --restarts": lambda: cli.main(
            ["reschedule", "--fleet", "2", "--algorithm", "global", "--restarts", "2"]),
        "cli reschedule --fleet-plane dp": lambda: cli.main(
            ["reschedule", "--fleet", "2", "--fleet-plane", "dp"]),
        "bench_multichip": lambda: bench_multichip(tenants=2, n_services=8, n_nodes=4),
        "dryrun_multichip": lambda: dryrun_multichip(),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    """Called without a device on a machine with no card, an entry point
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


# the JAX names the port leaves out on purpose (``instrument_jit``: its
# counterpart is the capture cache's ``cuda_graph_captures_total``)
SURFACE_EXCEPTIONS = {
    "telemetry": {"instrument_jit"},
}
# port names beyond the JAX ``__all__``s: the port's plan seams and helpers
# its tests and chip_smoke.py use, the forecast twin of ``oracle``
PORT_EXTRAS = {
    "": set(),
    "core": set(),
    "solver": {"SparseSweepPlan", "SweepPlan", "global_assign_pods", "pod_level_graph",
               "prepare_weights", "sparse_layout"},
    "backends": {"device_kind"},
    "telemetry": {"ProfilerGate"},
    "utils": set(),
    "bench": set(),
    "oracle": {"forecast"},
    "parallel": set(),
}


@pytest.mark.parametrize("sub", sorted(PORT_EXTRAS))
def test_public_surface_matches_jax(sub):
    """Each port package exports the JAX package's ``__all__`` (minus the
    listed left-out names) plus the listed port extras, and
    every exported name resolves. The JAX side is read from its source
    (``ast``), so this imports no jax."""
    import importlib

    jax_root = REPO / "kubernetes_rescheduling_tpu"
    init = (jax_root / sub / "__init__.py") if sub else jax_root / "__init__.py"
    tree = ast.parse(init.read_text())
    jax_all = next(set(ast.literal_eval(n.value)) for n in tree.body
                   if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "__all__")
    mod = importlib.import_module("kubernetes_rescheduling_tpu_torch" + (f".{sub}" if sub else ""))
    want = (jax_all - SURFACE_EXCEPTIONS.get(sub, set())) | PORT_EXTRAS[sub]
    assert set(mod.__all__) == want
    assert all(getattr(mod, name) is not None for name in mod.__all__)


def _subcommands(parser):
    import argparse

    return next(a.choices for a in parser._actions if isinstance(a, argparse._SubParsersAction))


# port-only options
CLI_PORT_ONLY = {"device"}


def test_cli_defaults_match_jax():
    """Every subcommand's options, defaults and choices equal the JAX
    ``build_parser()``'s (``solve --scenario`` defaults to ``mubench``),
    but for the listed port-only options."""
    from kubernetes_rescheduling_tpu import cli as jcli
    from kubernetes_rescheduling_tpu_torch import cli as tcli

    js, ts = _subcommands(jcli.build_parser()), _subcommands(tcli.build_parser())
    assert set(js) == set(ts)
    for name in js:
        jd = {a.dest: (a.default, a.choices and list(a.choices)) for a in js[name]._actions}
        td = {a.dest: (a.default, a.choices and list(a.choices)) for a in ts[name]._actions}
        for dest in CLI_PORT_ONLY & set(td):
            td.pop(dest)
        assert td == jd, name
    assert ts["solve"].get_default("scenario") == "mubench"


def test_publish_round_telemetry():
    """tests/test_telemetry.py::test_publish_round_telemetry on the port:
    four rounds of ``run_rounds`` surface through the registry, with one
    counted host read for the whole record."""
    from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend
    from kubernetes_rescheduling_tpu_torch.solver import run_rounds
    from kubernetes_rescheduling_tpu_torch.telemetry import (
        MetricsRegistry,
        publish_round_telemetry,
        set_registry,
    )

    registry = MetricsRegistry()
    prev = set_registry(registry)
    try:
        backend = make_backend("mubench", 0, device="cpu")
        backend.inject_imbalance(backend.node_names[0])
        _, tel = run_rounds(backend.monitor(), backend.comm_graph(), 4, rounds=4,
                            device="cpu")
        out = publish_round_telemetry(tel, algorithm="communication")
    finally:
        set_registry(prev)
    assert out["rounds"] == 4
    assert registry.counter("rounds_total", labelnames=("algorithm",)).labels(
        algorithm="communication").value == 4
    assert registry.gauge("communication_cost", labelnames=("algorithm",)).labels(
        algorithm="communication").value == pytest.approx(out["communication_cost"])
    assert out["communication_cost"] == pytest.approx(float(tel.communication_cost[-1]))
    assert out["moves"] == int(tel.moved.sum())
    assert registry.value("device_transfers_total", site="round_telemetry") == 1
