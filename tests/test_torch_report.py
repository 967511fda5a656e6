"""The port's ``telemetry`` command and its renderings (``telemetry/
report.py``), the forecast datasets (``forecast/dataset.py``), the TOML
loader (``RescheduleConfig.from_toml``) and ``utils/profiling.py`` on the
CPU, against the JAX package.

- The JAX cases that pin report text (tests/test_telemetry.py,
  tests/test_forecast.py's dataset cases, tests/test_observability.py's
  explain/bundle reports, tests/test_tripwire.py's scan-plane digest,
  tests/test_fleet_rollup.py's fleet report) run on the port: each the JAX
  test's own function re-bound to the port's names (``test_torch_slo.
  on_port``), its imports of the JAX CLI and reports inside its body
  resolved to the port's (``test_torch_slo.port_modules``).
- Both packages' renderers over the same artifacts — a µBench session of
  the port's harness (greedy and global cells with attribution and
  explanations), a flight-recorder bundle, a perf ledger with the ingested
  history, a fleet run's events — give the same text, line for line, in
  every mode (the manifest names torch where the JAX one names jax, so a
  manifest is compared apart).
- Every TOML file of the JAX tests (captured by wrapping the JAX loader
  while the JAX test runs) loads in the port to the flat equivalents of the
  JAX config (the fleet's ``plane = "dp"`` and the mesh plane's fields
  included), or is refused as the JAX loader refuses it.
"""

import contextlib
import dataclasses
import functools
import io
import json
import types
from pathlib import Path

import pytest
import test_fleet_rollup as jfleet_cases
import test_forecast as jforecast_cases
import test_observability as jobs_cases
import test_telemetry as jtel_cases
import test_tripwire as jtrip_cases
from test_torch_slo import cpu_cli, on_port, port_modules, run_case

from kubernetes_rescheduling_tpu import config as jconfig
from kubernetes_rescheduling_tpu.forecast import dataset as jdataset
from kubernetes_rescheduling_tpu.telemetry import report as jreport
from kubernetes_rescheduling_tpu_torch import config as tconfig
from kubernetes_rescheduling_tpu_torch import telemetry as ttel
from kubernetes_rescheduling_tpu_torch.backends.fleet import make_fleet as t_make_fleet
from kubernetes_rescheduling_tpu_torch.bench import harness as th
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.fleet import run_fleet_controller as t_run_fleet
from kubernetes_rescheduling_tpu_torch.forecast import dataset as tdataset
from kubernetes_rescheduling_tpu_torch.telemetry import perf_ledger as tpl
from kubernetes_rescheduling_tpu_torch.telemetry import registry as tregistry
from kubernetes_rescheduling_tpu_torch.telemetry import report as treport
from kubernetes_rescheduling_tpu_torch.utils import profiling as tprofiling
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger as TLogger

REPO = Path(__file__).resolve().parent.parent


def port_config(obs=None, fleet=None, **kw):
    """The port's flat config from a JAX-shaped call (``obs=`` a dict of
    ``obs.*`` fields, as ``PORT_NAMES["ObsConfig"]`` builds it)."""
    if fleet is not None:
        kw["fleet"] = fleet
    return tconfig.RescheduleConfig(**kw, **(obs or {}))


PORT_NAMES = {
    "LatencyHistogram": tprofiling.LatencyHistogram,
    "Histogram": tregistry.Histogram,
    "summarize_file": treport.summarize_file,
    "node_load_series": tdataset.node_load_series,
    "edge_traffic_series": tdataset.edge_traffic_series,
    "build_dataset": tdataset.build_dataset,
    "report_dataset": tdataset.report_dataset,
    "load_rounds": tdataset.load_rounds,
    "StructuredLogger": TLogger,
    "RescheduleConfig": port_config,
    "ObsConfig": lambda **kw: kw,
    "FleetConfig": tconfig.FleetConfig,
    "FlightRecorder": ttel.FlightRecorder,
    "run_controller": functools.partial(t_run, device="cpu"),
    "make_backend": lambda scenario, seed=0, **kw: th.make_backend(scenario, seed, device="cpu",
                                                                   **kw),
    "make_fleet": functools.partial(t_make_fleet, device="cpu"),
    "run_fleet_controller": lambda fleet, cfg, key=None, **kw: t_run_fleet(fleet, cfg,
                                                                           device="cpu", **kw),
    "jax": types.SimpleNamespace(random=types.SimpleNamespace(PRNGKey=lambda s: s)),
}
JAX_CASES = [
    (jtel_cases, "test_latency_histogram_keeps_summary_schema"),
    (jtel_cases, "test_jsonl_dump_and_report_roundtrip"),
    (jforecast_cases, "test_dataset_extraction_and_windows"),
    (jforecast_cases, "test_dataset_report_and_cli"),
    (jobs_cases, "test_telemetry_explain_and_bundle_reports"),
    (jtrip_cases, "test_report_surfaces_scan_plane"),
    (jfleet_cases, "test_telemetry_fleet_report_renders"),
]


@pytest.fixture()
def registry():
    prev = ttel.set_registry(ttel.MetricsRegistry())
    try:
        yield ttel.get_registry()
    finally:
        ttel.set_registry(prev)


@pytest.mark.parametrize("module,case", JAX_CASES, ids=[c for _, c in JAX_CASES])
def test_report_case_on_port(module, case, registry, tmp_path, capsys, monkeypatch):
    port_modules(monkeypatch)
    run_case(on_port(module, PORT_NAMES), case,
             {"registry": registry, "tmp_path": tmp_path, "capsys": capsys})


def test_cli_telemetry_report_names_torch(registry, tmp_path, capsys):
    """tests/test_telemetry.py's ``test_cli_telemetry_report`` on the port:
    the metrics, the event log and the manifest in one report; the
    manifest line names torch where the JAX one names jax."""
    registry.counter("rounds_total", labelnames=("algorithm",)).labels(algorithm="global").inc(3)
    metrics = tmp_path / "m.jsonl"
    registry.dump_jsonl(metrics)
    log = tmp_path / "log.jsonl"
    lg = TLogger(name="t", path=log)
    lg.info("round", round=0, moved=True, communication_cost=5.0, decision_latency_s=0.01)
    lg.info("round", round=1, moved=False, communication_cost=4.0, decision_latency_s=0.02)
    manifest = tmp_path / "m.manifest.json"
    ttel.write_manifest(manifest, {"command": "bench"})
    assert cpu_cli(["telemetry", str(metrics), str(log), str(manifest)]) == 0
    out = capsys.readouterr().out
    assert "rounds_total{algorithm=global} = 3" in out
    assert "rounds: 2" in out
    assert "communication_cost: 5.00 -> 4.00" in out
    assert "torch " in out and "jax" not in out


def test_cli_bench_writes_telemetry_artifacts(registry, tmp_path, capsys):
    """tests/test_telemetry.py's ``test_cli_bench_writes_telemetry_artifacts``
    on the port: ``bench --metrics-out --trace-out`` dumps the registry, its
    exposition, the spans and a manifest, beside the session's own."""
    tracer = ttel.Tracer()
    prev = ttel.set_tracer(tracer)
    try:
        metrics, trace = tmp_path / "m.jsonl", tmp_path / "t.json"
        assert cpu_cli(["bench", "--algorithms", "communication", "--repeats", "1",
                        "--rounds", "2", "--out", str(tmp_path / "result"),
                        "--metrics-out", str(metrics), "--trace-out", str(trace)]) == 0
        capsys.readouterr()
    finally:
        ttel.set_tracer(prev)
    recs = [json.loads(x) for x in metrics.read_text().splitlines()]
    rounds = [r for r in recs if r["metric"] == "rounds_total"
              and r["labels"] == {"algorithm": "communication"}]
    assert rounds and rounds[-1]["value"] == 2
    text = (tmp_path / "m.prom").read_text()
    assert "# TYPE rounds_total counter" in text
    assert "# TYPE backend_call_seconds histogram" in text
    assert 'rounds_total{algorithm="communication"} 2' in text
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]]
    assert names.count("controller/round") == 2 and "bench/run" in names
    manifest = json.loads((tmp_path / "m.manifest.json").read_text())
    assert manifest["config"]["command"] == "bench" and manifest["config"]["rounds"] == 2
    assert manifest["torch"]["version"]
    (session,) = list((tmp_path / "result").glob("session_*"))
    assert (session / "manifest.json").is_file()
    assert (session / "communication" / "run_1" / "metrics.jsonl").is_file()


# ---------------- both packages' renderings of the same artifacts ----------------


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A port µBench session (greedy and global cells, 4 rounds), a bundle of
    its global rounds, a perf ledger, and a fleet run's events with
    rollups, with the history snapshots."""
    root = tmp_path_factory.mktemp("artifacts")
    prev = ttel.set_registry(ttel.MetricsRegistry())
    try:
        th.run_experiment(th.ExperimentConfig(
            algorithms=("communication", "global"), repeats=1, rounds=4, scenario="mubench",
            seed=3, session_name="r", out_dir=str(root)), device="cpu")
        session = root / "session_r"
        fr = ttel.FlightRecorder(capacity=8, bundle_dir=root)
        for line in (session / "global" / "run_1" / "rounds.jsonl").read_text().splitlines():
            r = json.loads(line)
            fr.record_round(round=r["round"], digest="x", record=r)
        bundle = fr.dump("crash", error="boom")
        fleet = t_make_fleet("mubench", 3, seed=0, device="cpu")
        fleet.inject_imbalance()
        events = root / "fleet_events.jsonl"
        t_run_fleet(fleet, tconfig.RescheduleConfig(
            max_rounds=3, sleep_after_action_s=0.0, fleet=tconfig.FleetConfig(tenants=3),
            tenant_label_budget=2), device="cpu", logger=TLogger(max_records=512, path=events))
    finally:
        ttel.set_registry(prev)
    g = session / "global" / "run_1"
    c = session / "communication" / "run_1"
    # a shadow run's round records (the plane's block per scored round)
    shadow = root / "shadow_rounds.jsonl"
    shadow.write_text("".join(json.dumps({"round": r, "shadow": {
        "round": r, "recommended": 3 * r, "cost_actual": 10.0 + r, "cost_shadow": 9.0 + r / 2,
        "cost_delta": 1.0 + r / 2, "win": r % 3 != 0, "scored": r, "win_rate": 0.5 + r / 20,
        "edges_delta": [{"src_service": f"s{r}", "dst_service": f"s{r + 1}",
                         "delta": 0.5 * (r - 2)}]}}) + "\n" for r in range(1, 6)))
    history = [str(p) for p in sorted(REPO.glob("BENCH_r0*.json"))
               + sorted(REPO.glob("MULTICHIP_r0*.json"))]
    return {
        "report": [str(g / "metrics.jsonl"), str(c / "log.jsonl"), str(g / "log.jsonl"),
                   str(g / "rounds.jsonl"), str(bundle), str(root / "missing.jsonl")],
        "explain": [str(c / "log.jsonl"), str(g / "log.jsonl"), str(bundle)],
        "bundle": [str(bundle), str(g / "rounds.jsonl")],
        "topo": [str(g / "rounds.jsonl"), str(c / "rounds.jsonl"), str(bundle)],
        "perf": [str(session / "perf_ledger.jsonl"), *history, str(g / "rounds.jsonl")],
        "slo": [str(g / "metrics.jsonl"), str(c / "log.jsonl")],
        "fleet": [str(events), str(g / "rounds.jsonl")],
        "shadow": [str(shadow), str(g / "rounds.jsonl")],
        "dataset": [str(g / "rounds.jsonl"), str(c / "rounds.jsonl")],
        "manifest": str(session / "manifest.json"),
    }


RENDERERS = {
    "report": (jreport.report, treport.report),
    "explain": (jreport.report_explain, treport.report_explain),
    "bundle": (jreport.report_bundle, treport.report_bundle),
    "topo": (jreport.report_topo, treport.report_topo),
    "perf": (jreport.report_perf, treport.report_perf),
    "slo": (jreport.report_slo, treport.report_slo),
    "fleet": (jreport.report_fleet, treport.report_fleet),
    "shadow": (jreport.report_shadow, treport.report_shadow),
    "dataset": (jdataset.report_dataset, tdataset.report_dataset),
}


@pytest.mark.parametrize("mode", sorted(RENDERERS))
def test_rendering_equals_jax_line_for_line(artifacts, mode):
    jfn, tfn = RENDERERS[mode]
    j, t = jfn(artifacts[mode]), tfn(artifacts[mode])
    assert t.splitlines() == j.splitlines()
    assert len(t.splitlines()) > 2


def test_manifest_summary_names_torch(artifacts):
    text = treport.summarize_file(artifacts["manifest"])
    lines = text.splitlines()
    assert lines[1].startswith("  run: ") and lines[2].startswith("  argv: ")
    assert "torch" in lines[3] and "cuda" in lines[3]
    # the rest of a manifest's summary is the JAX package's
    jlines = jreport.summarize_file(artifacts["manifest"]).splitlines()
    assert lines[:3] == jlines[:3] and lines[4:] == jlines[4:]


@pytest.mark.parametrize("mode", sorted(RENDERERS))
def test_cli_telemetry_mode_runs_on_the_session(artifacts, mode, capsys):
    """Each of the nine modes through ``python -m ... telemetry MODE`` on a
    session's artifacts prints the renderer's text."""
    assert cpu_cli(["telemetry", mode, *artifacts[mode]]) == 0
    out = capsys.readouterr().out
    assert out.strip() == RENDERERS[mode][1](artifacts[mode]).strip()


def test_cli_telemetry_needs_paths():
    with pytest.raises(SystemExit, match="no artifact paths"):
        cpu_cli(["telemetry", "perf"])


def test_report_perf_ranks_history_and_flags_the_port_apart(tmp_path):
    """A port reading shares no series with the ingested TPU history: its
    device kind is its own."""
    led = tpl.PerfLedger(tmp_path / "led.jsonl")
    led.append(metric="global_solve_round_ms_large", value=48.0, unit="ms", scenario="large",
               device_kind="NVIDIA H100 80GB HBM3", digest="bench-history", better="lower")
    text = treport.report_perf([str(tmp_path / "led.jsonl")]
                               + [str(p) for p in sorted(REPO.glob("BENCH_r0*.json"))])
    rows = [ln for ln in text.splitlines() if "global_solve_round_ms_large@large" in ln]
    assert len(rows) == 2
    assert any("NVIDIA H100" in r and "fresh" in r for r in rows)


# ---------------- the TOML loader ----------------


TOML_CASES = [
    ("test_bench", "test_config_from_toml"),
    ("test_attribution", "test_config_attribution_knobs"),
    ("test_observability", "test_config_obs_toml_block"),
    ("test_pipeline", "test_controller_config_validation"),
    ("test_resilience", "test_config_toml_nested_resilience_blocks"),
    ("test_fleet_rollup", "test_obs_toml_fleet_block"),
    ("test_elastic", "test_elastic_config_from_toml"),
    ("test_fleet", "test_fleet_config_from_toml"),
    ("test_forecast", "test_forecast_config_from_toml"),
    ("test_perf_ledger", "test_perf_toml_block"),
    ("test_scan", "test_scan_block_from_toml"),
    ("test_serving", "test_serving_config_from_toml"),
    ("test_slo", "test_slo_config_from_toml"),
]


def flat_from_jax(jcfg) -> dict:
    """The port's flat field values of a JAX config, by the loader's own
    tables: top-level fields by name, a flat-mapped table field by
    ``TOML_TABLES``, a block by its fields."""
    out = {name: getattr(jcfg, name) for name in tconfig.TOML_TOP_LEVEL}
    for table, names in tconfig.TOML_TABLES.items():
        block = getattr(jcfg, table)
        out.update({flat: getattr(block, key) for key, flat in names.items()})
    for table in tconfig.TOML_BLOCKS:
        out[table] = dataclasses.asdict(getattr(jcfg, table))
    return out


def flat_of_port(tcfg) -> dict:
    out = {name: getattr(tcfg, name) for name in tconfig.TOML_TOP_LEVEL}
    for names in tconfig.TOML_TABLES.values():
        out.update({flat: getattr(tcfg, flat) for flat in names.values()})
    for table in tconfig.TOML_BLOCKS:
        out[table] = dataclasses.asdict(getattr(tcfg, table))
    return out


@pytest.mark.parametrize("module,case", TOML_CASES, ids=[c for _, c in TOML_CASES])
def test_toml_files_of_the_jax_tests_load_alike(module, case, tmp_path, monkeypatch):
    """Run the JAX test as it is (its own assertions on the JAX config), with
    the JAX loader wrapped to record every file it reads; then each file
    through the port's loader: the same values on the flat fields, or the
    JAX loader's refusal."""
    import importlib

    mod = importlib.import_module(module)
    seen: list[str] = []
    real = jconfig.RescheduleConfig.from_toml.__func__

    def recording(cls, path):
        seen.append(Path(path).read_text())
        return real(cls, path)

    monkeypatch.setattr(jconfig.RescheduleConfig, "from_toml", classmethod(recording))
    fn = getattr(mod, case)
    import inspect

    fn(**{p: tmp_path for p in inspect.signature(fn).parameters if p == "tmp_path"})
    assert seen
    for i, text in enumerate(seen):
        p = tmp_path / f"port_{i}.toml"
        p.write_text(text)
        try:
            jcfg = real(jconfig.RescheduleConfig, p)
        except (ValueError, TypeError) as e:
            with pytest.raises(type(e)):
                tconfig.RescheduleConfig.from_toml(p)
            continue
        tcfg = tconfig.RescheduleConfig.from_toml(p)
        want, got = flat_from_jax(jcfg), flat_of_port(tcfg)
        assert got == want, {k: (got[k], want[k]) for k in want if got[k] != want[k]}


def test_toml_refuses_unknown_keys_as_jax_does(tmp_path):
    for text, err in (("nope = 1\n", ValueError), ("[obs]\nnope = 1\n", TypeError),
                      ("[controller]\nnope = 1\n", TypeError),
                      ("[perf]\nnope = 1\n", TypeError), ("pipeline = true\n", ValueError)):
        p = tmp_path / "bad.toml"
        p.write_text(text)
        with pytest.raises(err):
            jconfig.RescheduleConfig.from_toml(p)
        with pytest.raises(err):
            tconfig.RescheduleConfig.from_toml(p)


def test_toml_item5_fields_are_refused_naming_the_item(tmp_path):
    p = tmp_path / "mesh.toml"
    # the fields of ROADMAP Queue 1 item 5 (the mesh plane's rule, the dp
    # plane) load as in the JAX package; a ratio below 1 is refused by both
    p.write_text("[obs]\nslo_mesh_imbalance_ratio = 1.5\n[fleet]\ntenants = 2\nplane = 'dp'\n")
    j = jconfig.RescheduleConfig.from_toml(p)
    t = tconfig.RescheduleConfig.from_toml(p)
    assert (t.slo_mesh_imbalance_ratio, t.fleet.plane) == \
        (j.obs.slo_mesh_imbalance_ratio, j.fleet.plane) == (1.5, "dp")
    p.write_text("[obs]\nslo_mesh_imbalance_ratio = 0.5\n")
    for loader in (jconfig.RescheduleConfig.from_toml, tconfig.RescheduleConfig.from_toml):
        with pytest.raises(ValueError, match="mesh_imbalance"):
            loader(p)
    # restarts are carried: the TOML field loads as in the JAX package
    p.write_text("solver_restarts = 2\n[controller]\ndonate_carry = false\n"
                 "[obs]\ndevice_rollup = false\n")
    assert tconfig.RescheduleConfig.from_toml(p).solver_restarts == 2 == \
        jconfig.RescheduleConfig.from_toml(p).solver_restarts
    p.write_text("namespace = 'prod'\ndelete_timeout_s = 60.0\n[controller]\n"
                 "donate_carry = false\n[obs]\ndevice_rollup = false\ndevice_label_budget = 4\n")
    cfg = tconfig.RescheduleConfig.from_toml(p)
    assert (cfg.namespace, cfg.delete_timeout_s, cfg.donate_carry, cfg.device_rollup,
            cfg.device_label_budget) == ("prod", 60.0, False, False, 4)


def test_profiling_timer_and_trace_to():
    from kubernetes_rescheduling_tpu_torch.telemetry import spans

    with tprofiling.Timer() as t:
        sum(range(1000))
    assert t.elapsed_s > 0
    assert tprofiling.trace_to is spans.trace_to


def test_dataset_report_on_a_session_without_attribution(tmp_path):
    p = tmp_path / "rounds.jsonl"
    p.write_text(json.dumps({"round": 1}) + "\n")
    assert tdataset.report_dataset([p]) == jdataset.report_dataset([p])
    assert "no attribution records" in tdataset.report_dataset([p])

