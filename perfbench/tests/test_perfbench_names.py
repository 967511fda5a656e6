"""Everything a cell needs is found by name from BENCHMARK.json."""

import importlib
import json

from perfbench import devtrace, harness


def test_every_workload_finds_its_cell_config_and_driver():
    bench = harness.benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = harness.cell_spec(w["name"])
        assert cell["config"] == w["config"]
        assert cell["why"] == w["why"]
        config = harness.config_spec(cell["config"])
        assert config["name"] == w["config"]
        assert configs[w["config"]]["file"] == f"perfbench/configs/{w['config']}.json"
        assert sorted(config["reduced"]) == sorted(configs[w["config"]]["reduced"])
        assert config["source"] == configs[w["config"]]["source"]
        mod = importlib.import_module(f"perfbench.drivers.{cell['driver']}")
        assert hasattr(mod, "Driver")


def test_every_metric_finds_its_reader_and_names_its_cells():
    bench = harness.benchmark()
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        reader = importlib.import_module(f"perfbench.metrics.{harness.quantity(m['name'])}")
        assert callable(reader.read)
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in harness.metrics_for(bench, "end_to_end", w)}
    for w in cells:
        names = {m["name"] for m in harness.metrics_for(bench, "end_to_end", w)}
        assert "setup_s" in names and len(names) >= 2
        assert harness.metrics_for(bench, "per_layer", w)


def test_every_kernel_count_names_its_trace_symbol():
    symbols = devtrace.kernel_symbols()
    assert set(symbols) >= {"mass", "score", "admission"}
    pat = devtrace.symbol_pattern(symbols["mass"])
    assert pat.search("void mass_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int)")
    assert not pat.search("void chunk_mass_kernel<float>(float const*)")
    assert not pat.search("void hub_mass_kernel<float>(float const*)")


def test_benchmark_json_keys_and_limits():
    bench = json.loads(harness.BENCHMARK.read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
