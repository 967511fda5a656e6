"""One run of one cell: set-up, the measured window, the reading of the
trace, the check of what the window produced, and the result line.

Everything that belongs to a cell is found by name: ``BENCHMARK.json``
lists cells and metrics, ``cells/<workload>.json`` names the cell's
configuration, driver and traffic, ``configs/<config>.json`` holds the
deployment, ``drivers/<driver>.py`` drives the entry, ``metrics/<quantity>.py``
reads one per-layer quantity and ``counts/<kernel>.py`` counts one kernel's
work.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "kubernetes_rescheduling_tpu")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark() -> dict:
    return load_json(BENCHMARK)


def cell_spec(workload: str) -> dict:
    return load_json(ROOT / "cells" / f"{workload}.json")


def config_spec(name: str) -> dict:
    return load_json(ROOT / "configs" / f"{name}.json")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: the port's own name only begins with
    the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


class NoDevice(Exception):
    """The cell's CUDA devices are not there."""


class ForbiddenModules(Exception):
    """A module of the JAX package was loaded in the run's process."""


@dataclass
class Hooks:
    """The clock and the trace the drivers report to. A driver runs its
    warm-up, calls :meth:`open_window` once, then calls :meth:`round_end`
    when each timed round's decision is on the host, and stops when it
    returns False."""

    seconds: float
    trace_seconds: float = 0.0
    t0: float | None = None
    ends: list[float] = field(default_factory=list)
    profiler: object | None = None
    traced_rounds: int = 0
    trace_events: list | None = None

    def span(self, name: str):
        """A host span of the harness's own, seen by the profiler only."""
        if self.profiler is None:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(f"perfbench/{name}")

    def _mark(self) -> None:
        if self.profiler is not None:
            import torch
            with torch.profiler.record_function("perfbench/mark"):
                pass

    def open_window(self) -> None:
        # the set-up's objects leave the collector's scans: a round's
        # collections then cost what the round's own objects cost
        gc.collect()
        gc.freeze()
        if self.trace_seconds > 0:
            import torch
            from torch.profiler import ProfilerActivity
            self.profiler = torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.profiler.start()
        self.t0 = time.perf_counter()
        self._mark()

    def round_end(self) -> bool:
        t = time.perf_counter()
        self.ends.append(t)
        self._mark()
        going = t - self.t0 < self.seconds
        if self.profiler is not None and (t - self.t0 >= self.trace_seconds or not going):
            self.stop_trace()
        return going

    def stop_trace(self) -> None:
        if self.profiler is not None:
            self.traced_rounds = len(self.ends)
            t = time.perf_counter()
            self.profiler.stop()
            self.trace_events = list(self.profiler.profiler.kineto_results.events())
            self.profiler = None
            print(f"perfbench: trace of {self.traced_rounds} rounds, {len(self.trace_events)} "
                  f"events, stopped in {time.perf_counter() - t:.1f} s", file=sys.stderr)

    def latencies_s(self) -> list[float]:
        prev = [self.t0] + self.ends[:-1]
        return [b - a for a, b in zip(prev, self.ends)]


def p95(values: list[float]) -> float:
    """The 95th percentile (``statistics.quantiles``, inclusive method)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


@dataclass
class RunData:
    """What the per-layer readers read: the window's rounds, the driver's
    program counters, the trace summary and the shapes of the kernels'
    launches."""

    rounds: int
    captures: int | None = None
    trace: object | None = None
    kernel_shapes: dict = field(default_factory=dict)


def metrics_for(bench: dict, group: str, workload: str) -> list[dict]:
    return [m for m in bench[group] if workload in m.get("workloads", [workload])]


def quantity(name: str) -> str:
    """What a metric measures: its name up to the first dot. A quantity
    that cells of different noise report is split into a metric each
    (``round_ms.dense``, ``round_ms.sparse``), each with its own bound."""
    return name.split(".", 1)[0]


def read_layer_metrics(bench: dict, workload: str, run: RunData) -> dict:
    out = {}
    for m in metrics_for(bench, "per_layer", workload):
        reader = importlib.import_module(f"perfbench.metrics.{quantity(m['name'])}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(torch, device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_start: float | None = None, bench: dict | None = None,
             cell: dict | None = None, config: dict | None = None) -> dict:
    """One run; returns the result object. ``device="cpu"`` (the tests)
    runs the same path on the port's plain kernel versions."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise ValueError(f"unknown workload {workload!r}")
    cell = cell_spec(workload) if cell is None else cell
    config = config_spec(cell["config"]) if config is None else config

    import torch

    # one host thread for the port's CPU-side ops: the run is one process
    # on a card whose host cores other tenants share
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            raise NoDevice(f"{workload} needs {entry['chips']} CUDA device(s); found "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        torch.cuda.reset_peak_memory_stats(dev)
    driver_mod = importlib.import_module(f"perfbench.drivers.{cell['driver']}")
    # a traced run's window is its trace: it reports no end-to-end metric,
    # and what ``correct`` samples comes from the traced rounds
    trace_s = float(cell["trace_seconds"]) if trace else 0.0
    hooks = Hooks(seconds=trace_s if trace else seconds, trace_seconds=trace_s)
    driver = driver_mod.Driver(cell, config, seed, dev, hooks)
    driver.run()
    hooks.stop_trace()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    lat = hooks.latencies_s()
    window_s = hooks.ends[-1] - hooks.t0
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(", ".join(found))
    device_block = device_info(torch, dev, entry["chips"])
    result: dict = {"correct": False, "attempted": len(lat), "failed": driver.failed_rounds()}

    if trace:
        from perfbench import devtrace
        t = time.perf_counter()
        summary = devtrace.summarize(hooks.trace_events, hooks.traced_rounds)
        print(f"perfbench: trace read in {time.perf_counter() - t:.1f} s", file=sys.stderr)
        run = RunData(rounds=len(lat),
                      captures=driver.captures_in_window(), trace=summary,
                      kernel_shapes=driver.kernel_shapes())
        metrics = read_layer_metrics(bench, workload, run)
        if summary is not None:
            device_block["busy_s"] = summary.busy_s
            device_block["window_s"] = summary.window_s
    else:
        setup_s = hooks.t0 - t_start
        values = {"round_ms": window_s / len(lat) * 1e3, "round_p95_ms": p95(lat) * 1e3,
                  "setup_s": setup_s, **driver.end_to_end()}
        metrics = {m["name"]: {"value": values[quantity(m["name"])], "unit": m["unit"]}
                   for m in metrics_for(bench, "end_to_end", workload)}
    driver.close_window()
    checks = driver.check()
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["metrics"] = metrics
    result["device"] = device_block
    if trace and summary is not None:
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    return result
