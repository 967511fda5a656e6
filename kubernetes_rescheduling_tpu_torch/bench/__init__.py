"""The experiment harness — the port of ``kubernetes_rescheduling_tpu.bench``:

- ``controller`` — drives any backend round by round, with
  decision-latency measurement;
- ``fleet`` — the multiplexed fleet loop: one boundary and breaker a
  tenant, one batched device decision a round;
- ``harness`` — the algorithm × repeat experiment matrix with per-session
  result directories, and the benchmark scenario factory;
- ``loadgen`` — request-level load generation on the device;
- ``sinks`` — the reference's CSV metric files and structured JSONL.
"""

# resolved lazily (PEP 562): the solver and the fleet import modules of
# this package (``round_end``, ``scan``) that the controller imports back,
# so an eager import here would close that cycle
_LAZY = {
    "ControllerResult": "controller",
    "run_controller": "controller",
    "FleetResult": "fleet",
    "run_fleet_controller": "fleet",
    "ExperimentConfig": "harness",
    "run_experiment": "harness",
    "LoadGenConfig": "loadgen",
    "LoadGenerator": "loadgen",
    "RequestStats": "loadgen",
    "CsvSink": "sinks",
    "JsonlSink": "sinks",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f"kubernetes_rescheduling_tpu_torch.bench.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ControllerResult",
    "run_controller",
    "FleetResult",
    "run_fleet_controller",
    "CsvSink",
    "JsonlSink",
    "ExperimentConfig",
    "run_experiment",
    "LoadGenConfig",
    "LoadGenerator",
    "RequestStats",
]
