"""Cells cut to a size a CPU test run holds: the same entry, drivers,
references and checks, with the kernels' plain versions."""

import copy

import torch

from perfbench import harness

SIZES = {"dense12k.drift": (2560, 256), "sparse60k.drift": (6000, 240)}


def spec(workload: str):
    cell = copy.deepcopy(harness.cell_spec(workload))
    config = copy.deepcopy(harness.config_spec(cell["config"]))
    config["services"], config["nodes"] = SIZES[workload]
    # the kernel lowering through the kernels' plain versions, as on the card
    config["solver"]["fused_epilogue"] = "on"
    cell["traffic"]["pool_rounds"] = 40
    cell["traffic"]["warmup_rounds"] = 2
    cell["traffic"]["warmup_seconds"] = 0.0
    cell["check"]["sample_rounds"] = 2
    return cell, config


def run(workload: str, seed: int, seconds: float = 2.0, trace: bool = False) -> dict:
    cell, config = spec(workload)
    return harness.run_cell(workload, seed, seconds, trace, device="cpu",
                            cell=cell, config=config)


def driver(workload: str, seed: int):
    import importlib

    cell, config = spec(workload)
    mod = importlib.import_module(f"perfbench.drivers.{cell['driver']}")
    return mod.Driver(cell, config, seed, torch.device("cpu"), harness.Hooks(seconds=0))
