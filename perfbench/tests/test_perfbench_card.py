"""On the card: one short run of each cell through the command, correct."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in harness.benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload,
                          "--seed", "424242", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
