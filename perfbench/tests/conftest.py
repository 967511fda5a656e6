"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
checkout's root. Tests marked ``card`` need a CUDA device and skip without
one; they decide so inside a fixture, never while a module is imported."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs the cell on the card")
    return torch.device("cuda")
