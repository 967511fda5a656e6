"""Device ms a round of the solve phase ``epilogue`` in the cell's entry,
from the port's phase events (``telemetry/phases.py``)."""

from perfbench.metrics._program import phase_ms_a_round


def read(run):
    return phase_ms_a_round("epilogue")
