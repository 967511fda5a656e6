"""Device ms a round of the solve phase ``fanout`` in the cell's entry (a
pod replay's gather of call-pair weights onto pod pairs), from the port's
phase events (``telemetry/phases.py``)."""

from perfbench.metrics._program import phase_ms_a_round


def read(run):
    return phase_ms_a_round("fanout")
