"""Seconds the port's capture cache spent on misses in the run, its
set-up included: ``cuda_graph_capture_seconds_total`` summed over every
fn."""

from perfbench.metrics._program import capture_seconds


def read(run):
    return capture_seconds()
