"""Kernel mass's share of its roofline: Σ of its launches' bounds over Σ of
their measured device time (``counts/mass.py``)."""

from perfbench.layer import roofline_pct


def read(run):
    return roofline_pct(run, ["mass"])
