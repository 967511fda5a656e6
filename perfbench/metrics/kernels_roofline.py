"""The kernels' share of their rooflines together: Σ over every traced
launch of a kernel with a count (``counts/``) of its bound over Σ of their
measured device time."""

from perfbench.devtrace import kernel_symbols
from perfbench.layer import roofline_pct


def read(run):
    return roofline_pct(run, sorted(kernel_symbols()))
