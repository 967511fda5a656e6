"""Host ms a step of the port's ``replay/plans`` span (self time), over the
steps its ``replay/call`` spans ran in the traced window."""

from perfbench.metrics._program import span_self_ms_a_step


def read(run):
    return span_self_ms_a_step("replay/plans")
