"""Device-busy ms a round: the union of the intervals in which an
operation ran on the device over the traced rounds, over their count."""


def read(run):
    if run.trace is None or run.trace.rounds <= 0:
        return None
    return run.trace.busy_s / run.trace.rounds * 1e3
