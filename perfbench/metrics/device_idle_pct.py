"""The share of the traced rounds' wall in which no operation ran on the
device: 100 × (1 − union of device-busy intervals / window)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
