"""The kernels' device time as a share of all device-busy time in the
traced rounds (trace names mapped to kernels by ``counts/``)."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.trace.kernels:
        return None
    return 100.0 * sum(s for _, s in run.trace.kernels.values()) / run.trace.busy_s
