"""The trace reduction: busy time is a union of intervals within the traced
rounds, idle time is split over the host spans it overlaps, and kernels
are found by their symbols."""

import pytest

from perfbench import devtrace


class Ev:
    def __init__(self, name, dev, a, b, annotation=False):
        self._n, self._d, self._a, self._b, self._u = name, dev, a, b, annotation

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def duration_ns(self):
        return self._b - self._a

    def is_user_annotation(self):
        return self._u


def test_summary_of_two_rounds():
    ms = 1_000_000
    events = [
        Ev(devtrace.MARK, False, 0, 0), Ev(devtrace.MARK, False, 10 * ms, 10 * ms),
        Ev(devtrace.MARK, False, 20 * ms, 20 * ms), Ev(devtrace.MARK, False, 30 * ms, 30 * ms),
        Ev("perfbench/entry", False, 0, 4 * ms), Ev("perfbench/readback", False, 8 * ms, 9 * ms),
        Ev("void mass_kernel<float>(float const*)", True, 2 * ms, 5 * ms),
        Ev("void score_kernel(float const*)", True, 4 * ms, 6 * ms),     # overlaps the mass
        Ev("gemm", True, 12 * ms, 18 * ms),
        Ev("gpu_user_annotation", True, 0, 30 * ms, annotation=True),  # not device work
        Ev("late", True, 25 * ms, 40 * ms),                             # past the two rounds
    ]
    s = devtrace.summarize(events, traced_rounds=2)
    assert s.rounds == 2
    assert s.window_s == pytest.approx(0.020)
    assert s.busy_s == pytest.approx(0.004 + 0.006)
    assert s.kernels["mass"] == (1, pytest.approx(0.003))
    assert s.kernels["score"] == (1, pytest.approx(0.002))
    idle = dict(s.idle_gaps)
    assert idle["entry"] == pytest.approx(0.002)       # 0–2 ms
    assert idle["readback"] == pytest.approx(0.001)    # 8–9 ms
    assert idle[devtrace.OUTSIDE] == pytest.approx(0.007)  # 6–8, 9–12, 18–20 ms
    assert sum(idle.values()) + s.busy_s == pytest.approx(s.window_s)


def test_no_device_work_reads_nothing():
    assert devtrace.summarize([Ev(devtrace.MARK, False, 0, 0), Ev(devtrace.MARK, False, 5, 5)],
                              traced_rounds=1) is None
    assert devtrace.summarize([], traced_rounds=1) is None


def test_long_names_are_cut():
    name = "void at::native::elementwise_kernel<" + "x" * 500 + ">(int)"
    short = devtrace.short_name(name)
    assert len(short) == devtrace.NAME_CHARS and not short.startswith("void ")
