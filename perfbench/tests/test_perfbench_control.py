"""The comparison that decides ``correct`` fails its control (the reference
in the port's place, in the precisions below the configuration's) and the
faults a cell can have, planted underneath a run that skips only the look
for a card."""

import pytest

from perfbench.drivers import drift
from perfbench.tests import small


@pytest.mark.parametrize("workload", ["dense12k.drift", "sparse60k.drift"])
def test_drift_control_is_not_correct(workload):
    d = small.driver(workload, seed=7)
    d.run_control(d.warmup + 3)
    checks = d.check()
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def _unchanged(real):
    def fake(state, *a, **k):
        _, _, before = real(state, *a, **k)
        return state, before, before
    return fake


def _half(real):
    def fake(state, *a, **k):
        new, after, before = real(state, *a, **k)
        keep = new.pod_node.clone()
        half = keep.shape[0] // 2
        keep[half:] = state.pod_node[half:]
        return new.replace(pod_node=keep), after, before
    return fake


def _altered(real):
    def fake(state, *a, **k):
        new, after, before = real(state, *a, **k)
        pod = new.pod_node.clone()
        pod[0] = (pod[0] + 1) % new.num_nodes
        return new.replace(pod_node=pod), after, before
    return fake


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("workload, entry", [("dense12k.drift", "replay_on_device"),
                                             ("sparse60k.drift", "replay_on_device_sparse")])
def test_drift_fault_is_not_correct(monkeypatch, fault, workload, entry):
    monkeypatch.setattr(drift.port_trace, entry, fault(getattr(drift.port_trace, entry)))
    res = small.run(workload, seed=9, seconds=1.0)
    assert res["correct"] is False, res["checks"]

