"""A run's result object at a size the CPU holds: the contract's keys, the
cell's metrics with their units, and the compared numbers last."""

import json

import pytest

from perfbench import harness
from perfbench.tests import small


@pytest.fixture(scope="module", params=sorted(small.SIZES))
def result(request):
    return request.param, small.run(request.param, seed=2**31 + 17)


def test_result_line_schema(result):
    workload, res = result
    json.dumps(res)
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert {"metrics", "device"} <= set(res)
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    bench = harness.benchmark()
    want = {m["name"]: m["unit"] for m in harness.metrics_for(bench, "end_to_end", workload)}
    assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_run_is_correct_and_every_round_counted(result):
    _, res = result
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
