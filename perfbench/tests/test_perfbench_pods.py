"""The per-pod cell at a size the CPU holds: 2,000 three-pod services on 240
nodes, through the same entry, driver, reference and checks, with the
kernels' plain versions."""

import copy
import itertools
import json

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.drivers import drift_pods
from perfbench.reference import pods

WORKLOAD = "pods150k.drift"


def spec():
    cell = copy.deepcopy(harness.cell_spec(WORKLOAD))
    config = copy.deepcopy(harness.config_spec(cell["config"]))
    config["services"], config["nodes"] = 2000, 240
    # the kernel lowering through the kernels' plain versions, as on the card
    config["solver"]["fused_epilogue"] = "on"
    cell["traffic"].update(pool_rounds=40, warmup_rounds=2, warmup_seconds=0.0)
    cell["check"]["sample_rounds"] = 2
    return cell, config


@pytest.fixture(scope="module")
def result():
    cell, config = spec()
    return harness.run_cell(WORKLOAD, 2**31 + 17, 2.0, False, device="cpu", cell=cell,
                            config=config)


def test_cut_cell_is_correct_with_the_result_schema(result):
    json.dumps(result)
    assert list(result)[:3] == ["correct", "attempted", "failed"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    bench = harness.benchmark()
    want = {m["name"]: m["unit"] for m in harness.metrics_for(bench, "end_to_end", WORKLOAD)}
    assert set(want) == {"round_ms.sparse", "round_p95_ms.sparse", "remote_traffic_pct.sparse",
                         "setup_s"}
    assert {k: v["unit"] for k, v in result["metrics"].items()} == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert result["checks"]["placement_mismatch_share"]["value"] == 0


def test_cut_cell_control_is_not_correct():
    cell, config = spec()
    d = drift_pods.Driver(cell, config, 7, torch.device("cpu"), harness.Hooks(seconds=0))
    d.run_control(d.warmup + 3)
    checks = d.check()
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


@pytest.mark.parametrize("counts", [(3, 3, 3, 3), (1, 1, 1, 1), (2, 1, 3, 2)])
def test_expansion_equals_plain_loops(counts):
    rng = np.random.default_rng(sum(counts))
    S = len(counts)
    svc = rng.permutation(np.repeat(np.arange(S), counts))
    ii, jj = (np.array(x) for x in zip(*itertools.combinations(range(S), 2)))
    pa, pb, call = pods.expand(ii, jj, svc)
    want = [(a, b, e) for e, (s, t) in enumerate(zip(ii, jj))
            for a in np.flatnonzero(svc == s) for b in np.flatnonzero(svc == t)]
    assert list(zip(pa, pb, call)) == want
    assert np.array_equal(pods.call_index(ii, jj, S, svc[pb], svc[pa]), call)


def test_expansion_equals_np_repeat_for_grouped_replicas():
    S, R = 50, 3
    ii = np.arange(1, S) // 2
    jj = np.arange(1, S)
    order = np.lexsort((jj, ii))
    ii, jj = ii[order], jj[order]
    pa, pb, call = pods.expand(ii, jj, pods.pod_services(S, R))
    E = len(ii)
    assert np.array_equal(call, np.repeat(np.arange(E), R * R))
    assert np.array_equal(pa, np.repeat(ii * R, R * R) + np.tile(np.repeat(np.arange(R), R), E))
    assert np.array_equal(pb, np.repeat(jj * R, R * R) + np.tile(np.arange(R), E * R))
