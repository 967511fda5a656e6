"""The measured multichip harness in the port (``bench/multichip.py``), the
cases of tests/test_multichip.py:91-189: the fleet scan over the dp mesh
decides as the single-device fleet scan (and as the JAX package's), the
mesh plane observing it changes nothing, a block is one capture key and
one counted ``round_end`` read, the decode checks divisibility, and the
``bench_multichip`` record passes ``scripts/check_bench_schema.py``.

The multi-rank cases run as gloo groups of 2 or 4 spawned processes
(``parallel.launch.run_group``, each with its own timeout); the tenants are
the JAX package's fleet bench problem (``make_fleet_problem``, the same
numpy seeds in both packages). Bars: decisions, hazard masks and landings
exactly, the per-round metrics at rtol 1e-5 (tests/test_multichip.py's).
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubernetes_rescheduling_tpu.bench import harness as jharness
from kubernetes_rescheduling_tpu.bench import scan as jscan
from kubernetes_rescheduling_tpu.solver.fleet import stack_tenants as j_stack
from kubernetes_rescheduling_tpu_torch.bench import multichip as tmc
from kubernetes_rescheduling_tpu_torch.bench import scan as tscan
from kubernetes_rescheduling_tpu_torch.bench.harness import make_fleet_problem
from kubernetes_rescheduling_tpu_torch.objectives.metrics import comm_edge_list
from kubernetes_rescheduling_tpu_torch.parallel.launch import run_group
from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS
from kubernetes_rescheduling_tpu_torch.solver import compiled
from kubernetes_rescheduling_tpu_torch.telemetry import MeshPlane, MetricsRegistry

PKG = "kubernetes_rescheduling_tpu_torch"
GROUP_TIMEOUT_S = 120.0
PID = POLICY_IDS["communication"]


def load_checker():
    path = Path(__file__).resolve().parent.parent / "scripts" / "check_bench_schema.py"
    spec = importlib.util.spec_from_file_location("check_bench_schema", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("check_bench_schema", mod)
    spec.loader.exec_module(mod)
    return mod


def problem(tenants=8, n_services=40, n_nodes=26):
    states, graphs = make_fleet_problem(tenants=tenants, n_services=n_services,
                                        n_nodes=n_nodes, device="cpu")
    return states, graphs, [comm_edge_list(g) for g in graphs]


def dp_block(tmp_path, world, states, graphs, edges, rounds, name="rdzv", thr=30.0):
    """The dp scan on every rank of a gloo group of ``world`` (the mesh
    shaped from the world); every rank's bundle must be equal."""
    outs = run_group(f"{PKG}.bench.multichip.fleet_scan_rounds_dp", (world,),
                     (states, graphs, edges, PID, thr), dict(rounds=rounds),
                     pass_mesh=False, rendezvous=str(tmp_path / name),
                     timeout_s=GROUP_TIMEOUT_S)
    for o in outs[1:]:
        np.testing.assert_array_equal(o.numpy(), outs[0].numpy())
    return outs[0].numpy()


def test_dp_scan_bit_identical_to_single_device(tmp_path):
    """tests/test_multichip.py:91 over dp = 4: decisions, hazard masks and
    landings exactly the single-device fleet scan's (the port's and the
    JAX package's), metrics at rtol 1e-5. At a hazard threshold of 10 %
    (the JAX case's 30 % flags no node of this problem, so nothing moves)."""
    n_nodes, rounds, tenants, thr = 26, 4, 8, 10.0
    states, graphs, edges = problem(n_nodes=n_nodes)
    flat_dp = dp_block(tmp_path, 4, states, graphs, edges, rounds, thr=thr)
    flat_1 = tscan.fleet_scan_rounds(states, graphs, edges, PID, thr, rounds=rounds,
                                     pinned=True).numpy()
    got = tmc.decode_fleet_block_dp(flat_dp, rounds=rounds, tenants=tenants,
                                    num_nodes=n_nodes, dp=4)
    want = tscan.decode_fleet_block(flat_1, rounds=rounds, tenants=tenants, num_nodes=n_nodes)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)
    j_states, j_graphs = jharness.make_fleet_problem(tenants=tenants, n_services=40,
                                                     n_nodes=n_nodes)
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), t) for t in range(tenants)])
    j_flat = jscan.fleet_scan_rounds(j_stack(j_states), j_stack(j_graphs), jnp.asarray(PID),
                                     jnp.asarray(thr), keys, jnp.asarray(0, jnp.int32),
                                     rounds=rounds, pinned=True)
    j_dec = jscan.decode_fleet_block(np.asarray(j_flat), rounds=rounds, tenants=tenants,
                                     num_nodes=n_nodes)
    for a, b in zip(got[:3], j_dec[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[3], j_dec[3], rtol=1e-5)
    assert (got[2] >= 0).any()


def test_dp_scan_identical_with_telemetry_on_and_off(tmp_path):
    """tests/test_multichip.py:133: the mesh plane is host-side attribution
    only — the same bundle whether one observes the block or not."""
    rounds, tenants, n_nodes = 4, 8, 27
    states, graphs, edges = problem(n_nodes=n_nodes)
    bare = dp_block(tmp_path, 2, states, graphs, edges, rounds, "bare")
    plane = MeshPlane(MetricsRegistry(), device_names=["cpu:0", "cpu:1"], sample_memory=False)
    observed = dp_block(tmp_path, 2, states, graphs, edges, rounds, "observed")
    _dec, _hz, _land, met = tmc.decode_fleet_block_dp(observed, rounds=rounds, tenants=tenants,
                                                      num_nodes=n_nodes, dp=2)
    plane.observe_block(dispatch_s=0.01, transfer_bytes=int(observed.nbytes),
                        weights=met[..., 0].sum(axis=0), rounds=rounds)
    np.testing.assert_array_equal(observed, bare)
    assert plane.health_block()["devices"] == 2


def test_dp_scan_one_capture_one_transfer_per_block(monkeypatch):
    """tests/test_multichip.py:156: three blocks hand the capture cache ONE
    key, each block is ONE counted ``round_end`` read (none at the
    per-round sites), and the byte twin counts the pulled bundles."""
    keys = []
    real = compiled.GraphCache.run

    def record(self, fn, key, inputs, make_body, operands=()):
        keys.append(compiled.GraphCache._full_key(fn, key, inputs, operands))
        return real(self, fn, key, inputs, make_body, operands)

    monkeypatch.setattr(compiled.GraphCache, "run", record)
    reg = MetricsRegistry()
    states, graphs, edges = problem(n_nodes=28)
    for _ in range(3):
        flat = tscan.pull_block(tmc.fleet_scan_rounds_dp(states, graphs, edges, PID, 30.0,
                                                         rounds=5), registry=reg)
    assert len(keys) == 3 and len(set(keys)) == 1 and keys[0][0] == "fleet_scan_rounds"
    fam = reg.counter("device_transfers_total", labelnames=("site",))
    assert fam.labels(site="round_end").value == 3
    assert fam.labels(site="fleet_decision").value == 0
    assert fam.labels(site="fleet_metrics").value == 0
    by = reg.counter("device_transfer_bytes_total", labelnames=("site",))
    assert by.labels(site="round_end").value == pytest.approx(3 * flat.nbytes)


def test_decode_fleet_block_dp_validates_divisibility():
    with pytest.raises(ValueError, match="not divisible"):
        tmc.decode_fleet_block_dp(np.zeros(8, np.float32), rounds=1, tenants=6, num_nodes=4,
                                  dp=4)


def check_record(result, n_devices, tmp_path):
    ex = result["extra"]
    assert result["metric"] == "fleet_scan_rounds_per_sec"
    assert result["value"] > 0 and np.isfinite(result["value"])
    assert ex["n_devices"] == ex["dp"] == n_devices
    assert ex["device_kind"] == "cpu" and len(ex["devices"]) == n_devices
    assert ex["rounds_per_block"] == 3
    assert np.isfinite(ex["step_ms_p99"]) and ex["step_ms_p99"] >= 0
    assert ex["imbalance_ratio"] >= 1.0
    nested = result["device_step_reading"]
    assert nested["metric"] == "multichip_device_step_ms_p99"
    assert nested["better"] == "lower" and nested["value"] == ex["step_ms_p99"]
    checker = load_checker()
    assert checker.check_parsed(result, "r06") == []
    record = {"n_devices": n_devices, "device_kind": ex["device_kind"], "rc": 0, "ok": True,
              "measured": True, "cmd": "python -m kubernetes_rescheduling_tpu_torch",
              "tail": json.dumps(result), "parsed": result}
    p = tmp_path / "MULTICHIP_r06.json"
    p.write_text(json.dumps(record, indent=1) + "\n")
    assert checker.check_file(p) == []


def test_bench_multichip_record_passes_schema(tmp_path):
    """tests/test_multichip.py:189: the harness end to end in one process
    (dp = 1: three counted round_end reads, one untimed and two timed) and
    over a gloo group of 2 (dp = 2, every rank the same readings but the
    host-clock timings); each record passes ``check_bench_schema``'s check
    of a measured MULTICHIP record."""
    reg = MetricsRegistry()
    kw = dict(tenants=8, n_services=40, n_nodes=29, rounds=3, reps=2, rtt_ms=0.05)
    result = tmc.bench_multichip(**kw, registry=reg, device="cpu")
    check_record(result, 1, tmp_path)
    fam = reg.counter("device_transfers_total", labelnames=("site",))
    assert fam.labels(site="round_end").value == 3
    outs = run_group(f"{PKG}.bench.multichip.bench_multichip", (2,), (), dict(kw, device="cpu"),
                     pass_mesh=False, rendezvous=str(tmp_path / "rdzv"),
                     timeout_s=GROUP_TIMEOUT_S)
    for out in outs:
        check_record(out, 2, tmp_path)
        assert out["extra"]["devices"] == ["cpu:0", "cpu:1"]
