"""The multichip dry run in the port (``parallel/dryrun.py``, the
counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``): on
a 2 × 2 gloo mesh of spawned processes (``parallel.launch.run_group``),
on a world of two that shapes its own (1, 2) mesh, in one process, and as
``python -m kubernetes_rescheduling_tpu_torch.parallel.dryrun``; and a
sharded solve that diverges from its single-device twin fails it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from kubernetes_rescheduling_tpu_torch.parallel import dryrun
from kubernetes_rescheduling_tpu_torch.parallel import sharded_sparse
from kubernetes_rescheduling_tpu_torch.parallel.launch import run_group

FN = "kubernetes_rescheduling_tpu_torch.parallel.dryrun.dryrun_multichip"
GROUP_TIMEOUT_S = 120.0
ALL_CHECKS = ["parallel_restarts", "sharded_choose_node", "sharded_global_assign",
              "tp_dense_move_cost_0", "tp_dense_move_cost_1", "tp_sparse",
              "solve_with_restarts_dp_x_tp", "sparse_dp_x_tp", "tp_pod_mode"]


def test_dryrun_on_a_2x2_mesh(tmp_path):
    outs = run_group(FN, (2, 2), rendezvous=str(tmp_path / "rdzv"), timeout_s=GROUP_TIMEOUT_S)
    assert outs == [{"dp": 2, "tp": 2, "checks": ALL_CHECKS}] * 4


def test_dryrun_shapes_its_mesh_from_the_world(tmp_path):
    """A world of two: tp = 2 (the node axis sharded), dp = 1, so the
    sparse dp × tp composition has nothing to compose and is left out, as
    in the JAX dry run."""
    outs = run_group(FN, (2,), kwargs=dict(device="cpu"), pass_mesh=False,
                     rendezvous=str(tmp_path / "rdzv"), timeout_s=GROUP_TIMEOUT_S)
    want = [c for c in ALL_CHECKS if c != "sparse_dp_x_tp"]
    assert outs == [{"dp": 1, "tp": 2, "checks": want}] * 2


def test_dryrun_module_entry_point():
    """``python -m ...parallel.dryrun --device cpu`` without ``torchrun``:
    one process, one JSON line."""
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    env.pop("WORLD_SIZE", None)
    out = subprocess.run([sys.executable, "-m", "kubernetes_rescheduling_tpu_torch.parallel.dryrun",
                          "--device", "cpu"], capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["dp"] == doc["tp"] == 1 and "tp_pod_mode" in doc["checks"]


def test_dryrun_catches_a_divergent_shard(monkeypatch):
    """The dry run is a gate: a tp sparse solve that places one pod
    elsewhere than its single-device twin fails it."""
    real = sharded_sparse.sharded_sparse_assign

    def off_by_one(state, *args, **kwargs):
        st, info = real(state, *args, **kwargs)
        node = st.pod_node.clone()
        node[0] = (node[0] + 1) % state.num_nodes
        return st.replace(pod_node=node), info

    monkeypatch.setattr(sharded_sparse, "sharded_sparse_assign", off_by_one)
    with pytest.raises(AssertionError, match="tp-sharded sparse solve diverged"):
        dryrun.dryrun_multichip(device="cpu")
