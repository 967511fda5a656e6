"""Checkpoint/resume and the structured logger against the JAX package on
the CPU: the shared on-disk format (a checkpoint either package writes
loads in the other, with equal arrays and dtypes), a resumed run equal to
an uninterrupted one (greedy and global), a resume across the packages,
and the logger's events.
"""

import json

import numpy as np
import pytest
from test_torch_controller import _global_plans, assert_same_records, jax_greedy_gumbel

from kubernetes_rescheduling_tpu.bench.controller import run_controller as j_run
from kubernetes_rescheduling_tpu.bench.harness import make_backend as j_make
from kubernetes_rescheduling_tpu.config import RescheduleConfig as JConfig
from kubernetes_rescheduling_tpu.telemetry import MetricsRegistry as JRegistry
from kubernetes_rescheduling_tpu.utils import checkpoint as jckpt
from kubernetes_rescheduling_tpu.utils.logging import StructuredLogger as JLogger
from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller as t_run
from kubernetes_rescheduling_tpu_torch.bench.harness import make_backend as t_make
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig as TConfig
from kubernetes_rescheduling_tpu_torch.telemetry import MetricsRegistry as TRegistry
from kubernetes_rescheduling_tpu_torch.utils import checkpoint as tckpt
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger as TLogger
from kubernetes_rescheduling_tpu_torch.utils.logging import get_logger


def _arrays(state):
    return {f: np.asarray(getattr(state, f)) for f in tckpt._ARRAY_FIELDS}


def test_checkpoint_format_is_shared(tmp_path):
    """A JAX-written checkpoint loads in the port and a port-written one in
    the JAX package: equal arrays, dtypes, names and extra."""
    jb, tb = j_make("mubench", 0), t_make("mubench", 0, device="cpu")
    extra = {"algorithm": "global", "reconcile": {"intent": {"s0-0": "worker1"}}}
    jckpt.save_state(jb.monitor(), tmp_path / "from_jax", extra=extra)
    tckpt.save_state(tb.monitor(), tmp_path / "from_torch", extra=extra)
    for name in ("from_jax", "from_torch"):
        t_state, t_extra = tckpt.load_state(tmp_path / name, device="cpu")
        j_state, j_extra = jckpt.load_state(tmp_path / name)
        assert t_extra == j_extra == extra
        assert t_state.node_names == j_state.node_names
        assert t_state.pod_names == j_state.pod_names
        t_arr, j_arr = _arrays(t_state), _arrays(j_state)
        for f in tckpt._ARRAY_FIELDS:
            assert t_arr[f].dtype == j_arr[f].dtype, f
            np.testing.assert_array_equal(t_arr[f], j_arr[f], err_msg=f)
    with np.load(tmp_path / "from_torch.npz") as a, np.load(tmp_path / "from_jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]), f


def test_manager_keeps_the_newest_and_skips_torn_files(tmp_path):
    tb = t_make("mubench", 0, device="cpu")
    mgr = tckpt.CheckpointManager(tmp_path, keep=2)
    for r in (1, 2, 3):
        mgr.save(r, tb.monitor(), extra={"x": r})
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == ["round_000002.npz",
                                                           "round_000003.npz"]
    (tmp_path / "round_000003.npz").write_bytes(b"torn")
    r, _, extra = mgr.latest(device="cpu")
    assert (r, extra) == (2, {"round": 2, "x": 2})
    assert jckpt.CheckpointManager(tmp_path).latest()[0] == 2


def test_manager_raises_a_device_failure_instead_of_falling_back(tmp_path, monkeypatch):
    """Only an unreadable file falls back a round: a checkpoint that reads
    but cannot be placed on the device raises, so a resume never silently
    restarts from an older round."""
    mgr = tckpt.CheckpointManager(tmp_path)
    for r in (1, 2):
        mgr.save(r, t_make("mubench", 0, device="cpu").monitor())

    def out_of_memory(*_):
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(tckpt, "_upload", out_of_memory)
    with pytest.raises(RuntimeError, match="out of memory"):
        mgr.latest(device="cpu")


def _runner(algorithm):
    """(make the pair of backends, config kwargs, port run keywords)."""
    seed = 1 if algorithm == "communication" else 2

    def backends():
        jb, tb = j_make("mubench", seed), t_make("mubench", seed, device="cpu")
        jb.inject_imbalance("worker1")
        tb.inject_imbalance("worker1")
        return jb, tb

    kw = dict(algorithm=algorithm, sleep_after_action_s=0.0, seed=seed, moves_per_round=2,
              balance_weight=0.5 if algorithm == "global" else 0.0)
    if algorithm == "global":
        seam = {"solver_plans": _global_plans(backends()[1], seed, 9, "dense")[0]}
    else:
        seam = {"gumbel_rows": jax_greedy_gumbel(seed, 3)}
    return backends, kw, seam


@pytest.mark.parametrize("algorithm", ["communication", "global"])
def test_resume_equals_an_uninterrupted_run(algorithm, tmp_path):
    """3 rounds into a checkpoint directory, then a resume to 6 on a fresh
    backend: rounds 4–6 equal those of an uninterrupted 6-round run, in
    the port and in the JAX package."""
    backends, kw, seam = _runner(algorithm)
    jb, tb = backends()
    j_full = j_run(jb, JConfig(max_rounds=6, **kw), registry=JRegistry())
    t_full = t_run(tb, TConfig(max_rounds=6, **kw), device="cpu", registry=TRegistry(), **seam)
    assert_same_records(t_full, j_full)

    _, tb = backends()
    t_run(tb, TConfig(max_rounds=3, **kw), device="cpu", registry=TRegistry(),
          checkpoint_dir=str(tmp_path), **seam)
    _, fresh = backends()
    resumed = t_run(fresh, TConfig(max_rounds=6, **kw), device="cpu", registry=TRegistry(),
                    checkpoint_dir=str(tmp_path), **seam)
    assert resumed.resumed_from_round == 4
    assert [r.round for r in resumed.rounds] == [4, 5, 6]
    t_full.rounds = t_full.rounds[3:]
    j_full.rounds = j_full.rounds[3:]
    assert_same_records(resumed, j_full)
    assert_same_records(resumed, t_full)


def test_resume_across_packages(tmp_path):
    """The JAX package checkpoints 3 global rounds; the port resumes them
    to 6 and decides as the uninterrupted JAX run; and the reverse."""
    backends, kw, seam = _runner("global")
    jb, _ = backends()
    j_full = j_run(jb, JConfig(max_rounds=6, **kw), registry=JRegistry())
    jb, _ = backends()
    j_run(jb, JConfig(max_rounds=3, **kw), registry=JRegistry(),
          checkpoint_dir=str(tmp_path / "a"))
    _, tb = backends()
    t_resumed = t_run(tb, TConfig(max_rounds=6, **kw), device="cpu", registry=TRegistry(),
                      checkpoint_dir=str(tmp_path / "a"), **seam)
    _, tb = backends()
    t_run(tb, TConfig(max_rounds=3, **kw), device="cpu", registry=TRegistry(),
          checkpoint_dir=str(tmp_path / "b"), **seam)
    jb, _ = backends()
    j_resumed = j_run(jb, JConfig(max_rounds=6, **kw), registry=JRegistry(),
                      checkpoint_dir=str(tmp_path / "b"))
    assert t_resumed.resumed_from_round == j_resumed.resumed_from_round == 4
    j_full.rounds = j_full.rounds[3:]
    assert_same_records(t_resumed, j_full)
    assert_same_records(t_resumed, j_resumed)
    meta = json.loads((tmp_path / "b" / "round_000003.json").read_text())
    assert meta["extra"]["algorithm"] == "global" and meta["extra"]["round"] == 3
    assert set(meta["extra"]["reconcile"]) == {"intent", "pod_service", "pending_events"}


def test_logger_events_match_jax(tmp_path):
    """One ``round`` event per round with the JAX event's fields, written
    to the file and kept in the ring (newest ``max_records``)."""
    logs = []
    for pkg in ("jax", "torch"):
        path = tmp_path / f"{pkg}.jsonl"
        if pkg == "jax":
            b = j_make("mubench", 1)
            b.inject_imbalance("worker1")
            log = JLogger(path=path, max_records=2)
            j_run(b, JConfig(max_rounds=3, sleep_after_action_s=0.0, seed=1),
                  registry=JRegistry(), logger=log)
        else:
            b = t_make("mubench", 1, device="cpu")
            b.inject_imbalance("worker1")
            log = TLogger(path=path, max_records=2)
            t_run(b, TConfig(max_rounds=3, sleep_after_action_s=0.0, seed=1),
                  device="cpu", registry=TRegistry(), logger=log)
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        assert len(log.records) == 2 and log.records == lines[-2:]
        logs.append([{k: v for k, v in e.items() if k not in ("ts", "decision_latency_s")}
                     for e in lines])
    assert logs[0] == logs[1]
    assert [e["event"] for e in logs[1]].count("round") == 3
    assert get_logger("port-test") is get_logger("port-test")
    quiet = TLogger(level="warn")
    quiet.info("round")
    quiet.warn("x", a=1)
    assert [r["event"] for r in quiet.records] == ["x"]


@pytest.mark.parametrize("algorithm", ["communication", "global"])
def test_decision_graph_and_on_round_match_jax(algorithm):
    """``graph=`` (here the µBench graph with a third of its relations
    dropped, given as a graph and as a callable re-read every round) drives
    the decisions while the records' costs stay on the backend's declared
    graph; ``on_round`` sees every record and its post-move snapshot."""
    from test_torch_state import assert_state_equal

    from kubernetes_rescheduling_tpu.core.state import CommGraph as JGraph
    from kubernetes_rescheduling_tpu_torch.core.state import CommGraph as TGraph

    backends, kw, seam = _runner(algorithm)
    jb, tb = backends()
    rel = tb.comm_graph().to_relation()
    names = list(tb.comm_graph().names)
    thin = {s: [t for t in ts if (names.index(s) + names.index(t)) % 3] for s, ts in rel.items()}
    j_graph = JGraph.from_relation(thin, names=names)
    t_graph = TGraph.from_relation(thin, names=names, device="cpu")
    seen = {"jax": [], "torch": []}
    reads = []

    def t_src():
        reads.append(1)
        return t_graph

    j = j_run(jb, JConfig(max_rounds=3, **kw), registry=JRegistry(), graph=j_graph,
              on_round=lambda r, s: seen["jax"].append((r.round, s)))
    if algorithm == "global":
        plans, _ = _global_plans(tb, kw["seed"], 9, "dense")
        seam = {"solver_plans": plans}
    t = t_run(tb, TConfig(max_rounds=3, **kw), device="cpu", registry=TRegistry(),
              graph=t_src, on_round=lambda r, s: seen["torch"].append((r.round, s)), **seam)
    assert_same_records(t, j)
    assert len(reads) == 3
    assert [r for r, _ in seen["torch"]] == [r for r, _ in seen["jax"]] == [1, 2, 3]
    for (_, ts), (_, js) in zip(seen["torch"], seen["jax"]):
        assert_state_equal(ts, js)
    # the decisions saw the thinned graph: the same run on the declared one
    # decides differently
    _, tb2 = backends()
    declared = t_run(tb2, TConfig(max_rounds=3, **kw), device="cpu", registry=TRegistry(),
                     **seam)
    assert [r.applied_moves for r in declared.rounds] != [r.applied_moves for r in t.rounds]
