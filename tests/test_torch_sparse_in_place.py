"""The sparse solver's plain chunk step read in place: kernel 6 taking its
slabs and rows through the chunk's block table
(``ops.sparse_mass.sparse_mass_score_in_place``) and kernel 3 committing the
assignment, the carried loads and the move count
(``ops.fused_admission.admission_commit``), against the gathered
composition they replace: ``chunk_local_slabs``, the row gathers,
``sparse_mass_score``, ``admission_stage`` and the commit in torch.

On the CPU the wrappers run their plain twins (the gathers, then the
gathered plain versions), so the solver's kernel lowering (``"on"``) runs
the new step there; every comparison is ``torch.equal``. On the card
(marked ``card``; they skip without a CUDA device) each kernel mode is held
to its plain twin and to the gathered kernels, and one plain chunk step is
exactly two kernel launches. This file imports no JAX, so it runs where the
card is: ``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_sparse_in_place.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu_torch.core import sparsegraph as tsg
from kubernetes_rescheduling_tpu_torch.core import topology as ttopo
from kubernetes_rescheduling_tpu_torch.ops import fused_admission as fa
from kubernetes_rescheduling_tpu_torch.ops import sparse_mass as sm
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs
from kubernetes_rescheduling_tpu_torch.solver import sparse_solver as tss

CFG = tgs.GlobalSolverConfig(sweeps=4, swap_every=0, chunk_size=512, fused_epilogue="on")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the in-place kernel modes run only on the card")
    return torch.device("cuda")


def instance(device="cpu"):
    """650 two-replica services (1,300 pods) of a power-law mesh on 12
    nodes, 256-row blocks with 1,024 regular columns: three regular blocks and
    one dummy block in two chunks of two blocks, every regular strip padded
    (``u_ids >= sp``)."""
    scn = ttopo.synthetic_scenario(n_pods=1300, n_nodes=12, powerlaw=True, seed=3, replicas=2,
                                   device=device)
    return scn.state, tsg.from_comm_graph(scn.graph, bu=128, reg_tiles=8, device=device)


def chunk_operands(state, sgraph, *, dummy: bool, move_cost: float, seed: int = 0):
    """The solver's operands for one chunk step: its block table (with or
    without the dummy block), the sorted-space arrays at a random
    placement, its loads, and the node tables."""
    cfg = dataclasses.replace(CFG, move_cost=move_cost)
    lay = tss.sparse_layout(sgraph, cfg)
    N = state.num_nodes
    dev = state.device
    svc_valid, svc_cpu, svc_mem, cur_s, rv_s, rvu = tss.sorted_problem_arrays(
        state, sgraph, lay.spx)
    gen = torch.Generator().manual_seed(seed)
    assign = torch.where(svc_valid, torch.randint(0, N, (lay.spx,), generator=gen).to(dev), 0)
    assign = assign.to(torch.int32)
    toff, reg = tss.extended_block_tables(sgraph, lay, dev)
    dummy_id = sgraph.num_blocks
    slots = [dummy_id, sgraph.regular_blocks[1]] if dummy else list(sgraph.regular_blocks[:2])
    blocks = torch.tensor(slots, dtype=torch.int32, device=dev)
    a = torch.where(svc_valid, assign, N).long()
    z = torch.zeros((N + 1,), device=dev)
    cpu_cap = torch.where(state.node_valid, state.node_cpu_cap, 0.0)
    mem_cap = torch.where(state.node_valid, state.node_mem_cap, 0.0)
    home = torch.where(svc_valid, torch.clamp(cur_s, 0, N - 1), 0).to(torch.int32)
    return dict(
        lay=lay, blocks=blocks, toff=toff, assign=assign, svc_valid=svc_valid, svc_cpu=svc_cpu,
        svc_mem=svc_mem, rv_s=rv_s, rvu=rvu, w_mm=sgraph.w_local.to(torch.bfloat16),
        home=home if move_cost > 0 else None,
        pen=move_cost * rv_s if move_cost > 0 else None,
        cpu_load=state.node_base_cpu + z.index_put((a,), svc_cpu, accumulate=True)[:N],
        mem_load=state.node_base_mem + z.index_put((a,), svc_mem, accumulate=True)[:N],
        cap=torch.where(cpu_cap > 0, cpu_cap, 1.0) * cfg.capacity_frac,
        mem_cap=torch.where(mem_cap > 0, mem_cap, float("inf")) * cfg.capacity_frac,
        node_valid=state.node_valid,
    )


def gathered_mass_score(w_mm, u_ids, rvu, assign, blocks, toff, rv_s, home, move_pen, svc_cpu,
                        svc_mem, svc_valid, *rest, num_nodes, bu, reg_tiles, enforce_capacity,
                        use_noise):
    """The gathered composition of the first launch, as the solver made it
    before the in-place step: the chunk's slabs and rows gathered in torch,
    then ``sparse_mass_score``."""
    ids = fa.block_row_ids(blocks)
    u_c, rvu_c = sm.chunk_local_slabs(u_ids, rvu, toff[blocks.long()].long() * bu,
                                      reg_tiles * bu)
    tgt_c = assign[torch.clamp(u_c.long(), 0, assign.shape[0] - 1)]
    cur = assign[ids]
    return sm.sparse_mass_score(
        w_mm, tgt_c, rvu_c, blocks, toff, rv_s[ids], cur, cur if home is None else home[ids],
        None if move_pen is None else move_pen[ids], svc_cpu[ids], svc_mem[ids],
        svc_valid[ids], *rest, num_nodes=num_nodes, bu=bu, reg_tiles=reg_tiles,
        enforce_capacity=enforce_capacity, use_noise=use_noise)


def gathered_commit(prop, gain, wants, slack_cpu, slack_mem, blocks, assign, svc_valid, svc_cpu,
                    svc_mem, cpu_load, mem_load, moves, *, num_nodes, enforce_capacity):
    """The gathered composition of the second launch: ``admission_stage``
    on the gathered rows, then ``assign[ids] = new_node``, ``load + d`` and
    ``moves + admitted.sum()`` in torch (written back into the caller's
    tensors)."""
    ids = fa.block_row_ids(blocks)
    new_node, admitted, d_cpu, d_mem = fa.admission_stage(
        prop, gain, wants, slack_cpu, slack_mem, assign[ids], svc_valid[ids], svc_cpu[ids],
        svc_mem[ids], num_nodes=num_nodes, enforce_capacity=enforce_capacity,
        emit_x_rows=False)
    assign[ids] = new_node
    cpu_load.copy_(cpu_load + d_cpu)
    mem_load.copy_(mem_load + d_mem)
    moves.copy_(moves + admitted.sum())


def step_args(op, sgraph, use_noise: bool):
    N = op["cpu_load"].shape[0]
    dev = op["assign"].device
    temp = torch.tensor(1.0 if use_noise else 0.0, device=dev)
    seed = torch.tensor(123457, dtype=torch.int32, device=dev)
    args = (op["w_mm"], sgraph.u_ids, op["rvu"], op["assign"], op["blocks"], op["toff"],
            op["rv_s"], op["home"], op["pen"], op["svc_cpu"], op["svc_mem"], op["svc_valid"],
            op["cpu_load"], op["mem_load"], op["cap"], op["mem_cap"], op["node_valid"], 0.5,
            temp, seed, 10.0)
    return args, dict(num_nodes=N, bu=sgraph.bu, reg_tiles=sgraph.reg_tiles,
                      use_noise=use_noise)


def run_step(mass_score, commit, op, sgraph, *, use_noise, enforce_capacity):
    """One chunk step on copies of the carried state: returns the score
    outputs, the assignment, the loads and the move count after it."""
    op = dict(op, assign=op["assign"].clone(), cpu_load=op["cpu_load"].clone(),
              mem_load=op["mem_load"].clone())
    args, kw = step_args(op, sgraph, use_noise)
    scored = mass_score(*args, enforce_capacity=enforce_capacity, **kw)
    moves = torch.zeros((), dtype=torch.int64, device=op["assign"].device)
    commit(*scored, op["blocks"], op["assign"], op["svc_valid"], op["svc_cpu"], op["svc_mem"],
           op["cpu_load"], op["mem_load"], moves, num_nodes=kw["num_nodes"],
           enforce_capacity=enforce_capacity)
    return (*scored, op["assign"], op["cpu_load"], op["mem_load"], moves)


OUTPUTS = ("prop", "gain", "wants", "slack_cpu", "slack_mem", "assign", "cpu_load", "mem_load",
           "moves")


def assert_equal_steps(got, want):
    for name, g, w in zip(OUTPUTS, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.fixture(scope="module")
def small():
    return instance()


@pytest.mark.parametrize("enforce_capacity", [True, False])
@pytest.mark.parametrize("use_noise", [False, True])
@pytest.mark.parametrize("move_cost", [0.0, 0.6])
@pytest.mark.parametrize("dummy", [False, True])
def test_in_place_step_equals_the_gathered_composition(small, dummy, move_cost, use_noise,
                                                      enforce_capacity):
    state, sgraph = small
    op = chunk_operands(state, sgraph, dummy=dummy, move_cost=move_cost)
    lay = op["lay"]
    assert lay.n_dummy >= 1 and not lay.hub_groups
    starts = op["toff"][op["blocks"].long()].long() * sgraph.bu
    u_c, _ = sm.chunk_local_slabs(sgraph.u_ids, op["rvu"], starts, sgraph.u_reg)
    assert bool((u_c >= sgraph.sp).any())  # padding columns in the chunk's strips
    assert bool((op["blocks"] >= sgraph.num_blocks).any()) == dummy
    kw = dict(use_noise=use_noise, enforce_capacity=enforce_capacity)
    got = run_step(sm.sparse_mass_score_in_place, fa.admission_commit, op, sgraph, **kw)
    want = run_step(gathered_mass_score, gathered_commit, op, sgraph, **kw)
    assert_equal_steps(got, want)
    assert int(got[-1]) > 0
    assert not torch.equal(got[5], op["assign"])


def test_the_wrappers_refuse_what_the_kernels_cannot_take(small):
    state, sgraph = small
    op = chunk_operands(state, sgraph, dummy=False, move_cost=0.6)
    args, kw = step_args(op, sgraph, use_noise=False)
    with pytest.raises(ValueError, match="together"):
        sm.sparse_mass_score_in_place(*args[:8], None, *args[9:], enforce_capacity=True, **kw)
    with pytest.raises(ValueError, match="service arrays"):
        sm.sparse_mass_score_in_place(*args[:6], args[6][:-1], *args[7:], enforce_capacity=True,
                                      **kw)
    scored = sm.sparse_mass_score_in_place(*args, enforce_capacity=True, **kw)
    moves = torch.zeros((), dtype=torch.int64)
    with pytest.raises(ValueError, match="node loads"):
        fa.admission_commit(*scored, op["blocks"], op["assign"], op["svc_valid"],
                            op["svc_cpu"], op["svc_mem"], op["cpu_load"][:-1], op["mem_load"],
                            moves, num_nodes=kw["num_nodes"], enforce_capacity=True)


class Recorder:
    """Stands in for the solver's two in-place wrappers: runs ``mass_score``
    and ``commit`` and keeps the assignment and the carried loads after
    every chunk step."""

    def __init__(self, mass_score, commit):
        self.mass_score, self.commit, self.after = mass_score, commit, []

    def install(self, monkeypatch):
        monkeypatch.setattr(tss, "sparse_mass_score_in_place", self.mass_score)
        monkeypatch.setattr(tss, "admission_commit", self.record)

    def record(self, *args, **kw):
        self.commit(*args, **kw)
        assign, cpu_load, mem_load, moves = args[6], args[10], args[11], args[12]
        self.after.append(tuple(t.clone() for t in (assign, cpu_load, mem_load, moves)))


def solve_with(monkeypatch, recorder, state, sgraph, cfg, seed=2):
    with monkeypatch.context() as m:
        recorder.install(m)
        return tss.global_assign_sparse(state, sgraph, torch.Generator().manual_seed(seed), cfg)


def assert_same_solves(a, b):
    (sa, ia), (sb, ib) = a, b
    assert torch.equal(sa.pod_node, sb.pod_node)
    for k in ("objective_before", "objective_after", "moves_per_sweep", "swaps_per_sweep",
              "communication_cost", "move_penalty"):
        assert torch.equal(ia[k], ib[k]), k


@pytest.mark.parametrize("enforce_capacity", [True, False])
@pytest.mark.parametrize("noise_temp", [0.0, 1.0])
@pytest.mark.parametrize("move_cost", [0.0, 0.6])
def test_solve_in_place_equals_the_gathered_step(small, monkeypatch, move_cost, noise_temp,
                                                 enforce_capacity):
    """The kernel lowering's solve with the in-place step (the wrappers'
    plain twins here) against the same solve with the gathered step: the
    same placement, objectives, moves per sweep, and the same carried loads
    and assignment after every chunk step."""
    state, sgraph = small
    cfg = dataclasses.replace(CFG, move_cost=move_cost, noise_temp=noise_temp,
                              enforce_capacity=enforce_capacity)
    new = Recorder(sm.sparse_mass_score_in_place, fa.admission_commit)
    old = Recorder(gathered_mass_score, gathered_commit)
    got, want = (solve_with(monkeypatch, r, state, sgraph, cfg) for r in (new, old))
    assert_same_solves(got, want)
    lay = tss.sparse_layout(sgraph, cfg)
    assert len(new.after) == len(old.after) == lay.n_chunks * cfg.sweeps
    for g, w in zip(new.after, old.after):
        for name, x, y in zip(("assign", "cpu_load", "mem_load", "moves"), g, w):
            assert torch.equal(x, y), name
    assert int(got[1]["moves_per_sweep"].sum()) > 0
    assert float(got[1]["objective_after"]) < float(got[1]["objective_before"])


def test_hub_pass_and_swap_sweeps_compose_with_the_in_place_step(monkeypatch):
    """A graph with a hub group (a 300-arm star) solved with swap sweeps:
    the hub pass and the swap sweeps keep the gathered path, the plain
    sweeps take the in-place step, and the solve equals the one whose plain
    sweeps take the gathered step."""
    S = 1536
    rng = np.random.default_rng(10)
    E = int(S * 3.0 / 2)
    src = np.concatenate([np.zeros(300, np.int64), rng.integers(0, S, size=E)])
    dst = np.concatenate([np.arange(1, 301, dtype=np.int64), rng.integers(0, S, size=E)])
    sgraph = tsg.from_edges(src, dst, np.ones(len(src)), S, bu=128, reg_tiles=8, device="cpu")
    state = ttopo.synthetic_scenario(n_pods=S, n_nodes=16, seed=6, device="cpu").state
    cfg = dataclasses.replace(CFG, sweeps=5, swap_every=2, noise_temp=1.0, balance_weight=0.5)
    lay = tss.sparse_layout(sgraph, cfg)
    assert lay.hub_groups and lay.n_chunks >= 2
    new = Recorder(sm.sparse_mass_score_in_place, fa.admission_commit)
    old = Recorder(gathered_mass_score, gathered_commit)
    got, want = (solve_with(monkeypatch, r, state, sgraph, cfg, seed=4) for r in (new, old))
    assert_same_solves(got, want)
    assert len(new.after) == lay.n_chunks * 3  # the plain sweeps: 1, 3 and 5
    assert int(got[1]["swaps_per_sweep"].sum()) >= 0
    assert float(got[1]["objective_after"]) < float(got[1]["objective_before"])


# ------------------------------------------------------------------ the card


@pytest.mark.card
@pytest.mark.parametrize("enforce_capacity", [True, False])
@pytest.mark.parametrize("move_cost", [0.0, 0.6])
@pytest.mark.parametrize("use_noise", [False, True])
def test_kernel_modes_equal_their_plain_twins_on_the_card(card, use_noise, move_cost,
                                                         enforce_capacity):
    state, sgraph = instance(card)
    kw = dict(use_noise=use_noise, enforce_capacity=enforce_capacity)
    for dummy in (False, True):
        op = chunk_operands(state, sgraph, dummy=dummy, move_cost=move_cost, seed=1)
        got = run_step(sm.sparse_mass_score_in_place, fa.admission_commit, op, sgraph, **kw)
        plain = run_step(sm.sparse_mass_score_in_place_plain, fa.admission_commit_plain, op,
                         sgraph, **kw)
        gathered = run_step(gathered_mass_score, gathered_commit, op, sgraph, **kw)
        torch.cuda.synchronize()
        assert_equal_steps(got, plain)
        assert_equal_steps(got, gathered)
        assert int(got[-1]) > 0


@pytest.mark.card
def test_a_plain_chunk_step_is_two_launches_on_the_card(card):
    state, sgraph = instance(card)
    op = chunk_operands(state, sgraph, dummy=True, move_cost=0.6, seed=1)
    run_step(sm.sparse_mass_score_in_place, fa.admission_commit, op, sgraph, use_noise=True,
             enforce_capacity=True)  # builds and loads both libraries
    torch.cuda.synchronize()
    args, kw = step_args(op, sgraph, use_noise=True)
    moves = torch.zeros((), dtype=torch.int64, device=card)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        scored = sm.sparse_mass_score_in_place(*args, enforce_capacity=True, **kw)
        fa.admission_commit(*scored, op["blocks"], op["assign"], op["svc_valid"],
                            op["svc_cpu"], op["svc_mem"], op["cpu_load"], op["mem_load"], moves,
                            num_nodes=kw["num_nodes"], enforce_capacity=True)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 2, kernels
    assert "mass_score_kernel" in kernels[0] and "admission_kernel" in kernels[1], kernels


@pytest.mark.card
@pytest.mark.parametrize("move_cost", [0.0, 0.6])
def test_solve_on_the_card_equals_the_gathered_step(card, monkeypatch, move_cost):
    state, sgraph = instance(card)
    cfg = dataclasses.replace(CFG, move_cost=move_cost, noise_temp=1.0, fused_epilogue="auto")
    from kubernetes_rescheduling_tpu_torch.solver import compiled

    with compiled.eager():
        got, want = (solve_with(monkeypatch, Recorder(*fns), state, sgraph, cfg) for fns in (
            (sm.sparse_mass_score_in_place, fa.admission_commit),
            (gathered_mass_score, gathered_commit)))
    captured = tss.global_assign_sparse(state, sgraph, torch.Generator().manual_seed(2), cfg)
    assert_same_solves(got, want)
    assert_same_solves(captured, want)
