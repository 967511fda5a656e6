"""The port's chunk-step kernels, through their plain versions on the CPU,
against the JAX package's Pallas kernels in interpret mode and its XLA twin.

The same seeded numpy inputs go to both packages. Decisions (``new_node``,
``admitted``, ``x_rows``), the noise mixer and the neighbor mass must be
EXACTLY equal; the per-node load deltas agree to atol 1e-4, as in the JAX
package's own test (tests/test_ops.py), because f32 sums of non-integer
loads may associate differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu.ops import fused_admission as jfa
from kubernetes_rescheduling_tpu_torch import ops
from kubernetes_rescheduling_tpu_torch.ops import fused_admission as tfa
from kubernetes_rescheduling_tpu_torch.ops import sparse_mass as sm


def random_instance(seed, C=64, N=128, tight=False):
    """The JAX package's ``tests/test_ops.py`` instance, as numpy arrays."""
    rng = np.random.default_rng(seed)
    M = rng.integers(0, 6, size=(C, N)).astype(np.float32)  # frequent exact ties
    cur = rng.integers(0, N, size=C).astype(np.int32)
    c_cpu = (rng.integers(1, 5, size=C) * 100.0).astype(np.float32)
    c_mem = (rng.integers(0, 3, size=C) * 1e6).astype(np.float32)
    valid_c = rng.random(C) < 0.9
    cap_val = 2_000.0 if tight else 50_000.0
    cap = np.full((N,), cap_val, np.float32)
    cpu_load = rng.uniform(0, cap_val * 0.8, N).astype(np.float32)
    mem_cap = np.full((N,), 1e9, np.float32)
    mem_load = rng.uniform(0, 1e8, N).astype(np.float32)
    node_valid = rng.random(N) < 0.95
    return [M, cur, c_cpu, c_mem, valid_c, cpu_load, mem_load, cap, mem_cap, node_valid]


def as_jax(args):
    return [jnp.asarray(a) for a in args]


def as_torch(args):
    return [torch.as_tensor(a) for a in args]


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("tight", [False, True])
# block_c=48 does not divide C=64: the last tile is partial
@pytest.mark.parametrize("block_c", [32, 48])
def test_score_admission_matches_jax(seed, tight, block_c):
    args = random_instance(seed, tight=tight)
    j_node, j_adm, j_rows, j_dc, j_dm = jfa.fused_score_admission(
        *as_jax(args), 0.5, 0.0, seed, interpret=True, block_c=block_c,
        enforce_capacity=True, use_noise=False,
    )
    t_node, t_adm, t_rows, t_dc, t_dm = tfa.fused_score_admission(
        *as_torch(args), 0.5, 0.0, seed, block_c=block_c,
        enforce_capacity=True, use_noise=False,
    )
    np.testing.assert_array_equal(t_node.numpy(), np.asarray(j_node))
    np.testing.assert_array_equal(t_adm.numpy(), np.asarray(j_adm))
    np.testing.assert_array_equal(t_rows.float().numpy(), np.asarray(j_rows, np.float32))
    np.testing.assert_allclose(t_dc.numpy(), np.asarray(j_dc), atol=1e-4)
    np.testing.assert_allclose(t_dm.numpy(), np.asarray(j_dm), atol=1e-4)
    # and both plain twins agree with the fused lowering
    r_node, r_adm = tfa.reference_score_admission(*as_torch(args), 0.5, None,
                                                  enforce_capacity=True)
    jr_node, jr_adm = jfa.reference_score_admission(*as_jax(args), 0.5, None,
                                                    enforce_capacity=True)
    np.testing.assert_array_equal(r_node.numpy(), np.asarray(jr_node))
    np.testing.assert_array_equal(r_adm.numpy(), np.asarray(jr_adm))
    np.testing.assert_array_equal(r_node.numpy(), t_node.numpy())


@pytest.mark.parametrize("seed", range(4))
def test_overload_term_matches_jax(seed):
    """Loads pushed past capacity so the over-budget relu term is live."""
    args = random_instance(seed, tight=True)
    args[5] = args[5] * np.float32(1.6)
    j_node, j_adm, *_ = jfa.fused_score_admission(
        *as_jax(args), 0.5, 0.0, seed, overload_weight=10.0,
        interpret=True, block_c=32, enforce_capacity=True, use_noise=False,
    )
    t_node, t_adm, *_ = tfa.fused_score_admission(
        *as_torch(args), 0.5, 0.0, seed, overload_weight=10.0, block_c=32,
        enforce_capacity=True, use_noise=False,
    )
    np.testing.assert_array_equal(t_node.numpy(), np.asarray(j_node))
    np.testing.assert_array_equal(t_adm.numpy(), np.asarray(j_adm))


def test_no_capacity_mode_matches_jax():
    args = random_instance(3)
    j_node, j_adm, *_ = jfa.fused_score_admission(
        *as_jax(args), 0.0, 0.0, 3, enforce_capacity=False, use_noise=False,
        interpret=True, block_c=32,
    )
    t_node, t_adm, *_ = tfa.fused_score_admission(
        *as_torch(args), 0.0, 0.0, 3, enforce_capacity=False, use_noise=False, block_c=32,
    )
    np.testing.assert_array_equal(t_node.numpy(), np.asarray(j_node))
    np.testing.assert_array_equal(t_adm.numpy(), np.asarray(j_adm))


@pytest.mark.parametrize("seed", range(3))
def test_move_pen_matches_jax(seed):
    """Disruption pricing: the penalty is charged at every node but home."""
    args = random_instance(seed, tight=True)
    rng = np.random.default_rng(100 + seed)
    C, N = args[0].shape
    home = rng.integers(0, N, size=C).astype(np.int32)
    pen = rng.integers(0, 4, size=C).astype(np.float32)
    j_node, j_adm, j_dc, j_dm = jfa.fused_score_admission(
        *as_jax(args), 0.5, 0.0, seed, overload_weight=10.0,
        home=jnp.asarray(home), move_pen=jnp.asarray(pen), interpret=True, block_c=32,
        enforce_capacity=True, use_noise=False, emit_x_rows=False,
    )
    t_node, t_adm, t_dc, t_dm = tfa.fused_score_admission(
        *as_torch(args), 0.5, 0.0, seed, overload_weight=10.0,
        home=torch.as_tensor(home), move_pen=torch.as_tensor(pen), block_c=32,
        enforce_capacity=True, use_noise=False, emit_x_rows=False,
    )
    np.testing.assert_array_equal(t_node.numpy(), np.asarray(j_node))
    np.testing.assert_array_equal(t_adm.numpy(), np.asarray(j_adm))
    np.testing.assert_allclose(t_dc.numpy(), np.asarray(j_dc), atol=1e-4)
    np.testing.assert_allclose(t_dm.numpy(), np.asarray(j_dm), atol=1e-4)
    r_node, r_adm = tfa.reference_score_admission(
        *as_torch(args), 0.5, None, overload_weight=10.0, home=torch.as_tensor(home),
        move_pen=torch.as_tensor(pen), enforce_capacity=True,
    )
    np.testing.assert_array_equal(r_node.numpy(), t_node.numpy())
    np.testing.assert_array_equal(r_adm.numpy(), t_adm.numpy())


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 2, -5, 123456789])
def test_mixer_bit_exact(seed):
    want = np.asarray(jfa._stateless_uniform(jnp.int32(seed), (37, 50)))
    got = tfa._stateless_uniform(seed, (37, 50)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() > 0.0 and got.max() < 1.0


@pytest.mark.parametrize("block_c", [32, 64])
def test_stateless_noise_decisions_match_jax(block_c):
    """Noise on: the seed law (tile t uses seed + t, the mixer's row is the
    row within the tile) gives JAX's decisions exactly."""
    for seed in (11, 12):
        args = random_instance(seed, tight=True)
        j_node, j_adm, *_ = jfa.fused_score_admission(
            *as_jax(args), 0.5, 0.7, seed, interpret=True, block_c=block_c,
            enforce_capacity=True, use_noise=True, noise_impl="stateless",
        )
        t_node, t_adm, *_ = tfa.fused_score_admission(
            *as_torch(args), 0.5, 0.7, seed, block_c=block_c,
            enforce_capacity=True, use_noise=True,
        )
        np.testing.assert_array_equal(t_node.numpy(), np.asarray(j_node))
        np.testing.assert_array_equal(t_adm.numpy(), np.asarray(j_adm))


def test_admission_capacity_race():
    """Two proposals race for one nearly-full node: only the higher-gain one
    lands; the other stays put."""
    C, N = 8, 128
    M = torch.zeros((C, N))
    M[0, 5], M[1, 5] = 10.0, 20.0
    cur = torch.tensor([1, 2] + [0] * (C - 2), dtype=torch.int32)
    valid_c = torch.tensor([True, True] + [False] * (C - 2))
    cpu_load = torch.zeros(N)
    cpu_load[5] = 500.0
    new_node, admitted, *_ = tfa.fused_score_admission(
        M, cur, torch.full((C,), 300.0), torch.zeros(C), valid_c, cpu_load, torch.zeros(N),
        torch.full((N,), 1000.0), torch.full((N,), 1e9), torch.ones(N, dtype=torch.bool),
        0.0, 0.0, 0, enforce_capacity=True, use_noise=False, block_c=8,
    )
    assert bool(admitted[1]) and int(new_node[1]) == 5
    assert not bool(admitted[0]) and int(new_node[0]) == 1


def test_neighbor_mass_matches_jax():
    """W row-blocks gathered by id times the one-hot occupancy, exactly."""
    rng = np.random.default_rng(0)
    SP, N, B = 128, 64, 16
    W = rng.integers(0, 5, size=(SP, SP)).astype(np.float32)
    assign = rng.integers(0, N, size=SP).astype(np.int32)
    valid = rng.random(SP) < 0.9
    W_j = jnp.asarray(W).astype(jnp.bfloat16)
    W_t = torch.as_tensor(W).to(torch.bfloat16)
    for blocks in ([0, 1], [7, 2], [3, 0, 5, 6]):
        b = np.asarray(blocks, np.int32)
        want = jfa.fused_neighbor_mass(
            W_j, jnp.asarray(assign), jnp.asarray(valid), jnp.asarray(b),
            num_nodes=N, block_b=B, block_j=32, interpret=True,
        )
        got = tfa.fused_neighbor_mass(
            W_t, torch.as_tensor(assign), torch.as_tensor(valid), torch.as_tensor(b),
            num_nodes=N, block_b=B, block_j=32,
        )
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_neighbor_mass_rejects_ragged_tiling():
    W = torch.zeros((100, 100), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="divisible"):
        tfa.fused_neighbor_mass(
            W, torch.zeros(100, dtype=torch.int32), torch.ones(100, dtype=torch.bool),
            torch.zeros(1, dtype=torch.int32), num_nodes=4, block_b=16, block_j=32,
        )


def test_wrappers_count_only_kernel_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    ops.reset_launch_counts()
    args = random_instance(1)
    tfa.fused_score_admission(*as_torch(args), 0.5, 0.0, 1, enforce_capacity=True,
                              use_noise=False)
    assert ops.launch_counts() == {
        "fused_neighbor_mass": 0, "score_stage": 0, "admission_stage": 0,
        "sparse_neighbor_mass": 0, "hub_neighbor_mass": 0, "sparse_mass_score": 0,
    }


def test_wrappers_refuse_other_devices():
    """A wrapper takes the plain version only for CPU tensors; mixed or
    other devices raise instead of falling back."""
    args = as_torch(random_instance(2))
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError):
        tfa.fused_score_admission(*args, 0.5, 0.0, 2, enforce_capacity=True, use_noise=False)


def crowded_admission(seed=0, C=1024, N=2000):
    """Score-stage outputs at the sparse round's chunk shape where about a
    third of the rows race for one target with few distinct gains (many
    exact ties), integer loads, and node room for only some of them."""
    rng = np.random.default_rng(seed)
    prop = rng.integers(0, N, size=C).astype(np.int32)
    prop[rng.random(C) < 0.3] = 7
    gain = rng.integers(1, 4, size=C).astype(np.float32)
    cur = rng.integers(0, N, size=C).astype(np.int32)
    wants = ((rng.random(C) < 0.8) & (prop != cur)).astype(np.int32)
    c_cpu = (rng.integers(1, 5, size=C) * 100).astype(np.float32)
    c_mem = (rng.integers(0, 3, size=C) * 1e6).astype(np.float32)
    free = (rng.integers(0, 60, size=N) * 100).astype(np.float32)
    free[7] = 20_000.0
    slack_cpu = free[prop] - c_cpu
    slack_mem = np.float32(1e9) - c_mem
    valid = rng.random(C) < 0.95
    return prop, gain, wants, slack_cpu, slack_mem, cur, valid, c_cpu, c_mem


def test_admission_plain_matches_jax_on_a_crowded_target():
    """Hundreds of rows with tied gains race for one node at C = 1024,
    N = 2000: the plain version (which the kernel must equal on the card)
    gives the JAX kernel's decisions, rows and deltas exactly."""
    C, N = 1024, 2000
    args = crowded_admission(C=C, N=N)
    prop, gain, wants, slack_cpu, slack_mem, cur, valid, c_cpu, c_mem = args
    kw = dict(num_nodes=N, enforce_capacity=True, block_c=256, emit_x_rows=True)
    j_out = jfa.admission_stage(
        *(jnp.asarray(a.reshape(C, 1)) for a in (prop, gain, wants, slack_cpu, slack_mem)),
        *(jnp.asarray(a) for a in (cur, valid, c_cpu, c_mem)),
        interpret=True, x_dtype=jnp.float32, **kw,
    )
    t_out = tfa.admission_stage(*as_torch(args), x_dtype=torch.float32, **kw)
    for t, j in zip(t_out, j_out):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    new_node, admitted = t_out[0].numpy(), t_out[1].numpy()
    crowd = (prop == 7) & (wants != 0)
    assert admitted[crowd].any() and not admitted[crowd].all()  # the race decided
    assert (new_node[crowd & admitted] == 7).all()


@pytest.mark.parametrize("C", [
    1, 2, 3, 20, 24, 31, 32, 33, 200, 256, 1000, 1024, 1025, 2048, 4096, 5000, 5200,
    8192, 46_000, 50_000, 2**20,
])
def test_admission_geometry_is_a_legal_launch(C):
    """One CUDA block per chunk: at most 1024 threads, a power-of-two sort
    width covering every row, and the staged rows in shared memory where
    they fit (every chunk ``auto_chunk`` makes does), else a scratch."""
    threads, P, work, in_shared = tfa.admission_geometry(C)
    assert 32 <= threads <= 1024 and threads % 32 == 0
    assert P >= max(C, 32) and P & (P - 1) == 0 and threads == min(P, 1024)
    assert work >= 20 * P + 25 * C and work % 16 == 0
    assert in_shared == (work + tfa._ADMISSION_STATIC <= 227 * 1024)
    assert in_shared or C > 4000
    if C <= 1024:
        assert in_shared


def test_admission_geometry_covers_the_solvers_chunks():
    """Every chunk width either solver can produce, auto or explicit, gets
    a legal launch; sizes no config makes raise."""
    from kubernetes_rescheduling_tpu_torch.solver.global_solver import auto_chunk

    widths = set()
    for S in (1, 20, 200, 2560, 10_000, 50_000, 200_000):
        for chunk_size in (0, 1, 24, 256, 1000, 1024, 4096, 16_384):
            C = min(auto_chunk(S, chunk_size), S)
            widths |= {C, max(1, C // 256) * 256}  # dense chunk; sparse KB·256
    for C in sorted(widths):
        threads, P, work, in_shared = tfa.admission_geometry(C)
        assert P >= C and threads <= 1024
        assert in_shared or work > 227 * 1024 - tfa._ADMISSION_STATIC
    for bad in (0, -1, 2**30):
        with pytest.raises(ValueError):
            tfa.admission_geometry(bad)


def test_admission_operands_take_the_solvers_tensors_as_they_are():
    """The dtypes the solvers pass (i32 and f32 vectors, a bool valid mask)
    reach the kernel with no conversion copy: the same storage. Other
    dtypes are converted."""
    args = as_torch(crowded_admission(C=64, N=16))
    args[6] = args[6].to(torch.bool)
    got = tfa.admission_operands(*args)
    assert [t.data_ptr() for t in got] == [t.data_ptr() for t in args]
    assert got[6].dtype == torch.bool
    other = list(args)
    other[0], other[6] = args[0].long(), args[6].to(torch.int32)
    conv = tfa.admission_operands(*other)
    assert conv[0].dtype == torch.int32 and conv[6].dtype == torch.uint8
    assert torch.equal(conv[6].bool(), args[6])


def score_edge_instance(seed, C, N):
    """Score-stage operands (numpy) with the first-max merge's edge cases:
    exact ties planted in columns 3, 33, 517 and N - 1 (those below N),
    which the score geometry gives to different threads and warps; a row
    (3) whose columns are all masked (nothing fits and its current node is
    out of range) and one (4) whose only fitting node, its current one, is
    invalid; current nodes out of range (row 1: -1, row 2: N); and row 5's
    current node invalid. Loads are whole hundreds of millicores and MiB,
    so every sum is exact. Returns ``(args, ties)`` with args in
    ``score_stage`` order: M, cur, home, pen, c_cpu, c_mem, valid,
    cpu_load, mem_load, cap, mem_cap, node_valid."""
    rng = np.random.default_rng(seed)
    ties = sorted({c for c in (3, 33, 517, N - 1) if c < N})
    M = rng.integers(0, 6, size=(C, N)).astype(np.float32)
    cap = np.full((N,), 4000.0, np.float32)
    cpu_load = (rng.integers(20, 36, size=N) * 100).astype(np.float32)
    mem_cap = np.full((N,), 2.0**30, np.float32)
    mem_load = (rng.integers(0, 100, size=N) * 2.0**20).astype(np.float32)
    node_valid = rng.random(N) < 0.95
    # tied columns: empty, valid, equal mass — every row's best, in a tie
    M[:, ties] = 5.0
    cpu_load[ties] = 0.0
    mem_load[ties] = 0.0
    node_valid[ties] = True
    others = np.setdiff1d(np.arange(N), ties)
    cur = others[rng.integers(0, others.size, size=C)].astype(np.int32)
    home = np.where(rng.random(C) < 0.5, cur, rng.integers(0, N, size=C)).astype(np.int32)
    pen = rng.integers(0, 3, size=C).astype(np.float32)
    c_cpu = (rng.integers(1, 5, size=C) * 100).astype(np.float32)
    c_mem = (rng.integers(0, 3, size=C) * 2.0**20).astype(np.float32)
    valid = rng.random(C) < 0.9
    cur[1], cur[2] = -1, N
    c_cpu[3], cur[3] = 1e9, -1
    node_valid[cur[5]] = False
    c_cpu[4], cur[4] = 1e9, cur[5]
    args = [M, cur, home, pen, c_cpu, c_mem, valid, cpu_load, mem_load, cap, mem_cap, node_valid]
    return args, ties


@pytest.mark.parametrize("N", [20, 257])
@pytest.mark.parametrize("use_noise", [False, True])
@pytest.mark.parametrize("use_move_pen", [False, True])
def test_score_edges_match_jax(N, use_noise, use_move_pen):
    """The merge's edge instance (ties across threads and warps, all-masked
    rows, current nodes out of range or invalid) through the port's plain
    chunk step and the JAX package's kernels in interpret mode: the same
    decisions, occupancy rows and deltas, exactly. The port's score stage
    gives the planted answers."""
    C = 64
    args, ties = score_edge_instance(N, C, N)
    M, cur, home, pen, c_cpu, c_mem, valid, *nodes = args
    temp = 0.7 if use_noise else 0.0
    extra = dict(home=home, move_pen=pen) if use_move_pen else {}
    kw = dict(block_c=48, enforce_capacity=True, use_noise=use_noise)
    j_out = jfa.fused_score_admission(
        *as_jax([M, cur, c_cpu, c_mem, valid, *nodes]), 0.5, temp, 9, 10.0,
        **{k: jnp.asarray(v) for k, v in extra.items()}, interpret=True,
        noise_impl="stateless", x_dtype=jnp.float32, **kw,
    )
    t_out = tfa.fused_score_admission(
        *as_torch([M, cur, c_cpu, c_mem, valid, *nodes]), 0.5, temp, 9, 10.0,
        **{k: torch.as_tensor(v) for k, v in extra.items()}, x_dtype=torch.float32, **kw,
    )
    for t, j in zip(t_out, j_out):  # integer loads: the deltas are exact too
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the score stage's own outputs on the planted rows
    t_args = as_torch(args)
    if not use_move_pen:
        t_args[2], t_args[3] = t_args[1], torch.zeros(C)
    prop, gain, wants, *_ = tfa.score_stage_plain(
        *t_args, 0.5, temp, 9, 10.0, enforce_capacity=True, use_noise=use_noise,
        use_move_pen=use_move_pen, block_c=48,
    )
    for r in (3, 4):  # all masked: column 0, no gain, no move
        assert int(prop[r]) == 0 and float(gain[r]) == float("-inf") and not int(wants[r])
    if not use_noise and not use_move_pen:  # a tie: the lowest tied column
        fits = np.asarray(c_cpu) <= 4000.0
        assert (prop.numpy()[fits] == ties[0]).all()


@pytest.mark.parametrize("C,N", [
    (1024, 1000),   # large: dense chunk
    (200, 200),     # powerlaw
    (1024, 2000),   # sparse50k: chunks, and the widest hub group
    (256, 2000), (512, 2000), (768, 2000),  # sparse50k hub groups
    (256, 20), (200, 20), (20, 20),         # auto_small, dense_200x20
    (1000, 1999), (1025, 2000), (1, 1), (3, 257), (4096, 2000), (1024, 50_000),
])
def test_score_geometry_is_a_legal_launch(C, N):
    """The score body's launch: at most 256 threads in whole warps, no more
    rows per tile than warps, and every (row, column) pair scored by
    exactly one thread of one block."""
    threads, rows, blocks = tfa.score_geometry(C, N)
    assert 32 <= threads <= 256 and threads % 32 == 0
    assert rows in (1, 2) and rows <= threads // 32
    owners = np.zeros(C, np.int64)
    for b in range(blocks):
        owners[b * rows:min(C, (b + 1) * rows)] += 1
    assert (owners == 1).all() and blocks * rows < C + rows
    cols = np.zeros(N, np.int64)
    for t in range(threads):  # each thread: 4 consecutive columns per panel
        for base in range(4 * t, N, 4 * threads):
            cols[base:min(N, base + 4)] += 1
    assert (cols == 1).all()
    if C >= 1024 and N > 1024:
        assert blocks * threads // 32 >= 4096  # ~31 warps on each SM


@pytest.mark.parametrize("n_slots,N", [(4, 2000), (1, 20), (4, 1999), (1, 200), (4, 30_000)])
@pytest.mark.parametrize("w_itemsize", [2, 4])
def test_mass_score_geometry_is_a_legal_launch(n_slots, N, w_itemsize):
    """The fused kernel takes the score body's geometry, with one warp per
    mass row and the rows (16-byte aligned) and product lists inside one
    block's shared memory; its blocks of ``rows`` rows tile each 256-row
    slot."""
    threads, rows, ldm, smem = sm.mass_score_geometry(n_slots, N, w_itemsize)
    assert threads >= 32 * rows and threads <= 256 and 256 % rows == 0
    assert ldm >= N and ldm % 4 == 0 and ldm - N < 4
    assert smem == rows * (4 * ldm + 32 * (16 // w_itemsize) * 8)
    assert smem <= 227 * 1024 - 1024
    if N <= 1024 * 8:
        assert (threads, rows) == tfa.score_geometry(n_slots * 256, N)[:2]


@pytest.mark.parametrize("C,SP", [
    (1024, 10240),  # large: C = 1024 of 10,000 services padded to 10,240
    (256, 2560),    # the kernel-vs-plain instance: 2,560 services, C = 256
    (256, 256),     # a single 256-row block
    (512, 1024),
])
@pytest.mark.parametrize("w_itemsize", [2, 4])
def test_mass_geometry_is_a_legal_launch(C, SP, w_itemsize):
    """One warp per row of M: whole blocks of 4 warps (the kernel's block)
    cover every chunk row once, the per-warp product lists fit one block's
    shared memory whatever N is, and W rows are whole 16-byte vectors."""
    blocks, smem = tfa.mass_geometry(C, SP, w_itemsize)
    assert blocks * 4 == C
    assert smem == 4 * 32 * (16 // w_itemsize) * 8 <= 227 * 1024
    assert SP % (16 // w_itemsize) == 0


def test_mass_geometry_refuses_illegal_launches():
    for C, SP, itemsize in ((0, 1024, 2), (6, 1024, 2), (1024, 0, 2), (1024, 1028, 2),
                            (1024, 1026, 4), (1024, 1024, 8), (-4, 1024, 4)):
        with pytest.raises(ValueError):
            tfa.mass_geometry(C, SP, itemsize)


def test_score_geometries_refuse_empty_launches():
    for C, N in ((0, 10), (10, 0), (-1, 5)):
        with pytest.raises(ValueError):
            tfa.score_geometry(C, N)
    with pytest.raises(ValueError):
        sm.mass_score_geometry(1, 100_000, 4)
