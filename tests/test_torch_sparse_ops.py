"""The port's sparse-mass kernels, through their plain versions on the CPU,
against the JAX package's Pallas kernels in interpret mode.

The same seeded numpy inputs go to both packages. The pair weights and
replica counts are integers, so every mass is an integer sum, exact in f32
in any order: mass, decisions and score outputs must be EXACTLY equal,
noise off and on (with ``noise_impl="stateless"``, the JAX package's u32
mixer, which is the port's noise on both devices). The one exception is
the gain with noise on, held at atol 1e-5: the two frameworks' CPU
logarithms differ in the last bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu.core import sparsegraph as jsg
from kubernetes_rescheduling_tpu.ops import sparse_mass as jsm
from kubernetes_rescheduling_tpu_torch import ops
from kubernetes_rescheduling_tpu_torch.core import sparsegraph as tsg
from kubernetes_rescheduling_tpu_torch.ops import fused_admission as tfa
from kubernetes_rescheduling_tpu_torch.ops import sparse_mass as tsm

BLOCK_R = 256


def random_edges(S, mean_degree, seed):
    rng = np.random.default_rng(seed)
    E = int(S * mean_degree / 2)
    return (rng.integers(0, S, size=E), rng.integers(0, S, size=E),
            rng.integers(1, 5, size=E).astype(np.float64))


def both(src, dst, w, S, **kw):
    return jsg.from_edges(src, dst, w, S, **kw), tsg.from_edges(src, dst, w, S, device="cpu",
                                                                **kw)


def regular_instance(seed=1, N=16):
    """tests/test_sparse_solver.py:128's graph (integer weights 1..4, wide
    regular blocks, no hubs), random occupancy and replica counts 1..2."""
    jg, tg = both(*random_edges(600, 4.0, seed=5), 600, bu=128, reg_tiles=8)
    assert not tg.hub_blocks
    SP = tg.sp
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, N, size=SP).astype(np.int32)
    rv = rng.integers(1, 3, size=SP).astype(np.float32)
    u = tg.u_ids.numpy()
    rvu = np.where(u < SP, rv[np.clip(u, 0, SP - 1)], 0.0).astype(np.float32)
    toff = np.asarray(tg.block_toff, np.int32)
    return jg, tg, assign, rv, rvu, toff


def slabs(tg, assign, rvu, toff, blocks, targets=None):
    u_c, rvu_c = tsm.chunk_local_slabs(
        tg.u_ids, torch.as_tensor(rvu), torch.as_tensor(toff)[torch.as_tensor(blocks)] * tg.bu,
        tg.u_reg,
    )
    tgt = assign if targets is None else targets
    return tgt[np.clip(u_c.numpy(), 0, len(tgt) - 1)].astype(np.int32), rvu_c.numpy()


def test_chunk_local_slabs_match_jax():
    jg, tg, assign, rv, rvu, toff = regular_instance()
    starts = toff[np.asarray([2, 0, 1])] * tg.bu
    j_u, j_rvu = jsm.chunk_local_slabs(jg.u_ids, jnp.asarray(rvu), jnp.asarray(starts), tg.u_reg)
    t_u, t_rvu = tsm.chunk_local_slabs(tg.u_ids, torch.as_tensor(rvu), torch.as_tensor(starts),
                                       tg.u_reg)
    np.testing.assert_array_equal(t_u.numpy(), np.asarray(j_u))
    np.testing.assert_array_equal(t_rvu.numpy(), np.asarray(j_rvu))


@pytest.mark.parametrize("w_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("chunk_width", [False, True])
def test_sparse_neighbor_mass_matches_jax(w_dtype, chunk_width):
    """Node occupancy (nn = N) and the swap phase's chunk-position targets
    (nn = C, targets outside the chunk match no column)."""
    jg, tg, assign, rv, rvu, toff = regular_instance()
    blocks = np.asarray([2, 0, 1], np.int32)
    N = 16
    targets = None
    if chunk_width:
        ids = (blocks[:, None] * BLOCK_R + np.arange(BLOCK_R)).reshape(-1)
        N = len(ids)
        targets = np.full((tg.sp,), N, np.int32)
        targets[ids] = np.arange(N)
    tgt_c, rvu_c = slabs(tg, assign, rvu, toff, blocks, targets)
    w_j = jg.w_local.astype(jnp.dtype(w_dtype))
    w_t = tg.w_local.to(getattr(torch, w_dtype))
    kw = dict(num_nodes=N, bu=tg.bu, reg_tiles=tg.reg_tiles)
    want = jsm.sparse_neighbor_mass(w_j, jnp.asarray(tgt_c), jnp.asarray(rvu_c),
                                    jnp.asarray(blocks), jnp.asarray(toff), interpret=True, **kw)
    t_args = (w_t, torch.as_tensor(tgt_c), torch.as_tensor(rvu_c), torch.as_tensor(blocks),
              torch.as_tensor(toff))
    got = tsm.sparse_neighbor_mass(*t_args, **kw)
    assert got.dtype == torch.float32 and got.shape == (3 * BLOCK_R, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = jsm.reference_sparse_mass(w_j, jnp.asarray(tgt_c), jnp.asarray(rvu_c),
                                    jnp.asarray(blocks), jnp.asarray(toff), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert float(got.sum()) > 0


def hub_instance(seed=7, N=16):
    """tests/test_sparse_solver.py:164's star over a random background:
    ragged hub blocks with bu=128, reg_tiles=1."""
    S = 600
    rng = np.random.default_rng(seed)
    bg_src, bg_dst, _ = random_edges(S, 3.0, seed=8)
    src = np.concatenate([np.zeros(260, dtype=np.int64), bg_src])
    dst = np.concatenate([np.arange(1, 261, dtype=np.int64), bg_dst])
    jg, tg = both(src, dst, np.ones(len(src)), S, bu=128, reg_tiles=1)
    assert tg.hub_blocks and max(tg.block_ntiles) > 2
    assign = rng.integers(0, N, size=tg.sp).astype(np.int32)
    rv = rng.integers(1, 4, size=tg.sp).astype(np.float32)
    return jg, tg, assign, rv


def test_hub_neighbor_mass_matches_jax():
    jg, tg, assign, rv = hub_instance()
    N = 16
    u_g = np.concatenate([
        tg.u_ids.numpy()[tg.block_toff[b] * tg.bu:(tg.block_toff[b] + tg.block_ntiles[b]) * tg.bu]
        for b in tg.hub_blocks
    ])
    tgt_l = assign[np.clip(u_g, 0, tg.sp - 1)]
    rvu_l = np.where(u_g < tg.sp, rv[np.clip(u_g, 0, tg.sp - 1)], 0.0).astype(np.float32)
    j_tiles = jsm.hub_tile_arrays(jg)
    t_tiles = tsm.hub_tile_arrays(tg)
    for jt, tt in zip(j_tiles, t_tiles):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    kw = dict(num_nodes=N, num_hub_blocks=len(tg.hub_blocks), bu=tg.bu)
    want = jsm.hub_neighbor_mass(jg.w_local.astype(jnp.bfloat16), jnp.asarray(tgt_l),
                                 jnp.asarray(rvu_l), *j_tiles, interpret=True, **kw)
    got = tsm.hub_neighbor_mass(tg.w_local.to(torch.bfloat16), torch.as_tensor(tgt_l),
                                torch.as_tensor(rvu_l), *t_tiles, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # ... and the JAX package's plain-XLA twin, which its plain solver path runs
    twin = jsm.reference_hub_mass(jg, jg.w_local.astype(jnp.bfloat16), jnp.asarray(tgt_l),
                                  jnp.asarray(rvu_l), num_nodes=N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(twin))
    # a group of later hub blocks: slots renumbered from 0
    sub = tg.hub_blocks[1:]
    lo = tg.block_ntiles[tg.hub_blocks[0]] * tg.bu
    sub_kw = dict(kw, num_hub_blocks=len(sub))
    got_sub = tsm.hub_neighbor_mass(tg.w_local, torch.as_tensor(tgt_l[lo:]),
                                    torch.as_tensor(rvu_l[lo:]), *tsm.hub_tile_arrays(tg, sub),
                                    **sub_kw)
    np.testing.assert_array_equal(got_sub.numpy(), np.asarray(want)[BLOCK_R:])


def score_operands(seed, C, N):
    """Per-row and per-node score operands in the pattern of
    tests/test_torch_ops.py (tight capacity, integer loads)."""
    rng = np.random.default_rng(100 + seed)
    cur = rng.integers(0, N, size=C).astype(np.int32)
    home = rng.integers(0, N, size=C).astype(np.int32)
    pen = rng.integers(0, 3, size=C).astype(np.float32)
    c_cpu = (rng.integers(1, 5, size=C) * 100.0).astype(np.float32)
    c_mem = (rng.integers(0, 3, size=C) * 1e6).astype(np.float32)
    valid_c = rng.random(C) < 0.9
    cpu_load = rng.integers(0, 1600, size=N).astype(np.float32)
    mem_load = rng.integers(0, 100, size=N).astype(np.float32) * 1e6
    cap = np.full((N,), 2000.0, np.float32)
    mem_cap = np.full((N,), 1e9, np.float32)
    node_valid = rng.random(N) < 0.95
    return cur, home, pen, c_cpu, c_mem, valid_c, cpu_load, mem_load, cap, mem_cap, node_valid


@pytest.mark.parametrize("use_noise,move_pen", [(False, False), (True, False), (True, True)])
def test_sparse_mass_score_matches_jax(use_noise, move_pen):
    jg, tg, assign, rv, rvu, toff = regular_instance(seed=3)
    blocks = np.asarray([1, 2], np.int32)
    C, N = 2 * BLOCK_R, 16
    ids = (blocks[:, None] * BLOCK_R + np.arange(BLOCK_R)).reshape(-1)
    tgt_c, rvu_c = slabs(tg, assign, rvu, toff, blocks)
    rows = list(score_operands(int(use_noise) + 2 * int(move_pen), C, N))
    if not move_pen:
        rows[1], rows[2] = rows[0], None
    cur, home, pen, *rest = rows
    lam, temp, seed, ow = 0.5, 0.7, 12345, 10.0
    kw = dict(num_nodes=N, bu=tg.bu, reg_tiles=tg.reg_tiles, enforce_capacity=True,
              use_noise=use_noise)

    def jx(a):
        return None if a is None else jnp.asarray(a)

    def tx(a):
        return None if a is None else torch.as_tensor(a)

    want = jsm.sparse_mass_score(
        jg.w_local.astype(jnp.bfloat16), jx(tgt_c), jx(rvu_c), jx(blocks), jx(toff), jx(rv[ids]),
        jx(cur), jx(home), jx(pen), *map(jx, rest), lam, temp, seed, ow, interpret=True,
        noise_impl="stateless", **kw,
    )
    w_t = tg.w_local.to(torch.bfloat16)
    got = tsm.sparse_mass_score(
        w_t, tx(tgt_c), tx(rvu_c), tx(blocks), tx(toff), tx(rv[ids]), tx(cur), tx(home), tx(pen),
        *map(tx, rest), lam, temp, seed, ow, **kw,
    )
    names = ("prop", "gain", "wants", "slack_cpu", "slack_mem")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w).reshape(-1)
        if name == "gain" and use_noise:
            # XLA's CPU logf and PyTorch's differ by one ulp on ~15% of
            # inputs, so the scores (|score| < 64 here, ulp 3.8e-6) and the
            # gain, their difference, can differ in the last bits; the
            # decisions stay exact
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int(got[2].sum()) > 0  # some rows want to move
    # the fused plain path equals the two-step plain path: kernel 4's
    # plain version times the row factor, then the score stage at 256 rows
    M = tsm.sparse_neighbor_mass(w_t, tx(tgt_c), tx(rvu_c), tx(blocks), tx(toff), num_nodes=N,
                                 bu=tg.bu, reg_tiles=tg.reg_tiles) * tx(rv[ids])[:, None]
    pen_t = tx(pen) if move_pen else torch.zeros(C)
    two_step = tfa.score_stage(
        M, tx(cur), tx(home), pen_t, *map(tx, rest), lam, temp, seed, ow,
        enforce_capacity=True, use_noise=use_noise, use_move_pen=move_pen, block_c=BLOCK_R,
    )
    for g, w in zip(got, two_step):
        assert torch.equal(g, w)


def test_sparse_wrappers_count_only_kernel_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    ops.reset_launch_counts()
    jg, tg, assign, rv, rvu, toff = regular_instance()
    blocks = np.asarray([0], np.int32)
    tgt_c, rvu_c = slabs(tg, assign, rvu, toff, blocks)
    tsm.sparse_neighbor_mass(tg.w_local, torch.as_tensor(tgt_c), torch.as_tensor(rvu_c),
                             torch.as_tensor(blocks), torch.as_tensor(toff), num_nodes=4,
                             bu=tg.bu, reg_tiles=tg.reg_tiles)
    assert set(ops.launch_counts().values()) == {0}


def test_sparse_wrappers_refuse_other_devices():
    """Mixed devices raise instead of falling back; so do slabs of the
    wrong width."""
    jg, tg, assign, rv, rvu, toff = regular_instance()
    blocks = np.asarray([0], np.int32)
    tgt_c, rvu_c = slabs(tg, assign, rvu, toff, blocks)
    kw = dict(num_nodes=4, bu=tg.bu, reg_tiles=tg.reg_tiles)
    args = [tg.w_local.to("meta"), torch.as_tensor(tgt_c), torch.as_tensor(rvu_c),
            torch.as_tensor(blocks), torch.as_tensor(toff)]
    with pytest.raises(ValueError, match="devices"):
        tsm.sparse_neighbor_mass(*args, **kw)
    args[0] = tg.w_local
    args[1] = args[1][:-1]
    with pytest.raises(ValueError, match="slabs"):
        tsm.sparse_neighbor_mass(*args, **kw)


def test_chunk_mass_geometry_covers_the_solvers_chunks():
    """One warp per row of M: every chunk the sparse solver can cut (KB
    blocks of 256 rows, auto or explicit chunk sizes, bf16 or f32 W,
    strips of the graph builder's widths) gets a grid of whole blocks
    covering every row, each block's rows within one 256-row slot, at most
    1024 threads a block and its slab and lists within the 227 KB a block
    may use, whatever the output width; sizes no layout makes raise."""
    from kubernetes_rescheduling_tpu_torch.solver.global_solver import auto_chunk

    kbs = set()
    for S in (300, 2560, 10_000, 50_000, 200_000):
        for chunk_size in (0, 256, 1000, 1024, 4096, 16_384):
            kbs.add(max(1, min(auto_chunk(S, chunk_size), S) // BLOCK_R))
    for kb in sorted(kbs):
        rows = kb * BLOCK_R
        for itemsize in (2, 4):
            for bu, reg_tiles in ((512, 2), (256, 1), (512, 4), (1024, 2)):
                warps, blocks, smem = tsm.chunk_mass_geometry(rows, itemsize, bu * reg_tiles)
                assert warps * 32 <= 1024 and BLOCK_R % warps == 0
                assert blocks * warps == rows
                assert smem == 8 * bu * reg_tiles + warps * 32 * (16 // itemsize) * 8
                assert smem <= 227 * 1024
    for rows, itemsize, u in ((0, 2, 1024), (100, 2, 1024), (256, 8, 1024), (256, 2, 30_000)):
        with pytest.raises(ValueError):
            tsm.chunk_mass_geometry(rows, itemsize, u)


@pytest.mark.parametrize("n_out,n_tiles", [
    (4, 61),   # sparse50k: the widest group of four hub blocks
    (4, 24),
    (1, 3),    # the hub instance of the solver tests: one hub block, bu = 128
    (8, 517),  # every tile of the 50k graph's weights in one list
    (3, 0),    # no tiles: rows of zeros
    (1, 28_030),  # the most tiles a list may hold with bf16 W
])
@pytest.mark.parametrize("w_itemsize", [2, 4])
def test_hub_mass_geometry_is_a_legal_launch(n_out, n_tiles, w_itemsize):
    """One warp per row of M: whole blocks of 4 warps (the kernel's block)
    cover the output blocks' rows once, each block's rows within one output
    block, and the per-warp lists, the tile table and its count fit one
    block's shared memory."""
    blocks, smem = tsm.hub_mass_geometry(n_out, n_tiles, w_itemsize)
    assert blocks * 4 == n_out * BLOCK_R
    assert smem == 4 * 32 * (16 // w_itemsize) * 8 + 8 * n_tiles + 16 <= 227 * 1024


def test_hub_mass_geometry_refuses_illegal_launches():
    for n_out, n_tiles, itemsize in ((0, 4, 2), (2, -1, 2), (2, 4, 8), (1, 28_031, 2),
                                     (1, 28_543, 4)):
        with pytest.raises(ValueError):
            tsm.hub_mass_geometry(n_out, n_tiles, itemsize)

