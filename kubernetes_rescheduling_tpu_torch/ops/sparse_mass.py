"""Neighbor-mass kernels over the block-local sparse pair weights — the port
of ``kubernetes_rescheduling_tpu.ops.sparse_mass``.

With the storage of ``core.sparsegraph`` the chunk's neighbor mass
contracts over each 256-row block's own neighbor set:

    M_b = w_local[:, strip_b] @ (one_hot(tgt_b) · rvu_b)     # [256, U_b] @ [U_b, N]

where ``tgt_b = assign[u_ids[strip_b]]`` and ``rvu_b`` carries the
neighbor replica counts (the row-side replica factor is applied by the
caller, or inside the fused kernel). The callers gather ``tgt``/``rvu``
chunk-locally (:func:`chunk_local_slabs`): regular blocks share one width,
so a chunk's columns are KB contiguous slices of ``u_ids``.

Three kernel wrappers, each with its plain PyTorch version here:

- :func:`sparse_neighbor_mass` → ``csrc/sparse_mass.cu`` (plain:
  :func:`reference_sparse_mass`): one chunk of regular blocks;
- :func:`hub_neighbor_mass` → ``csrc/sparse_mass.cu`` (plain:
  :func:`hub_mass_plain`): a group of hub blocks, walked as the flat list
  of their ragged tiles (:func:`hub_tile_arrays`);
- :func:`sparse_mass_score` → ``csrc/mass_score.cu`` (plain:
  :func:`sparse_mass_score_plain`): the chunk mass times the row replica
  factor, then the score stage, in one launch; its outputs feed
  ``admission_stage``. :func:`sparse_mass_score_in_place` is the same
  kernel reading the chunk's slabs and rows in place, through its block
  table, from the graph's and the solver's whole arrays (plain:
  :func:`sparse_mass_score_in_place_plain`, the gathers and then
  :func:`sparse_mass_score_plain`); its outputs feed
  ``admission_commit``.

As in ``fused_admission``: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise, and each wrapper counts its launches
in ``launches``. The solver's plain path calls the plain versions
directly.
"""

from __future__ import annotations

import torch

from kubernetes_rescheduling_tpu_torch.core.sparsegraph import BLOCK_R
from kubernetes_rescheduling_tpu_torch.ops import _build
from kubernetes_rescheduling_tpu_torch.ops import work as op_work
from kubernetes_rescheduling_tpu_torch.ops.fused_admission import (
    _SHARED_BYTES,
    _check_lengths,
    _device_scalar,
    _f32,
    _flag,
    _i32,
    _on_cuda,
    _ptr,
    _stream,
    block_row_ids,
    score_geometry,
    score_stage_plain,
)

# ---------------------------------------------------------------- plain math


def _scaled_one_hot(tgt, rv, cols, w_dtype) -> torch.Tensor:
    """``[..., U, N]`` tile ``one_hot(tgt)·rv`` cast to W's dtype (replica
    counts are small integers, exact in bf16), returned as f32 so the
    product accumulates in f32 (a bf16 product would round M)."""
    oh = torch.where(tgt[..., None] == cols, rv[..., None], 0.0)
    return oh.to(w_dtype).to(torch.float32)


def chunk_local_slabs(u_ids, rvu, starts, width: int):
    """A chunk's neighbor-id and replica columns: KB contiguous slices of
    ``width`` columns starting at ``starts`` (regular blocks share
    ``width``). Returns ``(u_c[KB·width], rvu_c[KB·width])``."""
    idx = starts.long()[:, None] + torch.arange(width, device=u_ids.device)[None, :]
    idx = idx.reshape(-1)
    return u_ids[idx], rvu[idx]


def reference_sparse_mass(
    w_mm, tgt_c, rvu_c, blocks, toff, *, num_nodes: int, bu: int, reg_tiles: int,
    col_offset: int = 0,
):
    """Plain version of :func:`sparse_neighbor_mass`: each block slot's W
    strip gathered and multiplied by its scaled one-hot tile. ``col_offset``
    shifts the node columns (a node-sharded caller computes its shard's
    columns: ``num_nodes`` = local width, offset = shard · width)."""
    U = reg_tiles * bu
    N = int(num_nodes)
    KB = blocks.shape[0]
    dev = w_mm.device
    cols = col_offset + torch.arange(N, dtype=torch.int32, device=dev)
    start = toff.long()[blocks.long()] * bu
    colidx = start[:, None] + torch.arange(U, device=dev)[None, :]      # [KB, U]
    wb = w_mm[:, colidx].permute(1, 0, 2).to(torch.float32)             # [KB, 256, U]
    oh = _scaled_one_hot(tgt_c.reshape(KB, U), rvu_c.reshape(KB, U), cols, w_mm.dtype)
    return torch.bmm(wb, oh).reshape(KB * BLOCK_R, N)


def hub_mass_plain(
    w_mm, tgt_l, rvu_l, tile_col, tile_lcol, tile_out, tile_first, *,
    num_nodes: int, num_hub_blocks: int, bu: int,
):
    """Plain version of :func:`hub_neighbor_mass` over the flat tile list:
    every tile's product, summed into its output block from the block's
    last ``tile_first`` tile on (the Pallas kernel resets there)."""
    N = int(num_nodes)
    dev = w_mm.device
    T = tile_col.shape[0]
    cols = torch.arange(N, dtype=torch.int32, device=dev)
    lane = torch.arange(bu, device=dev)[None, :]
    wt = w_mm[:, tile_col.long()[:, None] * bu + lane].permute(1, 0, 2).to(torch.float32)
    lcol = tile_lcol.long()[:, None] * bu + lane
    part = torch.bmm(wt, _scaled_one_hot(tgt_l[lcol], rvu_l[lcol], cols, w_mm.dtype))
    out_t = tile_out.long()
    t_idx = torch.arange(T, device=dev)
    last_first = torch.full((num_hub_blocks,), -1, dtype=torch.int64, device=dev)
    last_first = last_first.scatter_reduce(
        0, out_t, torch.where(tile_first != 0, t_idx, -1), reduce="amax"
    )
    keep = (t_idx >= last_first[out_t]).to(torch.float32)
    M = torch.zeros((num_hub_blocks, BLOCK_R, N), dtype=torch.float32, device=dev)
    M.index_add_(0, out_t, part * keep[:, None, None])
    return M.reshape(num_hub_blocks * BLOCK_R, N)


def reference_hub_mass(
    sgraph, w_mm, tgt_l, rvu_l, *, num_nodes: int, blocks=None, col_offset: int = 0,
):
    """Plain per-block twin of :func:`hub_neighbor_mass`: the hub offsets
    and widths are static, so each hub block's W strip is one product with
    its scaled one-hot slab. ``col_offset`` as in
    :func:`reference_sparse_mass` (the node-sharded solver's columns)."""
    N = int(num_nodes)
    cols = col_offset + torch.arange(N, dtype=torch.int32, device=w_mm.device)
    outs, lo = [], 0
    for b in blocks if blocks is not None else sgraph.hub_blocks:
        width = sgraph.block_ntiles[b] * sgraph.bu
        off = sgraph.block_toff[b] * sgraph.bu
        oh = _scaled_one_hot(tgt_l[lo:lo + width], rvu_l[lo:lo + width], cols, w_mm.dtype)
        outs.append(w_mm[:, off:off + width].to(torch.float32) @ oh)
        lo += width
    return torch.cat(outs, dim=0)


def hub_tile_arrays(sgraph, blocks=None, device=None):
    """The hub blocks' ragged tile lists flattened, output-block-major:
    ``(W column tile, group-local column tile, output slot, is-first)``,
    each i32[T] on ``device`` (default: the graph's). ``blocks`` selects a
    subset (the solver processes hubs in chunk-sized groups)."""
    cols, lcols, outs, firsts = [], [], [], []
    lcol = 0
    for slot, b in enumerate(blocks if blocks is not None else sgraph.hub_blocks):
        for j in range(sgraph.block_ntiles[b]):
            cols.append(sgraph.block_toff[b] + j)
            lcols.append(lcol)
            outs.append(slot)
            firsts.append(1 if j == 0 else 0)
            lcol += 1
    dev = sgraph.device if device is None else device
    # one host-to-device copy for the four arrays
    return torch.tensor([cols, lcols, outs, firsts], dtype=torch.int32, device=dev).unbind(0)


def sparse_mass_score_plain(
    w_mm, tgt_c, rvu_c, blocks, toff, rv_row, cur, home, move_pen, c_cpu, c_mem, valid_c,
    cpu_load, mem_load, cap, mem_cap, node_valid, lam, temp, seed, overload_weight, *,
    num_nodes, bu, reg_tiles, enforce_capacity, use_noise, use_move_pen,
):
    """Plain version of :func:`sparse_mass_score`: the plain chunk mass
    times the row replica factor, then ``score_stage_plain`` tiled at the
    256-row block (block i draws its noise with seed + i)."""
    M = reference_sparse_mass(
        w_mm, tgt_c, rvu_c, blocks, toff, num_nodes=num_nodes, bu=bu, reg_tiles=reg_tiles
    ) * rv_row.to(torch.float32)[:, None]
    return score_stage_plain(
        M, cur, home, move_pen, c_cpu, c_mem, valid_c, cpu_load, mem_load, cap, mem_cap,
        node_valid, lam, temp, seed, overload_weight, enforce_capacity=enforce_capacity,
        use_noise=use_noise, use_move_pen=use_move_pen, block_c=BLOCK_R,
    )


# ------------------------------------------------------------ kernel wrappers


def _check_weights(w_mm: torch.Tensor, bu: int) -> None:
    """The kernels read W with 16-byte vector loads along its rows."""
    if w_mm.dtype not in (torch.bfloat16, torch.float32) or w_mm.dim() != 2 \
            or w_mm.shape[0] != BLOCK_R:
        raise ValueError(
            f"w_mm must be a bf16 or f32 [{BLOCK_R}, TU] matrix, got {w_mm.dtype} "
            f"{tuple(w_mm.shape)}"
        )
    vec = 16 // w_mm.element_size()
    if bu % vec or w_mm.shape[1] % vec or w_mm.data_ptr() % 16:
        raise ValueError(f"bu={bu} and the W rows must be whole 16-byte vectors")


_CHUNK_WARPS = 8  # rows of M per CUDA block of the chunk mass kernel, one warp each
_SCORE_SHARED = _SHARED_BYTES - 1024  # the fused kernel's dynamic shared memory, at most


def chunk_mass_geometry(n_rows: int, w_itemsize: int, u_reg: int) -> tuple[int, int, int]:
    """Launch geometry of the chunk mass kernel for ``n_rows`` rows of M
    (KB·256), W elements of ``w_itemsize`` bytes and strips of ``u_reg``
    columns: ``(warps per block, blocks, shared bytes)``. One warp writes
    each row, and a block's rows share one 256-row slot: its tgt/rvu slab
    (8 bytes a column) sits in shared memory beside one list per warp of
    up to 32 vectors' worth of products (8 bytes each), whatever the
    output width."""
    if n_rows <= 0 or n_rows % BLOCK_R:
        raise ValueError(f"n_rows={n_rows} must be a positive multiple of {BLOCK_R}")
    if w_itemsize not in (2, 4):
        raise ValueError(f"W must be bf16 or f32, got {w_itemsize}-byte elements")
    warps = _CHUNK_WARPS
    smem = 8 * u_reg + warps * 32 * (16 // w_itemsize) * 8
    if u_reg <= 0 or smem > _SHARED_BYTES:
        raise ValueError(f"strips of {u_reg} columns do not fit one block's shared memory")
    return warps, n_rows // warps, smem


def mass_score_geometry(n_slots: int, N: int, w_itemsize: int) -> tuple[int, int, int, int]:
    """Launch geometry of the fused mass+score kernel over ``n_slots``
    256-row blocks of N nodes: ``(threads, rows, ldm, shared bytes)``, one
    block per ``rows`` rows. Threads and rows per block are the score body's
    (:func:`score_geometry` of the chunk's C = 256·n_slots rows), so the
    score phase keeps its occupancy; one warp writes each row's mass into
    shared memory (rows of ``ldm`` = N rounded up to 4 floats, 16-byte
    aligned) through its own product list of 32 vectors' worth of products
    (8 bytes each). A block whose two rows would not fit takes one."""
    if n_slots < 1 or N < 1:
        raise ValueError(f"{n_slots} slots x {N} nodes: both must be at least 1")
    if w_itemsize not in (2, 4):
        raise ValueError(f"W must be bf16 or f32, got {w_itemsize}-byte elements")
    threads, rows, _ = score_geometry(n_slots * BLOCK_R, N)
    ldm = -(-N // 4) * 4
    per_row = 4 * ldm + 32 * (16 // w_itemsize) * 8
    if rows * per_row > _SCORE_SHARED:
        rows = 1
    if per_row > _SCORE_SHARED:
        raise ValueError(f"output width {N} too large for one shared-memory row")
    return threads, rows, ldm, rows * per_row


_HUB_WARPS = 4  # rows of M per CUDA block: kLongRowWarps of csrc/sparse_row.cuh


def hub_mass_geometry(n_out: int, n_tiles: int, w_itemsize: int) -> tuple[int, int]:
    """Launch geometry of the hub mass kernel for ``n_out`` 256-row output
    blocks over a flat list of ``n_tiles`` tiles: ``(blocks, shared
    bytes)``. One warp writes each row, 4 rows a block, all of one output
    block; its tile table (8 bytes a tile, sized for the whole list, since
    a block finds its tiles by scanning it) sits in shared memory beside
    one list per warp of up to 32 vectors' worth of products (8 bytes each)
    and the tiles' count. So a list may hold at most about 28,000 tiles
    (bf16 W; 28,500 for f32), in any number of output blocks; the launcher
    checks the geometry."""
    if n_out < 1 or n_tiles < 0:
        raise ValueError(f"{n_out} output blocks, {n_tiles} tiles: need >= 1 and >= 0")
    if w_itemsize not in (2, 4):
        raise ValueError(f"W must be bf16 or f32, got {w_itemsize}-byte elements")
    smem = _HUB_WARPS * 32 * (16 // w_itemsize) * 8 + 8 * n_tiles + 16
    if smem > _SHARED_BYTES:
        raise ValueError(f"a list of {n_tiles} tiles does not fit one block's shared memory")
    return n_out * BLOCK_R // _HUB_WARPS, smem


def sparse_neighbor_mass(
    w_mm,     # [256, TU] block-local weights in matmul dtype
    tgt_c,    # i32[KB·u_reg] chunk-local assign[u_ids] slab, block-major
    rvu_c,    # f32[KB·u_reg] chunk-local neighbor replicas (0 on padding)
    blocks,   # i32[KB] the chunk's block ids (regular or dummy)
    toff,     # i32[NBX] per-block first W column tile (dummy entries included)
    *,
    num_nodes: int,
    bu: int,
    reg_tiles: int,
):
    """``M[KB·256, num_nodes]`` for one chunk of regular-width blocks —
    the wrapper of ``csrc/sparse_mass.cu``. ``num_nodes`` is the output
    width: the node count for M, the chunk width for the swap phase's
    chunk-local pair weights. On the card each row's products are added
    in a fixed order, so M is the same on every run for any weights (and
    equal to the plain version for integer ones)."""
    KB = blocks.shape[0]
    N = int(num_nodes)
    _check_lengths((tgt_c, rvu_c), KB * reg_tiles * bu, "chunk slabs")
    if not _on_cuda(w_mm, tgt_c, rvu_c, blocks, toff):
        return reference_sparse_mass(
            w_mm, tgt_c, rvu_c, blocks, toff, num_nodes=N, bu=bu, reg_tiles=reg_tiles
        )
    _check_weights(w_mm, bu)
    dev = w_mm.device
    warps, grid, smem = chunk_mass_geometry(KB * BLOCK_R, w_mm.element_size(), reg_tiles * bu)
    tgt, rvu, blk, tof = _i32(tgt_c), _f32(rvu_c), _i32(blocks), _i32(toff)
    M = torch.empty((KB * BLOCK_R, N), dtype=torch.float32, device=dev)
    lib = _build.library("sparse_mass")
    code = lib.krt_sparse_mass_launch(
        dev.index or 0, _ptr(w_mm), int(w_mm.dtype == torch.bfloat16), w_mm.shape[1],
        _ptr(tgt), _ptr(rvu), _ptr(blk), _ptr(tof), KB, bu, reg_tiles, N, warps, grid, smem,
        _ptr(M), _stream(dev),
    )
    _build.check(lib, code, "sparse_neighbor_mass")
    sparse_neighbor_mass.launches += 1
    op_work.count(sparse_neighbor_mass, *op_work.strips(
        KB * BLOCK_R, reg_tiles * bu, KB * BLOCK_R, N, w_mm.element_size(), KB * reg_tiles * bu))
    return M


sparse_neighbor_mass.launches = 0
sparse_neighbor_mass.work_ops = sparse_neighbor_mass.work_bytes = 0.0


def hub_neighbor_mass(
    w_mm,        # [256, TU]
    tgt_l,       # i32[W_g] group-local assign[u_ids] slab
    rvu_l,       # f32[W_g]
    tile_col,    # i32[T] flattened hub tile list: W column tile
    tile_lcol,   # i32[T] group-local column tile (into tgt_l/rvu_l)
    tile_out,    # i32[T] output block slot, block-major order
    tile_first,  # i32[T] 1 on each output block's first tile
    *,
    num_nodes: int,
    num_hub_blocks: int,
    bu: int,
):
    """``M[NHB·256, num_nodes]`` for a group of hub blocks, their ragged
    widths walked as a flat tile list — the wrapper of the hub kernel in
    ``csrc/sparse_mass.cu``. On the card each row's products are added in
    a fixed order (the output block's tiles in list order from its last
    ``tile_first`` on), so M is the same on every run for any weights (and
    equal to the plain version for integer ones). There a list of more than
    about 28,000 tiles raises (``hub_mass_geometry``); the 50k graph's
    groups hold at most 61."""
    N = int(num_nodes)
    tiles = (tile_col, tile_lcol, tile_out, tile_first)
    _check_lengths(tiles, tile_col.numel(), "tile arrays")
    _check_lengths((tgt_l, rvu_l), -(-tgt_l.numel() // bu) * bu, "hub slabs")
    if not _on_cuda(w_mm, tgt_l, rvu_l, *tiles):
        return hub_mass_plain(
            w_mm, tgt_l, rvu_l, *tiles, num_nodes=N, num_hub_blocks=num_hub_blocks, bu=bu
        )
    _check_weights(w_mm, bu)
    dev = w_mm.device
    T = tile_col.numel()
    blocks, smem = hub_mass_geometry(num_hub_blocks, T, w_mm.element_size())
    tgt, rvu = _i32(tgt_l), _f32(rvu_l)
    tc, tl, to, tf = (_i32(t) for t in tiles)
    M = torch.empty((num_hub_blocks * BLOCK_R, N), dtype=torch.float32, device=dev)
    lib = _build.library("sparse_mass")
    code = lib.krt_hub_mass_launch(
        dev.index or 0, _ptr(w_mm), int(w_mm.dtype == torch.bfloat16), w_mm.shape[1],
        _ptr(tgt), _ptr(rvu), _ptr(tc), _ptr(tl), _ptr(to), _ptr(tf), T, num_hub_blocks, bu, N,
        blocks, smem, _ptr(M), _stream(dev),
    )
    _build.check(lib, code, "hub_neighbor_mass")
    hub_neighbor_mass.launches += 1
    op_work.count(hub_neighbor_mass, *op_work.strips(
        T * BLOCK_R, bu, num_hub_blocks * BLOCK_R, N, w_mm.element_size(), tgt_l.numel()))
    return M


hub_neighbor_mass.launches = 0
hub_neighbor_mass.work_ops = hub_neighbor_mass.work_bytes = 0.0


def sparse_mass_score(
    w_mm,      # [256, TU] block-local weights in matmul dtype
    tgt_c,     # i32[KB·u_reg] chunk-local assign slab, block-major
    rvu_c,     # f32[KB·u_reg] chunk-local neighbor replicas
    blocks,    # i32[KB] the chunk's block ids
    toff,      # i32[NBX] per-block first W column tile
    rv_row,    # f32[C] row replica factor (C = KB·256)
    cur,       # i32[C]
    home,      # i32[C] move-cost anchor (pass cur when pricing is off)
    move_pen,  # f32[C] | None — None leaves the move penalty out
    c_cpu,     # f32[C]
    c_mem,     # f32[C]
    valid_c,   # bool[C]
    cpu_load, mem_load, cap, mem_cap, node_valid,  # [N] tables
    lam, temp, seed,  # scalars; temp and seed also as one-element tensors
    overload_weight=0.0,
    *,
    num_nodes: int,
    bu: int,
    reg_tiles: int,
    enforce_capacity: bool,
    use_noise: bool,
):
    """Fused mass + score for one regular chunk — the wrapper of
    ``csrc/mass_score.cu``. Returns the score stage's ``(prop i32, gain
    f32, wants i32, slack_cpu f32, slack_mem f32)``, each [C], identical
    to :func:`sparse_neighbor_mass` × ``rv_row`` → ``score_stage`` at
    ``block_c = 256``; feed them to ``admission_stage``."""
    KB = blocks.shape[0]
    C = KB * BLOCK_R
    N = int(num_nodes)
    use_move_pen = move_pen is not None
    if move_pen is None:
        move_pen = torch.zeros((C,), dtype=torch.float32, device=cur.device)
    rows_c = (rv_row, cur, home, move_pen, c_cpu, c_mem, valid_c)
    nodes = (cpu_load, mem_load, cap, mem_cap, node_valid)
    _check_lengths((tgt_c, rvu_c), KB * reg_tiles * bu, "chunk slabs")
    _check_lengths(rows_c, C, "row vectors")
    _check_lengths(nodes, N, "node vectors")
    if not _on_cuda(w_mm, tgt_c, rvu_c, blocks, toff, *rows_c, *nodes):
        return sparse_mass_score_plain(
            w_mm, tgt_c, rvu_c, blocks, toff, *rows_c, *nodes, lam, temp, seed,
            overload_weight, num_nodes=N, bu=bu, reg_tiles=reg_tiles,
            enforce_capacity=enforce_capacity, use_noise=use_noise, use_move_pen=use_move_pen,
        )
    mass_ops = (_i32(tgt_c), _f32(rvu_c), _i32(blocks), _i32(toff), _f32(rv_row))
    score_ops = (_i32(cur), _i32(home), _f32(move_pen), _f32(c_cpu), _f32(c_mem),
                 _flag(valid_c))
    return _mass_score_launch(w_mm, mass_ops, score_ops, nodes, lam, temp, seed,
                              overload_weight, KB, N, bu, reg_tiles, enforce_capacity,
                              use_noise, use_move_pen)


def _mass_score_launch(w_mm, mass_ops, score_ops, nodes, lam, temp, seed, overload_weight,
                       KB, N, bu, reg_tiles, enforce_capacity, use_noise, use_move_pen,
                       in_place=False):
    """One launch of ``csrc/mass_score.cu``: gathered, or ``in_place``
    through the block table (``mass_ops`` and ``score_ops`` then hold the
    whole arrays, ``score_ops[0]`` the assignment; ``home`` and ``pen`` may
    be None). Returns the five [KB·256] score outputs."""
    _check_weights(w_mm, bu)
    dev = w_mm.device
    C = KB * BLOCK_R
    threads, rows, ldm, smem = mass_score_geometry(KB, N, w_mm.element_size())
    prop = torch.empty((C,), dtype=torch.int32, device=dev)
    wants = torch.empty_like(prop)
    gain = torch.empty((C,), dtype=torch.float32, device=dev)
    slack_cpu = torch.empty_like(gain)
    slack_mem = torch.empty_like(gain)
    node_ops = tuple(_f32(t) for t in nodes[:4]) + (_flag(nodes[4]),)
    temp_t = _device_scalar(temp, torch.float32, dev)
    seed_t = _device_scalar(seed, torch.int32, dev)
    assign = score_ops[0] if in_place else None
    lib = _build.library("mass_score")
    code = lib.krt_mass_score_launch(
        dev.index or 0, _ptr(w_mm), int(w_mm.dtype == torch.bfloat16), w_mm.shape[1],
        *(_ptr(t) for t in mass_ops), KB, bu, reg_tiles, threads, rows, ldm, smem,
        *(None if t is None else _ptr(t) for t in score_ops + node_ops),
        float(lam), float(overload_weight), _ptr(temp_t), _ptr(seed_t), N,
        int(enforce_capacity), int(use_noise), int(use_move_pen),
        _ptr(prop), _ptr(gain), _ptr(wants), _ptr(slack_cpu), _ptr(slack_mem),
        None if assign is None else _ptr(assign), 0 if assign is None else assign.numel(),
        _stream(dev),
    )
    _build.check(lib, code, "sparse_mass_score")
    sparse_mass_score.launches += 1
    op_work.count(sparse_mass_score, *op_work.mass_score(
        C, reg_tiles * bu, N, w_mm.element_size(), KB * reg_tiles * bu, use_noise))
    return prop, gain, wants, slack_cpu, slack_mem


sparse_mass_score.launches = 0
sparse_mass_score.work_ops = sparse_mass_score.work_bytes = 0.0


def sparse_mass_score_in_place_plain(
    w_mm, u_ids, rvu, assign, blocks, toff, rv_s, home, move_pen, svc_cpu, svc_mem, svc_valid,
    cpu_load, mem_load, cap, mem_cap, node_valid, lam, temp, seed, overload_weight, *,
    num_nodes, bu, reg_tiles, enforce_capacity, use_noise,
):
    """Plain version of :func:`sparse_mass_score_in_place`: the chunk's
    slabs (:func:`chunk_local_slabs`, targets ``assign[clamp(u_ids)]``) and
    rows (``block_row_ids``) gathered, then :func:`sparse_mass_score_plain`."""
    ids = block_row_ids(blocks)
    u_c, rvu_c = chunk_local_slabs(u_ids, rvu, toff[blocks.long()].long() * bu, reg_tiles * bu)
    tgt_c = assign[torch.clamp(u_c.long(), 0, assign.shape[0] - 1)]
    cur = assign[ids]
    use_move_pen = move_pen is not None
    return sparse_mass_score_plain(
        w_mm, tgt_c, rvu_c, blocks, toff, rv_s[ids], cur, home[ids] if use_move_pen else cur,
        move_pen[ids] if use_move_pen else torch.zeros_like(rv_s[ids]), svc_cpu[ids],
        svc_mem[ids], svc_valid[ids], cpu_load, mem_load, cap, mem_cap, node_valid, lam, temp,
        seed, overload_weight, num_nodes=num_nodes, bu=bu, reg_tiles=reg_tiles,
        enforce_capacity=enforce_capacity, use_noise=use_noise, use_move_pen=use_move_pen,
    )


def sparse_mass_score_in_place(
    w_mm,      # [256, TU] block-local weights in matmul dtype
    u_ids,     # i32[TU] the graph's neighbor id per W column (>= sp on padding)
    rvu,       # f32[TU] the neighbor replica factor per W column (0 on padding)
    assign,    # i32[SPX] current node per sorted-space service
    blocks,    # i32[KB] the chunk's block ids
    toff,      # i32[NBX] per-block first W column tile
    rv_s,      # f32[SPX] replica factor per service
    home,      # i32[SPX] move-cost anchor, with move_pen; None: pricing off
    move_pen,  # f32[SPX] | None
    svc_cpu,   # f32[SPX]
    svc_mem,   # f32[SPX]
    svc_valid,  # bool[SPX]
    cpu_load, mem_load, cap, mem_cap, node_valid,  # [N] tables
    lam, temp, seed,  # scalars; temp and seed also as one-element tensors
    overload_weight=0.0,
    *,
    num_nodes: int,
    bu: int,
    reg_tiles: int,
    enforce_capacity: bool,
    use_noise: bool,
):
    """:func:`sparse_mass_score` for the chunk of ``blocks`` read in place:
    the kernel takes each slot's slab from the strip's own columns of
    ``u_ids`` / ``rvu`` (targets from ``assign``) and its rows from the
    service arrays at ``blocks[i]·256 + row``, so the caller gathers
    nothing. Returns the same ``(prop, gain, wants, slack_cpu, slack_mem)``,
    each [KB·256], bit for bit. CPU tensors take the plain version
    (:func:`sparse_mass_score_in_place_plain`)."""
    KB = blocks.shape[0]
    N = int(num_nodes)
    if (home is None) != (move_pen is None):
        raise ValueError("home and move_pen come together (move-cost pricing) or not at all")
    rows = tuple(t for t in (rv_s, home, move_pen, svc_cpu, svc_mem, svc_valid)
                 if t is not None)
    nodes = (cpu_load, mem_load, cap, mem_cap, node_valid)
    _check_lengths((u_ids, rvu), w_mm.shape[1], "neighbor columns")
    _check_lengths((assign, *rows), assign.numel(), "service arrays")
    _check_lengths(nodes, N, "node vectors")
    if not _on_cuda(w_mm, u_ids, rvu, assign, blocks, toff, *rows, *nodes):
        return sparse_mass_score_in_place_plain(
            w_mm, u_ids, rvu, assign, blocks, toff, rv_s, home, move_pen, svc_cpu, svc_mem,
            svc_valid, *nodes, lam, temp, seed, overload_weight, num_nodes=N, bu=bu,
            reg_tiles=reg_tiles, enforce_capacity=enforce_capacity, use_noise=use_noise,
        )
    if assign.dtype != torch.int32 or not assign.is_contiguous():
        raise ValueError(f"assign must be a contiguous i32 vector, got {assign.dtype}")
    mass_ops = (_i32(u_ids), _f32(rvu), _i32(blocks), _i32(toff), _f32(rv_s))
    score_ops = (assign, None if home is None else _i32(home),
                 None if move_pen is None else _f32(move_pen), _f32(svc_cpu), _f32(svc_mem),
                 _flag(svc_valid))
    return _mass_score_launch(w_mm, mass_ops, score_ops, nodes, lam, temp, seed,
                              overload_weight, KB, N, bu, reg_tiles, enforce_capacity,
                              use_noise, move_pen is not None, in_place=True)
