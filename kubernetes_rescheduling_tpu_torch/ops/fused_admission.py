"""Fused score → argmax → capacity admission, and the neighbor mass, for one
solver chunk step — the port of ``kubernetes_rescheduling_tpu.ops.
fused_admission``.

Semantics (identical to the JAX package):

1. ``score[c, n] = M[c, n] − λ·proj_pct − ow·relu(proj_pct − 100)
   − pen·[n ≠ home] (+ temp·gumbel)`` where ``proj_pct`` is the node's CPU
   load in % of the packing budget if service c landed on n.
2. Feasibility: fits capacity (or is the current node), node valid.
3. ``prop[c]`` = first-max feasible node; ``gain`` vs the current node.
4. Admission: a proposal lands only if the target's free capacity covers
   every strictly-higher-priority same-target arrival plus itself
   (priority = greater gain, ties → lower chunk index).

Three kernel wrappers, each with its plain PyTorch version here:

- :func:`fused_neighbor_mass` → ``csrc/mass.cu`` (plain: ``W[ids] @ X``
  in f32 against the one-hot occupancy);
- :func:`score_stage` → ``csrc/score.cu`` (plain:
  :func:`score_stage_plain`, :func:`score_core` tile by tile);
- :func:`admission_stage` → ``csrc/admission.cu`` (plain:
  :func:`admission_plain`, :func:`pairwise_admission` plus the
  tile-ordered commit arithmetic); :func:`admission_commit` is the same
  kernel reading a sparse chunk's rows through its block table and
  committing the assignment, the loads and the move count in place (plain:
  :func:`admission_commit_plain`, the gathers, :func:`admission_plain`
  and the commit).

:func:`fused_score_admission` is the score stage followed by the
admission stage, as in the JAX package.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises — nothing falls back. Each wrapper counts
its kernel launches in a plain integer attribute, ``launches``.

Annealing noise is the u32 mixer :func:`_stateless_uniform` on both
devices (the TPU core PRNG has no counterpart): the kernels and their
plain versions draw the same bits. The score kernels read the chunk's
noise seed and temperature from device memory (one-element tensors, or
Python numbers the wrapper places there), so a solve captured as a CUDA
graph replays with the values its seed and temperature tables hold at
each replay.
"""

from __future__ import annotations

import torch

from kubernetes_rescheduling_tpu_torch.ops import _build
from kubernetes_rescheduling_tpu_torch.ops import work as op_work

_NEG_INF = float("-inf")
_M32 = 0xFFFFFFFF
_SHARED_BYTES = 227 * 1024  # shared memory one Hopper block can use
_ADMISSION_STATIC = 1024    # the admission kernel's own scan scratch, at most
_SCORE_THREADS = 256        # threads of a score tile, at most (csrc/score_core.cuh)
_SCORE_WARPS = 4096         # warps a score launch aims for: ~31 on each of 132 SMs
_BLOCK_ROWS = 256           # rows of a sparse-graph block (core.sparsegraph.BLOCK_R)


# ---------------------------------------------------------------- plain math


def _mul32(x, k: int):
    """``x · k mod 2^32`` for an int64 tensor or Python int ``x`` in
    [0, 2^32): split so no product leaves the int64 range (torch has no
    full uint32 arithmetic)."""
    lo = x * (k & 0xFFFF)
    hi = (x * (k >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _stateless_uniform(seed, shape, device=None) -> torch.Tensor:
    """Deterministic per-(seed, row, col) uniform in (0, 1) over ``shape``
    (rows, cols) from the u32 finalizer-style mixer: bit-identical to the
    JAX package's ``_stateless_uniform`` and to ``csrc/score.cu``. The seed
    is a host integer (it stays on the host) or a one-element integer
    tensor (read where it lies, never on the host)."""
    rows, cols = shape
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    s = seed.reshape(()).long() if isinstance(seed, torch.Tensor) else int(seed)
    x = _mul32(s & _M32, 0x9E3779B9)
    x = x ^ _mul32(r, 0x85EBCA6B) ^ _mul32(c, 0xC2B2AE35)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    mant = (x & 0x7FFFFF).to(torch.float32)
    return (mant + 0.5) * (1.0 / 8388608.0)


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Row-wise argmax with ``jnp.argmax``'s tie rule: the lowest column
    among the maxima (an all ``-inf`` row gives 0). i32[R]."""
    n = x.shape[1]
    col = torch.arange(n, device=x.device)[None, :]
    top = x.max(dim=1, keepdim=True).values
    idx = torch.where(x == top, col, n).min(dim=1).values
    return torch.clamp_max(idx, n - 1).to(torch.int32)


def score_core(
    m, cur, home, pen, c_cpu, c_mem, valid,
    cpu_load, mem_load, cap, mem_cap, node_valid,
    lam, ow, temp, seed,
    *,
    enforce_capacity: bool,
    use_noise: bool,
    use_move_pen: bool,
):
    """Plain version of the score kernel for ONE tile: chunk score →
    first-max proposal → per-row reductions.

    Shapes: ``m`` [BC, N]; ``cur/home/pen/c_cpu/c_mem/valid`` [BC];
    ``cpu_load/mem_load/cap/mem_cap/node_valid`` [N]; ``seed`` is the
    tile's seed (the mixer's row index is the row within the tile);
    ``temp`` and ``seed`` are numbers or one-element tensors.
    Returns ``(prop i32, gain f32, wants i32, slack_cpu, slack_mem)``,
    each [BC]."""
    bc, n = m.shape
    col = torch.arange(n, device=m.device)[None, :]
    is_cur = col == cur[:, None]

    proj_cpu = cpu_load[None, :] + torch.where(is_cur, 0.0, c_cpu[:, None])
    proj_pct = proj_cpu / cap[None, :] * 100.0
    score = m - lam * proj_pct - ow * torch.clamp_min(proj_pct - 100.0, 0.0)
    if use_move_pen:
        # residency anywhere but the round-start node costs pen
        score = score - torch.where(col == home[:, None], 0.0, pen[:, None])
    if use_noise:
        u = _stateless_uniform(seed, (bc, n), device=m.device)
        t = temp.reshape(()) if isinstance(temp, torch.Tensor) else temp
        score = score + t * (-torch.log(-torch.log(u)))

    if enforce_capacity:
        proj_mem = mem_load[None, :] + torch.where(is_cur, 0.0, c_mem[:, None])
        fits = (proj_cpu <= cap[None, :]) & (proj_mem <= mem_cap[None, :])
        feasible = (fits | is_cur) & node_valid[None, :]
    else:
        feasible = node_valid[None, :].expand(bc, n)

    masked = torch.where(feasible, score, _NEG_INF)
    prop_score = masked.max(dim=1, keepdim=True).values
    # first-max: lowest column index among maxima
    prop = torch.where(masked == prop_score, col, n).min(dim=1).values
    prop = torch.clamp_max(prop, n - 1)
    cur_score = torch.where(is_cur, score, 0.0).sum(dim=1)
    gain = prop_score[:, 0] - cur_score
    wants = valid & (gain > 0) & (prop != cur)
    return (
        prop.to(torch.int32),
        gain,
        wants.to(torch.int32),
        cap[prop] - cpu_load[prop] - c_cpu,
        mem_cap[prop] - mem_load[prop] - c_mem,
    )


def pairwise_admission(gain, prop, wants, c_cpu, c_mem, slack_cpu, slack_mem):
    """The sort-free within-chunk capacity race: a proposal is admitted iff
    the target's slack covers every higher-priority (greater gain, ties →
    lower index) same-target arrival plus itself. The landed mass is a
    float32 product (TF32 is off package-wide)."""
    C = gain.shape[0]
    cidx = torch.arange(C, device=gain.device)
    gain_w = torch.where(wants, gain, _NEG_INF)
    before = (gain_w[None, :] > gain_w[:, None]) | (
        (gain_w[None, :] == gain_w[:, None]) & (cidx[None, :] < cidx[:, None])
    )
    pri = (before & wants[None, :] & (prop[None, :] == prop[:, None])).to(torch.float32)
    land_cpu = pri @ torch.where(wants, c_cpu, 0.0)
    land_mem = pri @ torch.where(wants, c_mem, 0.0)
    return wants & (land_cpu <= slack_cpu) & (land_mem <= slack_mem)


def reference_score_admission(
    M, cur, c_cpu, c_mem, valid_c, cpu_load, mem_load, cap, mem_cap,
    node_valid, lam, noise=None, overload_weight=0.0, home=None,
    move_pen=None, *, enforce_capacity: bool,
):
    """The solver's plain epilogue (the JAX package's XLA twin): same
    expressions as the kernels, term for term. ``noise`` is a
    caller-supplied [C, N] additive score perturbation."""
    C, N = M.shape
    col = torch.arange(N, device=M.device)[None, :]
    is_cur = col == cur[:, None]
    proj_cpu = cpu_load[None, :] + torch.where(is_cur, 0.0, c_cpu[:, None])
    proj_pct = proj_cpu / cap[None, :] * 100.0
    score = (
        M - lam * proj_pct
        - overload_weight * torch.clamp_min(proj_pct - 100.0, 0.0)
    )
    if move_pen is not None:
        anchor = cur if home is None else home
        score = score - torch.where(col == anchor[:, None], 0.0, move_pen[:, None])
    if noise is not None:
        score = score + noise
    if enforce_capacity:
        proj_mem = mem_load[None, :] + torch.where(is_cur, 0.0, c_mem[:, None])
        fits = (proj_cpu <= cap[None, :]) & (proj_mem <= mem_cap[None, :])
        feasible = (fits | is_cur) & node_valid[None, :]
    else:
        feasible = node_valid[None, :].expand(C, N)
    masked = torch.where(feasible, score, _NEG_INF)
    prop = first_argmax(masked)
    prop_l = prop.long()
    prop_score = masked.gather(1, prop_l[:, None])[:, 0]
    cur_score = score.gather(1, cur.long()[:, None])[:, 0]
    gain = prop_score - cur_score
    wants = valid_c & (gain > 0) & (prop != cur)
    if enforce_capacity:
        admitted = pairwise_admission(
            gain, prop, wants, c_cpu, c_mem,
            cap[prop_l] - cpu_load[prop_l] - c_cpu,
            mem_cap[prop_l] - mem_load[prop_l] - c_mem,
        )
    else:
        admitted = wants
    return torch.where(admitted, prop, cur.to(prop.dtype)), admitted


def neighbor_mass_plain(W, assign, svc_valid, block_ids, *, num_nodes, block_b):
    """Plain version of the mass kernel: the chunk's W rows times the
    one-hot occupancy, as a float32 product (a bf16 product would round M
    back to bf16)."""
    ids = (block_ids.long()[:, None] * block_b
           + torch.arange(block_b, device=W.device)[None, :]).reshape(-1)
    col = torch.arange(num_nodes, device=W.device)[None, :]
    X = ((assign[:, None] == col) & svc_valid[:, None]).to(torch.float32)
    return W[ids].to(torch.float32) @ X


def admission_plain(
    prop, gain, wants, slack_cpu, slack_mem, cur, valid_c, c_cpu, c_mem, *,
    num_nodes, enforce_capacity, block_c, x_dtype, emit_x_rows,
):
    """Plain version of the admission kernel: :func:`pairwise_admission`,
    then the one-hot occupancy rows (or None) and the per-node net load
    deltas, accumulated tile by tile in tile order as the JAX package's
    kernel does. (The CUDA kernel sums in another fixed order, over rows
    sorted by target; the two agree exactly for integer-valued loads.)
    Returns ``(new_node, admitted, x_rows, d_cpu, d_mem)``."""
    C = prop.shape[0]
    wants_b = wants != 0
    if enforce_capacity:
        admitted = pairwise_admission(gain, prop, wants_b, c_cpu, c_mem, slack_cpu, slack_mem)
    else:
        admitted = wants_b
    new_node = torch.where(admitted, prop, cur.to(prop.dtype)).to(torch.int32)
    col = torch.arange(num_nodes, device=prop.device)[None, :]
    d_cpu = torch.zeros(num_nodes, dtype=torch.float32, device=prop.device)
    d_mem = torch.zeros_like(d_cpu)
    for t0 in range(0, C, block_c):
        sl = slice(t0, min(t0 + block_c, C))
        is_new = col == new_node[sl, None]
        is_old = col == cur[sl, None]
        for d, per_svc in ((d_cpu, c_cpu), (d_mem, c_mem)):
            a = torch.where(admitted[sl], per_svc[sl], 0.0)[:, None]
            d += torch.sum(torch.where(is_new, a, 0.0) - torch.where(is_old, a, 0.0), dim=0)
    x_rows = None
    if emit_x_rows:
        x_rows = ((col == new_node[:, None]) & valid_c[:, None]).to(x_dtype)
    return new_node, admitted, x_rows, d_cpu, d_mem


# ------------------------------------------------------------ kernel wrappers


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors (the kernel path), False for CPU tensors (the
    plain path); anything else — mixed devices included — raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def _check_lengths(tensors, n: int, what: str) -> None:
    got = [t.numel() for t in tensors]
    if any(g != n for g in got):
        raise ValueError(f"{what} must hold {n} entries each, got {got}")


def _ptr(t: torch.Tensor) -> int:
    if not t.is_contiguous():
        raise ValueError("kernel operands must be contiguous")
    return t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _device_scalar(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """One value a kernel reads from device memory: a one-element tensor on
    ``device`` as it is (a view into a solver's seed or temperature table),
    or a Python number written there by a fill kernel — never a host copy,
    so a captured graph may hold it (with its value fixed)."""
    if isinstance(x, torch.Tensor):
        if x.numel() != 1 or x.device != device:
            raise ValueError(f"a kernel scalar must be one value on {device}, got "
                             f"{tuple(x.shape)} on {x.device}")
        return x.reshape(()).to(dtype).contiguous()
    if dtype == torch.int32:
        x = (int(x) + 2**31) % 2**32 - 2**31  # the seed's u32 bits
    return torch.full((), x, dtype=dtype, device=device)


def _tile_seed(seed, t: int):
    """Seed of score tile ``t``: ``seed + t`` (a number or a 0-d tensor)."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(()).long() + t
    return int(seed) + t


def _flag(t: torch.Tensor) -> torch.Tensor:
    """One byte per entry, nonzero where true, as the kernels read flags: a
    bool (or uint8) tensor is passed as it is, with no conversion copy."""
    if t.dtype in (torch.bool, torch.uint8):
        return t.contiguous()
    return (t != 0).to(torch.uint8)


_MASS_WARPS = 4  # rows of M per CUDA block: kLongRowWarps of csrc/sparse_row.cuh


def mass_geometry(C: int, SP: int, w_itemsize: int) -> tuple[int, int]:
    """Launch geometry of the dense mass kernel for C rows of M over W rows
    of SP elements of ``w_itemsize`` bytes: ``(blocks, shared bytes)``. One
    warp writes each row, 4 rows a block; shared memory holds one list per
    warp of up to 32 vectors' worth of products (8 bytes each), whatever N
    is. The launcher checks both."""
    if w_itemsize not in (2, 4):
        raise ValueError(f"W must be bf16 or f32, got {w_itemsize}-byte elements")
    vec = 16 // w_itemsize
    if C <= 0 or C % _MASS_WARPS:
        raise ValueError(f"C={C} must be a positive multiple of {_MASS_WARPS}")
    if SP <= 0 or SP % vec:
        raise ValueError(f"SP={SP} must be a positive multiple of {vec} (whole 16-byte vectors)")
    return C // _MASS_WARPS, _MASS_WARPS * 32 * vec * 8


def fused_neighbor_mass(
    W,          # [SP, SP] pair weights, canonical service order (bf16 or f32)
    assign,     # i32[SP] current node per service
    svc_valid,  # bool[SP]
    block_ids,  # i32[KB]: which block_b-row blocks of W form this chunk
    *,
    num_nodes: int,
    block_b: int = 256,
    block_j: int = 1024,
):
    """``M = W[chunk rows] @ (one_hot(assign)·valid)`` where the chunk's
    rows are the ``block_ids`` ``block_b``-row blocks of the canonical W;
    the occupancy matrix is never built on the kernel path. Returns
    ``f32[KB·block_b, N]``. ``block_j`` is the TPU kernel's contraction
    tile, kept for its divisibility contract. On the card each row's
    products are added in a fixed order, so M is the same on every run for
    any weights (and equal to the plain version for integer ones)."""
    SP = W.shape[0]
    N = int(num_nodes)
    KB = block_ids.shape[0]
    if SP % block_j or SP % block_b:
        # flooring a tiling would silently DROP trailing service
        # columns/rows from the contraction — wrong M, no shape error
        raise ValueError(
            f"SP={SP} must be divisible by block_j={block_j} and "
            f"block_b={block_b}"
        )
    if not _on_cuda(W, assign, svc_valid, block_ids):
        return neighbor_mass_plain(
            W, assign, svc_valid, block_ids, num_nodes=N, block_b=block_b
        )
    if W.dtype not in (torch.bfloat16, torch.float32) or W.shape != (SP, SP):
        raise ValueError(f"W must be a square bf16 or f32 matrix, got {W.dtype} {tuple(W.shape)}")
    if W.data_ptr() % 16:
        raise ValueError("W must be 16-byte aligned")
    C = KB * block_b
    blocks, smem = mass_geometry(C, SP, W.element_size())
    assign_i, valid_u, blocks_i = _i32(assign), _flag(svc_valid), _i32(block_ids)
    _check_lengths((assign_i, valid_u), SP, "assign and svc_valid")
    M = torch.empty((C, N), dtype=torch.float32, device=W.device)
    lib = _build.library("mass")
    code = lib.krt_mass_launch(
        W.device.index or 0, _ptr(W), int(W.dtype == torch.bfloat16), _ptr(assign_i),
        _ptr(valid_u), _ptr(blocks_i), SP, N, C, block_b, blocks, smem, _ptr(M),
        _stream(W.device),
    )
    _build.check(lib, code, "fused_neighbor_mass")
    fused_neighbor_mass.launches += 1
    op_work.count(fused_neighbor_mass, *op_work.mass(C, SP, N, W.element_size()))
    return M


fused_neighbor_mass.launches = 0
fused_neighbor_mass.work_ops = fused_neighbor_mass.work_bytes = 0.0


def score_stage_plain(
    M, cur, home, move_pen, c_cpu, c_mem, valid_c, cpu_load, mem_load, cap, mem_cap,
    node_valid, lam, temp, seed, overload_weight, *, enforce_capacity, use_noise,
    use_move_pen, block_c,
):
    """Plain version of the score kernel: :func:`score_core` tile by tile
    (tile t of ``block_c`` rows draws its noise with seed + t)."""
    C = M.shape[0]
    outs = [
        score_core(
            M[t0:t0 + block_c].to(torch.float32), cur[t0:t0 + block_c],
            home[t0:t0 + block_c], move_pen[t0:t0 + block_c], c_cpu[t0:t0 + block_c],
            c_mem[t0:t0 + block_c], valid_c[t0:t0 + block_c],
            cpu_load, mem_load, cap, mem_cap, node_valid,
            lam, overload_weight, temp, _tile_seed(seed, t0 // block_c),
            enforce_capacity=enforce_capacity, use_noise=use_noise,
            use_move_pen=use_move_pen,
        )
        for t0 in range(0, C, block_c)
    ]
    return tuple(torch.cat(xs) for xs in zip(*outs))


def score_stage(
    M, cur, home, move_pen, c_cpu, c_mem, valid_c, cpu_load, mem_load, cap, mem_cap,
    node_valid, lam, temp, seed, overload_weight=0.0, *, enforce_capacity, use_noise,
    use_move_pen, block_c=256,
):
    """The score half of :func:`fused_score_admission` — the wrapper of
    ``csrc/score.cu``. Returns ``(prop i32, gain f32, wants i32,
    slack_cpu f32, slack_mem f32)``, each [C]."""
    C, N = M.shape
    bc = min(block_c, C)
    vecs = (M, cur, home, move_pen, c_cpu, c_mem, valid_c,
            cpu_load, mem_load, cap, mem_cap, node_valid)
    if not _on_cuda(*vecs):
        return score_stage_plain(
            *vecs, lam, temp, seed, overload_weight, enforce_capacity=enforce_capacity,
            use_noise=use_noise, use_move_pen=use_move_pen, block_c=bc,
        )
    _check_lengths(vecs[1:7], C, "row vectors")
    _check_lengths(vecs[7:], N, "node vectors")
    threads, rows, blocks = score_geometry(C, N)
    prop = torch.empty((C,), dtype=torch.int32, device=M.device)
    wants = torch.empty_like(prop)
    gain = torch.empty((C,), dtype=torch.float32, device=M.device)
    slack_cpu = torch.empty_like(gain)
    slack_mem = torch.empty_like(gain)
    ops = (_f32(M), _i32(cur), _i32(home), _f32(move_pen), _f32(c_cpu), _f32(c_mem),
           _flag(valid_c), _f32(cpu_load), _f32(mem_load), _f32(cap), _f32(mem_cap),
           _flag(node_valid))
    vec_ok = N % 4 == 0 and ops[0].data_ptr() % 16 == 0  # 16-byte loads of M's rows
    temp_t = _device_scalar(temp, torch.float32, M.device)
    seed_t = _device_scalar(seed, torch.int32, M.device)
    lib = _build.library("score")
    code = lib.krt_score_launch(
        M.device.index or 0, *(_ptr(t) for t in ops),
        float(lam), float(overload_weight), _ptr(temp_t), _ptr(seed_t), C, N, bc,
        int(enforce_capacity), int(use_noise), int(use_move_pen), threads, rows, blocks,
        int(vec_ok), _ptr(prop), _ptr(gain), _ptr(wants), _ptr(slack_cpu), _ptr(slack_mem),
        _stream(M.device),
    )
    _build.check(lib, code, "score_stage")
    score_stage.launches += 1
    op_work.count(score_stage, *op_work.score(C, N, use_noise))
    return prop, gain, wants, slack_cpu, slack_mem


score_stage.launches = 0
score_stage.work_ops = score_stage.work_bytes = 0.0


def fused_score_admission(
    M,            # f32[C, N] neighbor mass
    cur,          # i32[C] current node per service
    c_cpu,        # f32[C]
    c_mem,        # f32[C]
    valid_c,      # bool[C]
    cpu_load,     # f32[N]
    mem_load,     # f32[N]
    cap,          # f32[N]
    mem_cap,      # f32[N]
    node_valid,   # bool[N]
    lam,          # balance weight
    temp,         # gumbel temperature: a number or a one-element f32 tensor
    seed,         # noise seed for this chunk (tile t uses seed + t): an int
                  # or a one-element i32 tensor
    overload_weight=0.0,
    home=None,    # i32[C] round-start node (move-cost anchor; default cur)
    move_pen=None,  # f32[C] disruption cost charged off-home (default 0)
    *,
    enforce_capacity: bool,
    use_noise: bool,
    block_c: int = 256,
    x_dtype=torch.bfloat16,
    emit_x_rows: bool = True,
):
    """Score kernel then admission kernel (:func:`score_stage`,
    :func:`admission_stage`). Returns ``(new_node i32[C], admitted
    bool[C], x_rows x_dtype[C, N], d_cpu f32[N], d_mem f32[N])``; with
    ``emit_x_rows=False`` the occupancy rows are neither computed nor
    written and the return is ``(new_node, admitted, d_cpu, d_mem)``."""
    C, N = M.shape
    bc = min(block_c, C)
    use_move_pen = move_pen is not None
    if home is None:
        home = cur
    if move_pen is None:
        move_pen = torch.zeros((C,), dtype=torch.float32, device=M.device)
    prop, gain, wants, slack_cpu, slack_mem = score_stage(
        M, cur, home, move_pen, c_cpu, c_mem, valid_c, cpu_load, mem_load, cap, mem_cap,
        node_valid, lam, temp, seed, overload_weight, enforce_capacity=enforce_capacity,
        use_noise=use_noise, use_move_pen=use_move_pen, block_c=bc,
    )
    return admission_stage(
        prop, gain, wants, slack_cpu, slack_mem, cur, valid_c, c_cpu, c_mem,
        num_nodes=N,
        enforce_capacity=enforce_capacity,
        block_c=bc,
        x_dtype=x_dtype,
        emit_x_rows=emit_x_rows,
    )


def score_geometry(C: int, N: int) -> tuple[int, int, int]:
    """Launch geometry of the score body (``csrc/score_core.cuh``) over C
    rows of N nodes: ``(threads, rows per tile, blocks)``. One block scores
    a tile of 1 or 2 rows, each thread owning about 8 of a row's columns (in
    groups of 4), from 32 threads (N up to 256) to 256 (N above 1024). A
    tile takes 2 rows only while that still leaves ``_SCORE_WARPS`` warps in
    the launch (C = 1024 at N = 2000: 512 blocks of 8 warps), and never more
    rows than warps (the fused mass+score kernel writes each row's mass
    with one warp)."""
    if C < 1 or N < 1:
        raise ValueError(f"score tile of {C} rows x {N} nodes: both must be at least 1")
    threads = min(_SCORE_THREADS, max(32, 1 << (-(-N // 8) - 1).bit_length()))
    warps = threads // 32
    rows = 2 if warps >= 2 and -(-C // 2) * warps >= _SCORE_WARPS else 1
    return threads, rows, -(-C // rows)


def admission_geometry(C: int) -> tuple[int, int, int, bool]:
    """Launch geometry of the admission kernel, one CUDA block per chunk of
    C rows: ``(threads, P, work bytes, in shared memory)``. P is the sort
    width (the power of two from C up, at least a warp); up to 1024 rows
    one thread holds each sort slot. The block stages ``20·P + 25·C``
    bytes of sort buffers and row arrays, in shared memory while they fit
    (C up to about 4,000), else in a device-memory scratch of that size."""
    if not 1 <= C < 2**30:
        raise ValueError(f"chunk of {C} rows: the admission kernel takes 1 to 2**30 - 1")
    P = max(32, 1 << (C - 1).bit_length())
    threads = min(1024, P)
    work = -(-(20 * P + 25 * C) // 16) * 16
    return threads, P, work, work + _ADMISSION_STATIC <= _SHARED_BYTES


def admission_operands(prop, gain, wants, slack_cpu, slack_mem, cur, valid_c, c_cpu, c_mem):
    """The admission kernel's nine operands as it reads them: i32 ``prop``,
    ``wants``, ``cur``; f32 ``gain``, slacks and loads; one byte per
    ``valid_c`` flag. For the dtypes the solvers pass (contiguous i32 and
    f32 vectors and a bool ``valid_c``) these are the given tensors
    themselves: no conversion copy reaches the device."""
    return (_i32(prop), _f32(gain), _i32(wants), _f32(slack_cpu), _f32(slack_mem),
            _i32(cur), _flag(valid_c), _f32(c_cpu), _f32(c_mem))


def admission_stage(
    prop, gain, wants, slack_cpu, slack_mem,  # [C] score-stage outputs
    cur, valid_c, c_cpu, c_mem,               # [C] chunk vectors
    *,
    num_nodes: int,
    enforce_capacity: bool,
    block_c: int = 256,
    x_dtype=torch.bfloat16,
    emit_x_rows: bool,
):
    """The admission-race half of :func:`fused_score_admission` — the
    wrapper of ``csrc/admission.cu``, one kernel launch per call.

    ``emit_x_rows`` is keyword-required and has no default: it changes the
    return arity (5-tuple with occupancy rows vs 4-tuple without)."""
    C = prop.shape[0]
    N = int(num_nodes)
    bc = min(block_c, C)
    vecs = (prop, gain, wants, slack_cpu, slack_mem, cur, valid_c, c_cpu, c_mem)
    _check_lengths(vecs, C, "admission operands")
    if _on_cuda(*vecs):
        dev = prop.device
        if emit_x_rows and x_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"x_rows dtype must be bf16 or f32, got {x_dtype}")
        new_node = torch.empty((C,), dtype=torch.int32, device=dev)
        admitted = torch.empty((C,), dtype=torch.bool, device=dev)
        x_rows = torch.empty((C, N), dtype=x_dtype, device=dev) if emit_x_rows else None
        d_cpu, d_mem = _admission_launch(
            admission_operands(*vecs), C, N, enforce_capacity, new_node, admitted, x_rows)
    else:
        new_node, admitted, x_rows, d_cpu, d_mem = admission_plain(
            prop, gain, wants, slack_cpu, slack_mem, cur, valid_c, c_cpu, c_mem,
            num_nodes=N, enforce_capacity=enforce_capacity, block_c=bc, x_dtype=x_dtype,
            emit_x_rows=emit_x_rows,
        )
    if emit_x_rows:
        return new_node, admitted, x_rows, d_cpu, d_mem
    return new_node, admitted, d_cpu, d_mem


def _admission_launch(ops, C: int, N: int, enforce_capacity: bool, new_node, admitted, x_rows,
                      commit=()):
    """One launch of ``csrc/admission.cu`` on the nine operands ``ops`` (a
    commit's ``cur`` None): the per-row outputs or a ``commit`` of
    ``(blocks, assign, cpu_load, mem_load, moves)``. Returns the per-node
    deltas ``(d_cpu, d_mem)``."""
    dev = ops[0].device
    threads, P, work_bytes, in_shared = admission_geometry(C)
    d_cpu = torch.empty((N,), dtype=torch.float32, device=dev)
    d_mem = torch.empty_like(d_cpu)
    work = None if in_shared else torch.empty((work_bytes,), dtype=torch.uint8, device=dev)
    x_kind = 0 if x_rows is None else (1 if x_rows.dtype == torch.bfloat16 else 2)
    opt = lambda t: None if t is None else _ptr(t)  # noqa: E731
    lib = _build.library("admission")
    code = lib.krt_admission_launch(
        dev.index or 0, *(opt(t) for t in ops), C, N, int(enforce_capacity),
        opt(new_node), opt(admitted), _ptr(d_cpu), _ptr(d_mem), opt(x_rows), x_kind, threads,
        P, opt(work), work_bytes, *(_ptr(t) for t in commit),
        *([None] * (5 - len(commit))), _stream(dev),
    )
    _build.check(lib, code, "admission_stage")
    admission_stage.launches += 1
    op_work.count(admission_stage, *op_work.admission(
        C, N, 0 if x_rows is None else x_rows.element_size()))
    return d_cpu, d_mem


admission_stage.launches = 0
admission_stage.work_ops = admission_stage.work_bytes = 0.0


def block_row_ids(blocks: torch.Tensor) -> torch.Tensor:
    """The service ids of a chunk's rows: block ``blocks[i]``'s 256 rows in
    order, block after block. i64[KB·256]."""
    rows = torch.arange(_BLOCK_ROWS, device=blocks.device)
    return (blocks.long()[:, None] * _BLOCK_ROWS + rows).reshape(-1)


def admission_commit_plain(
    prop, gain, wants, slack_cpu, slack_mem, blocks, assign, svc_valid, svc_cpu, svc_mem,
    cpu_load, mem_load, moves, *, num_nodes, enforce_capacity,
):
    """Plain version of :func:`admission_commit`: the chunk's rows gathered
    through ``blocks``, :func:`admission_plain` at 256-row tiles, then the
    commit the kernel makes: ``assign[ids] = new_node``, the deltas added
    onto the loads and the admitted count onto ``moves``, each in place."""
    ids = block_row_ids(blocks)
    new_node, admitted, _, d_cpu, d_mem = admission_plain(
        prop, gain, wants, slack_cpu, slack_mem, assign[ids], svc_valid[ids], svc_cpu[ids],
        svc_mem[ids], num_nodes=num_nodes, enforce_capacity=enforce_capacity,
        block_c=_BLOCK_ROWS, x_dtype=torch.bfloat16, emit_x_rows=False,
    )
    assign[ids] = new_node
    cpu_load.add_(d_cpu)
    mem_load.add_(d_mem)
    moves.add_(admitted.sum())


def admission_commit(
    prop, gain, wants, slack_cpu, slack_mem,  # [C] score-stage outputs, C = KB·256
    blocks,     # i32[KB] the chunk's 256-row blocks (block_row_ids: the rows' services)
    assign,     # i32[S] written in place at the chunk's rows
    svc_valid,  # bool[S]
    svc_cpu,    # f32[S]
    svc_mem,    # f32[S]
    cpu_load,   # f32[N] carried loads, updated in place
    mem_load,   # f32[N]
    moves,      # i64[] move counter, updated in place
    *,
    num_nodes: int,
    enforce_capacity: bool,
):
    """The admission race of one sparse chunk, committed: one launch of
    ``csrc/admission.cu`` that reads the chunk's rows of the service arrays
    through ``blocks`` and writes ``assign[ids] = new_node``, ``cpu_load +=
    d_cpu``, ``mem_load += d_mem`` and ``moves += admitted.sum()`` — what
    :func:`admission_stage` followed by those torch ops gives, bit for bit,
    with no gather or scatter around it. CPU tensors take the plain version
    (:func:`admission_commit_plain`)."""
    C = prop.shape[0]
    N = int(num_nodes)
    KB = blocks.shape[0]
    _check_lengths((prop, gain, wants, slack_cpu, slack_mem), KB * _BLOCK_ROWS, "score outputs")
    _check_lengths((svc_valid, svc_cpu, svc_mem), assign.numel(), "service arrays")
    _check_lengths((cpu_load, mem_load), N, "node loads")
    vecs = (prop, gain, wants, slack_cpu, slack_mem, blocks, assign, svc_valid, svc_cpu,
            svc_mem, cpu_load, mem_load, moves)
    if not _on_cuda(*vecs):
        return admission_commit_plain(*vecs, num_nodes=N, enforce_capacity=enforce_capacity)
    for name, t, dtype in (("assign", assign, torch.int32), ("cpu_load", cpu_load, torch.float32),
                           ("mem_load", mem_load, torch.float32), ("moves", moves, torch.int64)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} is written in place: it must be a contiguous {dtype}, "
                             f"got {t.dtype}")
    if moves.numel() != 1:
        raise ValueError(f"moves must be one counter, got {tuple(moves.shape)}")
    ops = (_i32(prop), _f32(gain), _i32(wants), _f32(slack_cpu), _f32(slack_mem), None,
           _flag(svc_valid), _f32(svc_cpu), _f32(svc_mem))
    _admission_launch(ops, C, N, enforce_capacity, None, None, None,
                      (_i32(blocks), assign, cpu_load, mem_load, moves))
