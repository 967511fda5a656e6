"""The chunk's swap phase on the card: kernels 7 and 8 (``csrc/swap.cu``).

The plain twin is ``solver/swap.py``'s :func:`chunk_swap` followed by its
:func:`commit_swaps`, which stay the CPU path and the reference these
kernels are held to; the JAX package has no kernel here. The solvers take
the kernels where they take kernels 1–6 (``kernel_lowering``), on CUDA and
at a chunk of at most 1,024 rows (:func:`takes_kernels`).

- :func:`swap_desire` → ``swap_desire_kernel``: each row's exchange desire,
  the key of the top-k candidate subset;
- :func:`swap_decide` → ``swap_decide_kernel``: the subset by rank counting
  (:func:`rank_select` is that reformulation in plain PyTorch),
  ``swap_decisions`` on it with the cross-swap coupling in four gathers
  (:func:`interaction_gather`), the full-width results, the new per-node
  loads (``commit_swaps``'s, bit for bit) and the chunk's rows of the
  assignment.

Both read the chunk's rows through its ids from the solver's service
arrays (assignment, validity, demands, move bill and anchor), as the
solvers' plain path gathers them before ``chunk_swap``.

Unlike the wrappers of kernels 1–6, these take CUDA tensors only and raise
on anything else: the solvers call :func:`chunk_swap` itself off the card.
Each wrapper counts its launches in ``launches`` and its work in
``work_ops`` / ``work_bytes`` (``ops/work.py``).
"""

from __future__ import annotations

import torch

from kubernetes_rescheduling_tpu_torch.ops import _build
from kubernetes_rescheduling_tpu_torch.ops import work as op_work
from kubernetes_rescheduling_tpu_torch.ops.fused_admission import _ptr, _stream

MAX_ROWS = 1024  # C and k at most: one thread-block cluster holds the chunk

# ---------------------------------------------------------------- plain math


def rank_select(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel 8's top-k: ``rank_i = #{j: key_j > key_i} + #{j < i: key_j ==
    key_i}`` and ``sel[rank_i] = i`` for ``rank_i < k`` — the order of
    ``torch.sort(keys, descending=True, stable=True).indices[:k]``, since
    compares do not depend on an order. i64[min(k, C)]."""
    C = keys.shape[0]
    idx = torch.arange(C, device=keys.device)
    ahead = (keys[None, :] > keys[:, None]) | (
        (keys[None, :] == keys[:, None]) & (idx[None, :] < idx[:, None])
    )
    sel = torch.empty_like(idx)
    sel[ahead.sum(dim=1)] = idx
    return sel[:k]


def interaction_gather(A: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Kernel 8's cross-swap coupling: ``I[s, t] = (A[s, t] + A[p_s, t]) +
    (A[s, p_t] + A[p_s, p_t])``. It equals ``swap_decisions``' ``(B @ A) @
    B.T`` with ``B = I + one_hot(p)`` bit for bit: each entry of either
    product is a sum in which at most two terms are not zero, each an exact
    product of A by 0, 1 or 2, so no rounding but the one add remains."""
    p = p.long()
    Ap = A[p]
    return (A + Ap) + (A[:, p] + Ap[:, p])


def takes_kernels(use_kernels: bool, device, C: int) -> bool:
    """Whether a chunk of ``C`` rows takes kernels 7 and 8: under the
    kernel lowering, on CUDA, at ``2 <= C <= MAX_ROWS`` (every chunk the
    solvers size themselves)."""
    return use_kernels and torch.device(device).type == "cuda" and 2 <= C <= MAX_ROWS


# ------------------------------------------------------------ kernel wrappers


def _operand(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_card(tensors) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(
            f"the swap kernels take tensors on one CUDA device, got {sorted(map(str, devs))}; "
            "off the card the solvers run solver/swap.py's chunk_swap")
    return devs.pop()


def _rows(M: torch.Tensor, k: int) -> tuple[int, int]:
    if not 1 <= int(k) <= MAX_ROWS:
        raise ValueError(f"k={k} must lie in [1, {MAX_ROWS}]")
    if M.dim() != 2 or not 1 <= M.shape[0] <= MAX_ROWS:
        raise ValueError(f"M must be [C, N] with C <= {MAX_ROWS}, got {tuple(M.shape)}")
    C, N = M.shape
    _operand("M", M, torch.float32, (C, N))
    return C, N


def _services(assign, ids, svc_valid, moved, node_valid, pen, home, C: int, N: int,
              demands=()) -> list[torch.Tensor]:
    """Checks the solver's service arrays the kernels read the chunk's rows
    from, and returns them."""
    if assign.dtype != torch.int32 or assign.dim() != 1 or not assign.is_contiguous():
        raise ValueError(f"assign must be a contiguous i32 vector, got {assign.dtype} "
                         f"{tuple(assign.shape)}")
    S = assign.shape[0]
    _operand("ids", ids, torch.int64, (C,))
    _operand("svc_valid", svc_valid, torch.bool, (S,))
    _operand("moved", moved, torch.bool, (C,))
    _operand("node_valid", node_valid, torch.bool, (N,))
    for name, t in demands:
        _operand(name, t, torch.float32, (S,))
    out = [assign, ids, svc_valid, moved, node_valid, *(t for _, t in demands)]
    if (pen is None) != (home is None):
        raise ValueError("pen and home come together (move-cost pricing) or not at all")
    if pen is not None:
        _operand("pen", pen, torch.float32, (S,))
        _operand("home", home, torch.int32, (S,))
        out += [pen, home]
    return out


def _ptr_or_none(t):
    return None if t is None else _ptr(t)


def swap_desire(M, assign, ids, svc_valid, moved, node_valid, pen, home,
                k: int) -> torch.Tensor:
    """Kernel 7: each chunk row's exchange desire, ``chunk_swap``'s sort
    key: the best mass anywhere less the mass at the current node, less the
    move bill on the anchor; -inf where the row is not eligible. ``M``
    f32[C, N]; the chunk's rows are the services ``ids`` (i64[C]) of
    ``assign`` (i32[S]), ``svc_valid`` (bool[S]) and, with move-cost
    pricing, ``pen`` (f32[S]) and ``home`` (i32[S]), else both None;
    ``moved`` (bool[C]): the rows the chunk's single phase moved;
    ``node_valid`` (bool[N]). Returns f32[C], left unwritten where
    ``k >= C`` (the subset is then the whole chunk)."""
    C, N = _rows(M, k)
    ops = _services(assign, ids, svc_valid, moved, node_valid, pen, home, C, N)
    dev = _on_card([M, *ops])
    keys = torch.empty((C,), dtype=torch.float32, device=dev)
    lib = _build.library("swap")
    code = lib.krt_swap_desire_launch(
        dev.index or 0, _ptr(M), _ptr(assign), _ptr(ids), _ptr(svc_valid), _ptr(moved),
        _ptr(node_valid), _ptr_or_none(pen), _ptr_or_none(home), C, N, int(k),
        int(N % 4 == 0 and M.data_ptr() % 16 == 0), _ptr(keys), _stream(dev),
    )
    _build.check(lib, code, "swap_desire")
    swap_desire.launches += 1
    op_work.count(swap_desire, *op_work.swap_desire(C, N, int(k)))
    return keys


swap_desire.launches = 0
swap_desire.work_ops = swap_desire.work_bytes = 0.0


def swap_decide(
    M,           # f32[C, N] chunk-start neighbor mass
    keys,        # f32[C] from swap_desire
    W,           # bf16 or f32 [R, R'] pair weights
    w_ids,       # i64[C]: row i's weights are W[w_ids[i], w_ids[j]]; None: W[i, j]
    assign,      # i32[S], the chunk's rows written: assign[ids] = new_node
    ids,         # i64[C] the chunk's services
    svc_valid,   # bool[S]
    moved,       # bool[C] moved by the chunk's single phase
    node_valid,  # bool[N]
    svc_cpu,     # f32[S]
    svc_mem,     # f32[S]
    cpu_load,    # f32[N]
    mem_load,    # f32[N]
    cap,         # f32[N] budget-scaled CPU capacity
    mem_cap,     # f32[N] memory budget, inf sanitized (BIG_CAP)
    lam,
    ow,
    pen,         # f32[S], with home: move-cost pricing; None: off
    home,        # i32[S] round-start anchors
    k: int,
    *,
    enforce_capacity: bool,
):
    """Kernel 8: the ``min(k, C)`` most eager rows, ``swap_decisions`` on
    them, and the results at full width: ``(new_node i32[C], swapped
    bool[C], n_swaps i64[], cpu_load f32[N], mem_load f32[N])`` — what
    ``chunk_swap`` and then ``commit_swaps`` return — with ``assign[ids] =
    new_node`` written in place. Index values (``w_ids``, ``ids``) must lie
    inside their tensors; they are not read back."""
    C, N = _rows(M, k)
    k = min(int(k), C)
    _operand("keys", keys, torch.float32, (C,))
    nodes = [("cpu_load", cpu_load), ("mem_load", mem_load), ("cap", cap), ("mem_cap", mem_cap)]
    for name, t in nodes:
        _operand(name, t, torch.float32, (N,))
    ops = _services(assign, ids, svc_valid, moved, node_valid, pen, home, C, N,
                    (("svc_cpu", svc_cpu), ("svc_mem", svc_mem)))
    if W.dtype not in (torch.bfloat16, torch.float32) or W.dim() != 2:
        raise ValueError(f"W must be a bf16 or f32 matrix, got {W.dtype} {tuple(W.shape)}")
    _operand("W", W, W.dtype, tuple(W.shape))
    if w_ids is None:
        if W.shape[0] < C or W.shape[1] < C:
            raise ValueError(f"W must cover the chunk's {C} rows and columns, got "
                             f"{tuple(W.shape)}")
    else:
        _operand("w_ids", w_ids, torch.int64, (C,))
        ops.append(w_ids)
    dev = _on_card([M, keys, W, *ops, *(t for _, t in nodes)])
    new_node = torch.empty((C,), dtype=torch.int32, device=dev)
    swapped = torch.empty((C,), dtype=torch.bool, device=dev)
    n_swaps = torch.empty((), dtype=torch.int64, device=dev)
    cpu_out = torch.empty_like(cpu_load)
    mem_out = torch.empty_like(mem_load)
    lib = _build.library("swap")
    code = lib.krt_swap_decide_launch(
        dev.index or 0, _ptr(M), N, _ptr(keys), _ptr(W), 1 if W.dtype == torch.bfloat16 else 2,
        W.shape[1], _ptr_or_none(w_ids), _ptr(assign), _ptr(ids), _ptr(svc_valid), _ptr(moved),
        _ptr(node_valid), _ptr(svc_cpu), _ptr(svc_mem), _ptr(cpu_load), _ptr(mem_load),
        _ptr(cap), _ptr(mem_cap), float(lam), float(ow), _ptr_or_none(pen), _ptr_or_none(home),
        C, k, int(enforce_capacity), _ptr(new_node), _ptr(swapped), _ptr(n_swaps),
        _ptr(cpu_out), _ptr(mem_out), _stream(dev),
    )
    _build.check(lib, code, "swap_decide")
    swap_decide.launches += 1
    op_work.count(swap_decide, *op_work.swap_decide(C, N, k, W.element_size()))
    return new_node, swapped, n_swaps, cpu_out, mem_out


swap_decide.launches = 0
swap_decide.work_ops = swap_decide.work_bytes = 0.0


def chunk_swap_kernels(
    M, W, w_ids, assign, ids, svc_valid, moved, node_valid, svc_cpu, svc_mem, cpu_load,
    mem_load, cap, mem_cap_s, lam, ow, pen, home, k, *, enforce_capacity,
):
    """A solver chunk's swap phase on the card in two launches: the chunk's
    rows gathered from the service arrays through ``ids``, ``chunk_swap``,
    ``commit_swaps`` and ``assign[ids] = new_node``. The pair weights are
    read from ``W`` through ``w_ids`` at the subset's rows and columns only.
    Returns ``(new_node, swapped, n_swaps, cpu_load, mem_load)``."""
    keys = swap_desire(M, assign, ids, svc_valid, moved, node_valid, pen, home, k)
    return swap_decide(M, keys, W, w_ids, assign, ids, svc_valid, moved, node_valid, svc_cpu,
                       svc_mem, cpu_load, mem_load, cap, mem_cap_s, lam, ow, pen, home, k,
                       enforce_capacity=enforce_capacity)
