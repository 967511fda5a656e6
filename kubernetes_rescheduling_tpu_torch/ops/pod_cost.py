"""The general branch of the sparse solve's input cost: kernel 9
(``csrc/pod_cost.cu``) beside its plain twin.

``solver/sparse_solver.py``'s :func:`sparse_pod_comm_cost` prices a
placement whose replicas may be split across nodes. For each directed edge
(s, t, w) of the sparse graph's COO list it needs ``w · max(rv_s·rv_t −
kept, 0)``, where ``kept = Σ_n cnt[s, n]·cnt[t, n]`` counts the pod pairs of
the two slots that share a node and ``rv`` is a slot's placed pods.
:func:`pod_pair_cross` returns that f32[E2]:

- on CUDA tensors, kernel 9 over the pods' run lists (:func:`run_lists`):
  one sort of the placed pods' keys ``slot·(N+1) + node`` and each slot's
  range in them. Memory O(P + SP + E2); an edge's work
  O(min(rv_s, rv_t)·log max(rv_s, rv_t));
- on CPU tensors, :func:`pod_pair_cross_plain`: the dense count grid of
  (SP+1) × (N+1) and its rows gathered, multiplied and summed an edge chunk
  at a time. That is the JAX package's form and the oracle the kernel is
  held to; it moves (SP+1)·(N+1) counts and gathers 2·N of them an edge.

``kept`` and ``rv_s·rv_t`` are exact integers in f32 below 2^24, and the
kernel rounds each f32 operation as the twin's torch ops do, so the two are
``torch.equal``. No JAX Pallas kernel corresponds to this one (the JAX form
is plain XLA behind ``lax.cond``). The wrapper counts its launches in
``launches`` and its work in ``work_ops`` / ``work_bytes`` (``ops/work.py``).
"""

from __future__ import annotations

import torch

from kubernetes_rescheduling_tpu_torch.core.state import _count
from kubernetes_rescheduling_tpu_torch.ops import _build
from kubernetes_rescheduling_tpu_torch.ops import work as op_work
from kubernetes_rescheduling_tpu_torch.ops.fused_admission import (
    _check_lengths,
    _on_cuda,
    _ptr,
    _stream,
)

EDGE_CHUNK = 16384  # edges whose grid rows the plain twin gathers at a time


def pod_pair_cross_plain(slot, node, placed, edges_src, edges_dst, edges_w,
                         num_slots: int, num_nodes: int) -> torch.Tensor:
    """Kernel 9's plain twin: the per-edge terms from the dense count grid.
    ``slot`` and ``node`` (i32 or i64[P]) place each pod; only pods with
    ``placed`` (bool[P]) count, and those must have ``0 <= slot <
    num_slots`` and ``0 <= node < num_nodes``. Returns f32[E2]."""
    SP, N = num_slots, num_nodes
    flat = torch.where(placed, slot.long() * (N + 1) + node.long(), SP * (N + 1) + N)
    cnt = _count(flat, (SP + 1) * (N + 1)).view(SP + 1, N + 1)
    cnt = cnt[:SP, :N].to(torch.float32)
    rv = cnt.sum(dim=1)
    out = torch.empty_like(edges_w)
    for e0 in range(0, edges_w.shape[0], EDGE_CHUNK):
        s = edges_src[e0:e0 + EDGE_CHUNK].long()
        t = edges_dst[e0:e0 + EDGE_CHUNK].long()
        kept = torch.sum(cnt[s] * cnt[t], dim=1)
        cross = torch.clamp_min(rv[s] * rv[t] - kept, 0.0)
        out[e0:e0 + EDGE_CHUNK] = edges_w[e0:e0 + EDGE_CHUNK] * cross
    return out


def run_lists(slot, node, placed, num_slots: int, num_nodes: int):
    """The pods' run lists, kernel 9's input: ``(keys i64[P], offs
    i64[num_slots + 1])``. ``keys`` holds every placed pod's ``slot·(N+1) +
    node`` in ascending order, each unplaced pod's ``num_slots·(N+1)`` after
    them; slot s's pods are ``keys[offs[s]:offs[s + 1]]``, sorted by node.
    One sort and one search, at static shapes: nothing is read back."""
    n1 = num_nodes + 1
    key = torch.where(placed, slot.long() * n1 + node.long(), num_slots * n1)
    keys = torch.sort(key).values
    starts = torch.arange(num_slots + 1, dtype=torch.int64, device=keys.device) * n1
    return keys, torch.searchsorted(keys, starts)


def pod_pair_cross(slot, node, placed, edges_src, edges_dst, edges_w,
                   num_slots: int, num_nodes: int) -> torch.Tensor:
    """Each directed edge's ``w · max(rv_s·rv_t − kept, 0)``, f32[E2]
    (:func:`pod_pair_cross_plain` states the inputs). Kernel 9 on CUDA
    tensors, the plain twin on CPU tensors; anything else raises.
    ``edges_src`` and ``edges_dst`` are i32[E2] slot ids below
    ``num_slots``; they are not read back."""
    if not _on_cuda(slot, node, placed, edges_src, edges_dst, edges_w):
        return pod_pair_cross_plain(slot, node, placed, edges_src, edges_dst, edges_w,
                                    num_slots, num_nodes)
    E2 = edges_w.shape[0]
    if edges_src.dtype != torch.int32 or edges_dst.dtype != torch.int32:
        raise ValueError(f"edge ids must be i32, got {edges_src.dtype} and {edges_dst.dtype}")
    if edges_w.dtype != torch.float32:
        raise ValueError(f"edges_w must be f32, got {edges_w.dtype}")
    _check_lengths((edges_src, edges_dst), E2, "edges_src and edges_dst")
    _check_lengths((node, placed), slot.numel(), "node and placed")
    out = torch.empty_like(edges_w)
    if E2 == 0:
        return out
    keys, offs = run_lists(slot, node, placed, num_slots, num_nodes)
    dev = edges_w.device
    lib = _build.library("pod_cost")
    code = lib.krt_pod_cross_launch(
        dev.index or 0, _ptr(keys), _ptr(offs), _ptr(edges_src), _ptr(edges_dst),
        _ptr(edges_w), E2, num_nodes + 1, _ptr(out), _stream(dev),
    )
    _build.check(lib, code, "pod_pair_cross")
    pod_pair_cross.launches += 1
    op_work.count(pod_pair_cross, *op_work.pod_cross(E2, num_slots, keys.numel()))
    return out


pod_pair_cross.launches = 0
pod_pair_cross.work_ops = pod_pair_cross.work_bytes = 0.0
