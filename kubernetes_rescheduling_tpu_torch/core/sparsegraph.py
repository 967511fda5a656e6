"""Sparse service-communication graph — the port of
``kubernetes_rescheduling_tpu.core.sparsegraph``.

The dense solver keeps pair weights as an SP×SP matrix (≈ 6 bytes per
pair), which its budget check refuses past ~46k services. The power-law
meshes run at mean degree ~4, so the adjacency is almost all zeros; this
form stores it the way the solver consumes it:

**Degree-sorted block-local adjacency.** Services are relabeled by
descending neighbor count and grouped into blocks of ``BLOCK_R = 256``
rows (the solver's chunk-composition granularity). Each block keeps a
small dense matrix over its own distinct neighbor set:

    w_local[:, toff_b·bu : (toff_b + ntiles_b)·bu]   pair weights
    u_ids[the same columns]                          sorted-space neighbor ids

so the neighbor mass of a block contracts over its few hundred neighbors,
not over all SP services (``ops/sparse_mass.py``). Regular blocks share a
uniform width ``u_reg = reg_tiles·bu``; wider ones become *hub blocks*
with ragged widths. A trailing all-zero strip backs the dummy blocks the
solver pads chunks with. The exact objective is a cut sum over the
symmetric COO edge list stored beside it.

:func:`from_edges` is host numpy, operation for operation the JAX
package's, so one edge list builds identical arrays in both packages; only
the finished arrays become tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch.core.state import CommGraph

BLOCK_R = 256  # rows per block — equals the solver's COMPOSITION_BLOCK


@dataclass(frozen=True)
class SparseCommGraph:
    """Block-local sparse pair-weight storage (see module docstring).

    Ids in the tensors are *sorted-space* (degree-sorted, padded to
    ``SP = NB·256``); ``perm``/``inv`` map to and from the original service
    ids of ``ClusterState.pod_service`` and ``CommGraph``. The tuple and
    int fields are static metadata, known on the host."""

    w_local: torch.Tensor        # f32[256, TU] column-concatenated block strips
    u_ids: torch.Tensor          # i32[TU] neighbor id per local column; SP = padding
    edges_src: torch.Tensor      # i32[E2] symmetric COO list (each edge twice)
    edges_dst: torch.Tensor      # i32[E2]
    edges_w: torch.Tensor        # f32[E2]
    perm: torch.Tensor           # i32[SP] sorted slot -> original id (S = padding)
    inv: torch.Tensor            # i32[S] original id -> sorted slot
    service_valid: torch.Tensor  # bool[SP]
    # original-space dense adjacency, kept only for single-block graphs
    # (≤ 256 services), where the solver delegates to the dense form
    dense_adj: torch.Tensor | None = None
    block_toff: tuple[int, ...] = ()     # per block: first column tile (units of bu)
    block_ntiles: tuple[int, ...] = ()   # per block: tile count
    hub_blocks: tuple[int, ...] = ()
    regular_blocks: tuple[int, ...] = ()
    zero_toff: int = 0
    bu: int = 512
    reg_tiles: int = 2
    num_services: int = 0
    names: tuple[str, ...] = ()
    # every pair weight an integer: the mass kernels' unordered sums are
    # then exact (see ops/csrc/sparse_tile.cuh), so the solver runs them
    integral_weights: bool = False

    @property
    def sp(self) -> int:
        """Padded sorted-space service count (NB·256)."""
        return int(self.perm.shape[0])

    @property
    def num_blocks(self) -> int:
        return self.sp // BLOCK_R

    @property
    def u_reg(self) -> int:
        """Uniform column width of regular blocks."""
        return self.reg_tiles * self.bu

    @property
    def device(self) -> torch.device:
        return self.w_local.device

    def replace(self, **changes) -> "SparseCommGraph":
        return dataclasses.replace(self, **changes)

    def weight_bytes(self) -> int:
        """Live bytes of the pair-weight storage (the f32 strips plus the
        solver's 2-byte matmul copy) — what the dense form's budget check
        compares against SP²·6."""
        return int(self.w_local.numel()) * 6

    def to_dense(self) -> CommGraph:
        """Dense adjacency in ORIGINAL id space (small graphs, parity
        tests), rebuilt from the COO list, on the graph's device."""
        S = self.num_services
        adj = np.zeros((S, S), dtype=np.float32)
        src = self.edges_src.cpu().numpy()
        dst = self.edges_dst.cpu().numpy()
        w = self.edges_w.cpu().numpy()
        perm = self.perm.cpu().numpy()
        osrc, odst = perm[src], perm[dst]
        keep = (osrc < S) & (odst < S)
        adj[osrc[keep], odst[keep]] = w[keep]
        return CommGraph(
            adj=torch.as_tensor(adj, device=self.device),
            service_valid=torch.ones((S,), dtype=torch.bool, device=self.device),
            names=self.names,
            integral_weights=self.integral_weights,
        )


def from_edges(
    src,
    dst,
    w,
    num_services: int,
    *,
    names: tuple[str, ...] = (),
    bu: int = 512,
    reg_tiles: int = 2,
    degree_sort: bool = True,
    symmetric_input: bool = False,
    device: str | torch.device | None = DEFAULT_DEVICE,
) -> SparseCommGraph:
    """Build from an edge list in original id space.

    ``src/dst/w`` are directed edges (symmetrized here, duplicate pairs
    accumulated, self-loops dropped) unless ``symmetric_input`` says the
    list already carries each undirected edge twice. ``degree_sort=False``
    keeps the original ids (identity relabeling)."""
    dev = resolve_device(device)
    S = int(num_services)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.asarray(w, dtype=np.float64)
    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]
    if not symmetric_input:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    # accumulate duplicate pairs into one weight
    pair = src * S + dst
    order = np.argsort(pair, kind="stable")
    pair, src, dst, w = pair[order], src[order], dst[order], w[order]
    _, first = np.unique(pair, return_index=True)
    w = np.add.reduceat(w, first) if len(first) else w
    src, dst = src[first], dst[first]

    # distinct-neighbor count drives a block's width: sort on it so the
    # hub rows cluster into a few (ragged) hub blocks
    deg = np.bincount(src, minlength=S)
    if degree_sort:
        order = np.argsort(-deg, kind="stable").astype(np.int64)
    else:
        order = np.arange(S, dtype=np.int64)
    pos = np.empty(S, dtype=np.int64)
    pos[order] = np.arange(S)

    NB = max(1, -(-S // BLOCK_R))
    SP = NB * BLOCK_R
    rs = pos[src]
    rt = pos[dst]

    u_reg = reg_tiles * bu
    strips: list[np.ndarray] = []
    uids: list[np.ndarray] = []
    toff: list[int] = []
    ntiles: list[int] = []
    hub: list[int] = []
    regular: list[int] = []
    # edges sorted by row block for one-pass slicing
    border = np.argsort(rs // BLOCK_R, kind="stable")
    rs_b, rt_b, w_b = rs[border], rt[border], w[border]
    block_of = rs_b // BLOCK_R
    starts = np.searchsorted(block_of, np.arange(NB))
    ends = np.searchsorted(block_of, np.arange(NB), side="right")
    col_cursor = 0
    for b in range(NB):
        s, e = starts[b], ends[b]
        tgts = rt_b[s:e]
        u = np.unique(tgts)  # ascending sorted-space ids
        width = max(u_reg, -(-max(len(u), 1) // bu) * bu)
        wl = np.zeros((BLOCK_R, width), dtype=np.float32)
        if len(u):
            lcol = np.searchsorted(u, tgts)
            np.add.at(wl, (rs_b[s:e] % BLOCK_R, lcol), w_b[s:e])
        ui = np.full((width,), SP, dtype=np.int32)
        ui[: len(u)] = u
        strips.append(wl)
        uids.append(ui)
        toff.append(col_cursor // bu)
        nt = width // bu
        ntiles.append(nt)
        (hub if nt > reg_tiles else regular).append(b)
        col_cursor += width
    # trailing zero strip for the solver's dummy (chunk-padding) blocks
    strips.append(np.zeros((BLOCK_R, u_reg), dtype=np.float32))
    uids.append(np.full((u_reg,), SP, dtype=np.int32))
    zero_toff = col_cursor // bu

    perm = np.full((SP,), S, dtype=np.int32)
    perm[:S] = order
    valid = np.zeros((SP,), dtype=bool)
    valid[:S] = True

    dense_adj = None
    if NB <= 1:
        da = np.zeros((S, S), dtype=np.float32)
        da[src, dst] = w  # symmetric list: both directions present
        dense_adj = torch.as_tensor(da, device=dev)

    def t(a):
        return torch.as_tensor(a, device=dev)

    return SparseCommGraph(
        w_local=t(np.concatenate(strips, axis=1)),
        u_ids=t(np.concatenate(uids)),
        edges_src=t(rs.astype(np.int32)),
        edges_dst=t(rt.astype(np.int32)),
        edges_w=t(w.astype(np.float32)),
        perm=t(perm),
        inv=t(pos.astype(np.int32)),
        service_valid=t(valid),
        dense_adj=dense_adj,
        block_toff=tuple(toff),
        block_ntiles=tuple(ntiles),
        hub_blocks=tuple(hub),
        regular_blocks=tuple(regular),
        zero_toff=int(zero_toff),
        bu=int(bu),
        reg_tiles=int(reg_tiles),
        num_services=S,
        names=tuple(names),
        integral_weights=integral(w),
    )


def integral(w) -> bool:
    """Whether every weight is an integer once stored as f32."""
    w32 = np.asarray(w, dtype=np.float32)
    return bool(np.all(w32 == np.round(w32)))


def from_comm_graph(
    graph: CommGraph,
    *,
    bu: int = 512,
    reg_tiles: int = 2,
    degree_sort: bool = True,
    device: str | torch.device | None = None,
) -> SparseCommGraph:
    """Convert a dense CommGraph (its upper triangle; the adjacency is
    symmetric by construction). The result lives on ``device``, by default
    the graph's own."""
    adj = graph.adj.cpu().numpy()
    valid = graph.service_valid.cpu().numpy()
    S = int(valid.sum())
    a = adj[:S, :S]
    iu, ju = np.nonzero(np.triu(a, k=1))
    return from_edges(
        iu, ju, a[iu, ju], S,
        names=graph.names, bu=bu, reg_tiles=reg_tiles, degree_sort=degree_sort,
        device=graph.adj.device if device is None else device,
    )


def from_workmodel(
    wm, *, bu: int = 512, reg_tiles: int = 2,
    device: str | torch.device | None = DEFAULT_DEVICE,
) -> SparseCommGraph:
    """Build straight from a workmodel's call graph, never materializing
    the dense adjacency — the only viable path at 50k+ services."""
    index = {s.name: i for i, s in enumerate(wm.services)}
    src: list[int] = []
    dst: list[int] = []
    for i, svc in enumerate(wm.services):
        for callee in svc.callees:
            j = index.get(callee)
            if j is not None and j != i:
                src.append(i)
                dst.append(j)
    return from_edges(
        np.asarray(src), np.asarray(dst), np.ones(len(src)), len(wm.services),
        names=wm.names, bu=bu, reg_tiles=reg_tiles, device=device,
    )


def rv_weighted_edge_w(sgraph: SparseCommGraph, rv_sorted: torch.Tensor) -> torch.Tensor:
    """Per-edge rv-weighted weight ``(w·rv_s)·rv_t`` — the one product
    grouping of the exact cut sum, shared by :func:`sparse_pair_comm_cost`
    and the sparse solver's per-sweep objective."""
    s, t = sgraph.edges_src.long(), sgraph.edges_dst.long()
    return sgraph.edges_w * rv_sorted[s] * rv_sorted[t]


def edge_cut_sum(
    sgraph: SparseCommGraph, e_rvw: torch.Tensor, assign_sorted: torch.Tensor
) -> torch.Tensor:
    """``0.5·Σ_e e_rvw·[a_s ≠ a_t]`` over the symmetric COO list (each
    undirected edge appears twice, hence the 0.5)."""
    cut = (
        assign_sorted[sgraph.edges_src.long()] != assign_sorted[sgraph.edges_dst.long()]
    ).to(torch.float32)
    return 0.5 * torch.sum(e_rvw * cut)


def sparse_pair_comm_cost(
    sgraph: SparseCommGraph, assign_sorted: torch.Tensor, rv_sorted: torch.Tensor
) -> torch.Tensor:
    """Exact pair-weighted cut ``0.5·Σ_e w_e·rv_s·rv_t·[a_s ≠ a_t]`` — the
    sparse twin of the dense solver's ``exact_comm_cost``."""
    return edge_cut_sum(sgraph, rv_weighted_edge_w(sgraph, rv_sorted), assign_sorted)
