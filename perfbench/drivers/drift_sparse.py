"""Sparse drift cells: ``drift``'s rounds through the port's block-local
streaming entry, ``bench.trace.replay_on_device_sparse``, with the
``TraceLocator`` of the trace-reordered graph. The round's multipliers
follow the locator's edge order (undirected edges by their two
degree-sorted slots), which the reference works out again from the edge
list (``reference/sparse_solve.py``)."""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch.core.sparsegraph import from_workmodel, reorder_for_trace
from perfbench.drivers import drift
from perfbench.reference import dense_solve, sparse_solve


class Driver(drift.Driver):
    def _graph(self, dep):
        """The port's block-local graph, and the reference's structure,
        whose edge order the pool's columns follow."""
        sparse = self.config["sparse"]
        chunk = dense_solve.layout(dep.services, dep.nodes,
                                   int(self.config["solver"]["chunk_size"])).chunk
        self.structure = sparse_solve.structure(
            dep.services, dep.nodes, dep.ii, dep.jj, chunk,
            int(sparse["bu"]) * int(sparse["reg_tiles"]))
        self.edges = (self.structure.ea, self.structure.eb)
        sgraph = from_workmodel(drift.workmodel(dep), bu=int(sparse["bu"]),
                                reg_tiles=int(sparse["reg_tiles"]), device=self.device)
        self.sgraph, self.locator = reorder_for_trace(sgraph)
        return None

    def entry(self, k: int):
        return drift.port_trace.replay_on_device_sparse(
            self.state, self.sgraph, self.locator, self.pool[k:k + 1], self.generator,
            self.solver)

    def kernel_shapes(self) -> dict:
        """Kernel → ``[(shape, launches a round)]``: the hub groups each
        sweep (score, hub mass, admission), and each chunk the fused mass
        and score on plain sweeps, the chunk mass twice (M, and Wc against
        chunk positions) and the score on swap sweeps, the admission on
        every sweep. Products: the rows' call pairs; for Wc those whose
        other end lands in the chunk (in expectation over the draw)."""
        st, cfg = self.structure, self.config
        sparse, solver = cfg["sparse"], cfg["solver"]
        bu = int(sparse["bu"])
        U = int(sparse["reg_tiles"]) * bu
        N, C, KB, n = st.nodes, st.width, st.kb, st.n_chunks
        noise = float(solver["noise_temp"]) > 0
        sweeps, every = int(solver["sweeps"]), int(solver["swap_every"])
        swaps = sum(1 for s in range(sweeps) if every > 0 and s % every == every - 1)
        plain = sweeps - swaps
        reg = np.asarray(st.regular, dtype=np.int64)
        nnz = float(st.block_edges[reg].sum()) / n
        is_reg = np.zeros(st.block_edges.shape[0], dtype=bool)
        is_reg[reg] = True
        ba, bb = st.pos[st.ea] // 256, st.pos[st.eb] // 256
        both = is_reg[ba] & is_reg[bb]
        same = 2.0 * float((both & (ba == bb)).sum())
        other = 2.0 * float((both & (ba != bb)).sum())
        nnz_c = (same + other * (KB - 1) / max(n * KB - 1, 1)) / n
        tiles = np.maximum(-(-st.block_distinct // bu), int(sparse["reg_tiles"]))
        out = {"score": [(dict(C=C, N=N, noise=noise), swaps * n)],
               "admission": [(dict(C=C, N=N), sweeps * n)],
               "sparse_mass": [(dict(C=C, U=U, KB=KB, nn=N, nnz=nnz), swaps * n),
                               (dict(C=C, U=U, KB=KB, nn=C, nnz=nnz_c), swaps * n)],
               "mass_score": [(dict(C=C, U=U, KB=KB, N=N, nnz=nnz, noise=noise), plain * n)],
               "hub_mass": []}
        for g in st.hub_groups:
            rows = len(g) * 256
            out["score"].append((dict(C=rows, N=N, noise=noise), sweeps))
            out["admission"].append((dict(C=rows, N=N), sweeps))
            out["hub_mass"].append((dict(T=int(tiles[list(g)].sum()), blocks=len(g), N=N,
                                         nnz=float(st.block_edges[list(g)].sum()), bu=bu),
                                    sweeps))
        return out

    def close_window(self) -> None:
        self.sgraph = self.locator = None
        super().close_window()

    def reference(self, starts: dict[int, np.ndarray], weight_dtype=torch.bfloat16,
                  cost_dtype=torch.float32) -> dict:
        rounds = sorted(starts)
        dep, dev, st = self.dep, self.device, self.structure
        solver = self.config["solver"]
        gen = torch.Generator().manual_seed(self.plan_seed)
        plans = {}
        for r in range(max(rounds) + 1):
            p = sparse_solve.draw_plans(gen, int(solver["sweeps"]), st)
            if r in rounds:
                plans[r] = p
        args = drift.node_arrays(dep, dev)
        return {r: sparse_solve.solve(
            st, torch.as_tensor(self._weights(r), device=dev), *args,
            torch.as_tensor(starts[r], device=dev, dtype=torch.int64), plans[r], solver,
            weight_dtype=weight_dtype, cost_dtype=cost_dtype) for r in rounds}
