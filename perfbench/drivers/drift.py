"""Drift cells: online rescheduling as call rates shift.

Each round is one call of the port's streaming entry,
``bench.trace.replay_on_device``, with that round's multipliers: the
weight update and the captured solve on the previous round's placement.
The round ends when its placement and objective are on the host, the
decision a controller applies. The port draws each solve's sweep plans
from its CPU generator, as users run it; the reference draws the same
plans from a generator seeded alike.

``check`` holds every round's placement to the configuration's
guarantees and its reported objectives to their own evaluation under the
round's weights, and re-solves a sample of rounds with the plain
reference (``reference/dense_solve.py``) from the placement the round
started from.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch.bench import trace as port_trace
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState
from kubernetes_rescheduling_tpu_torch.core.workmodel import ServiceSpec, Workmodel
from kubernetes_rescheduling_tpu_torch.solver.global_solver import GlobalSolverConfig
from kubernetes_rescheduling_tpu_torch.telemetry.registry import get_registry
from perfbench import cluster, traffic
from perfbench.reference import dense_solve


def captures_total() -> float:
    return sum(r.get("value", 0.0) for r in get_registry().snapshot()
               if r["metric"] == "cuda_graph_captures_total")


def workmodel(dep: cluster.Deployment) -> Workmodel:
    return Workmodel(services=tuple(
        ServiceSpec(name=f"s{i}", callees=tuple(f"s{c}" for c in dep.callees[i]),
                    cpu_request_millicores=int(dep.pod_cpu_m),
                    mem_request_bytes=int(dep.pod_mem_bytes))
        for i in range(dep.services)), source="perfbench")


def node_names(dep: cluster.Deployment) -> list[str]:
    return [f"worker{i:04d}" for i in range(dep.nodes)]


def node_arrays(dep: cluster.Deployment, dev) -> tuple[torch.Tensor, ...]:
    """The reference's per-service CPU and memory and per-node budgets."""
    return (torch.full((dep.services,), dep.pod_cpu_m, device=dev),
            torch.full((dep.services,), dep.pod_mem_bytes, device=dev),
            torch.full((dep.nodes,), dep.node_cpu_m, device=dev),
            torch.full((dep.nodes,), dep.node_mem_bytes, device=dev))


class Driver:
    def __init__(self, cell: dict, config: dict, seed: int, device: torch.device, hooks):
        self.cell, self.config, self.seed = cell, config, seed
        self.device, self.hooks = device, hooks
        t = cell["traffic"]
        self.dep = dep = cluster.build(config, seed)
        self.placement0 = cluster.random_placement(dep, seed)
        self.graph = self._graph(dep)
        self.state = ClusterState.build(
            node_names=node_names(dep), node_cpu_cap=[dep.node_cpu_m] * dep.nodes,
            node_mem_cap=[dep.node_mem_bytes] * dep.nodes, pod_services=list(range(dep.services)),
            pod_nodes=self.placement0.tolist(), pod_cpu=[dep.pod_cpu_m] * dep.services,
            pod_mem=[dep.pod_mem_bytes] * dep.services, device=device)
        self.solver = GlobalSolverConfig(**config["solver"])
        self.pool = traffic.drift_pool(cluster.pair_rates(dep, *self.edges, config["load_model"]),
                                       cluster.base_index(dep, *self.edges),
                                       int(t["pool_rounds"]), float(t["sigma"]),
                                       float(t["rho"]), int(t["seed"]))
        self.plan_seed = cluster.torch_seed(seed, 3)
        self.generator = torch.Generator().manual_seed(self.plan_seed)
        self.placements: list[np.ndarray] = []
        self.objective_after: list[float] = []
        self.objective_before: list[float] = []
        self.warmup = int(t["warmup_rounds"])
        self.warmup_s = float(t["warmup_seconds"])
        self.captures0 = self.captures1 = 0.0

    def _graph(self, dep):
        """The port's dense graph; the pool's columns follow ``self.edges``."""
        self.edges = (dep.ii, dep.jj)
        return workmodel(dep).comm_graph(device=self.device)

    def entry(self, k: int):
        return port_trace.replay_on_device(self.state, self.graph, self.dep.ii, self.dep.jj,
                                           self.pool[k:k + 1], self.generator, self.solver)

    def one_round(self) -> None:
        k = len(self.placements) % self.pool.shape[0]
        with self.hooks.span("entry"):
            state, after, before = self.entry(k)
        with self.hooks.span("readback"):
            self.placements.append(state.pod_node.cpu().numpy()[:self.dep.services].copy())
            self.objective_after.append(float(after.cpu()[0]))
            self.objective_before.append(float(before.cpu()[0]))
        self.state = state

    def run(self) -> None:
        # at least ``warmup_rounds`` rounds, and rounds for ``warmup_seconds``:
        # the sparse replay runs ≈ 15% slower for seconds after its capture
        t0 = time.perf_counter()
        while (len(self.placements) < self.warmup
               or time.perf_counter() - t0 < self.warmup_s):
            self.one_round()
        self.warmup = len(self.placements)
        self.captures0 = captures_total()
        self.hooks.open_window()
        going = True
        while going:
            self.one_round()
            going = self.hooks.round_end()
        self.captures1 = captures_total()

    # ---- what the harness reads after the window

    def failed_rounds(self) -> int:
        return 0

    def captures_in_window(self) -> int:
        return int(self.captures1 - self.captures0)

    def kernel_shapes(self) -> dict:
        """Kernel → ``[(shape, launches a round)]``, from the layout the
        configuration gives (kernels 1–3 on the inline lowering)."""
        lay = dense_solve.layout(self.dep.services, self.dep.nodes,
                                 int(self.config["solver"]["chunk_size"]))
        if lay.block == 1:
            return {}
        w_bytes = torch.empty((), dtype=dense_solve.DTYPES[self.config["solver"]["matmul_dtype"]]
                              ).element_size()
        noise = float(self.config["solver"]["noise_temp"]) > 0
        launches = int(self.config["solver"]["sweeps"]) * lay.n_chunks
        mass = dict(C=lay.chunk, SP=lay.sp, N=lay.nodes, w_itemsize=w_bytes)
        return {"mass": [(mass, launches)],
                "score": [(dict(C=lay.chunk, N=lay.nodes, noise=noise), launches)],
                "admission": [(dict(C=lay.chunk, N=lay.nodes), launches)]}

    def _weights(self, r: int) -> np.ndarray:
        return self.pool[r % self.pool.shape[0]]

    def _cut(self, placements: np.ndarray, rounds: list[int]) -> torch.Tensor:
        """f64[R]: the call weight cut by each placement under its round's
        weights (a service's one pod on another node than its peer's)."""
        dev = self.device
        ii, jj = (torch.as_tensor(e, device=dev) for e in self.edges)
        out = []
        for r0 in range(0, len(rounds), 64):
            p = torch.as_tensor(placements[r0:r0 + 64], device=dev)
            w = torch.as_tensor(np.stack([self._weights(r) for r in rounds[r0:r0 + 64]]),
                                device=dev, dtype=torch.float64)
            out.append(torch.sum(torch.where(p[:, ii] != p[:, jj], w, 0.0), dim=1))
        return torch.cat(out)

    def _objective(self, placements: np.ndarray, rounds: list[int]) -> np.ndarray:
        """f64[R]: the solver's objective of each placement under its round's
        weights: the cut weight, plus ``balance_weight`` × the spread of the
        nodes' CPU percent of budget, plus ``overload_weight`` × each node's
        percent over budget (the configuration enforces capacity)."""
        dep, solver = self.dep, self.config["solver"]
        budget = dep.node_cpu_m * float(solver["capacity_frac"])
        pct = np.stack([np.bincount(np.clip(p, 0, dep.nodes - 1), minlength=dep.nodes)
                        for p in placements]) * dep.pod_cpu_m / budget * 100.0
        ow = float(solver["overload_weight"]) if solver["enforce_capacity"] else 0.0
        terms = (float(solver["balance_weight"]) * pct.std(axis=1)
                 + ow * np.clip(pct - 100.0, 0.0, None).sum(axis=1))
        return self._cut(placements, rounds).cpu().numpy() + terms

    def end_to_end(self) -> dict:
        rounds = list(range(self.warmup, len(self.placements)))
        cut = self._cut(np.stack(self.placements[self.warmup:]), rounds)
        total = float(sum(self._weights(r).astype(np.float64).sum() for r in rounds))
        return {"remote_traffic_pct": 100.0 * float(cut.sum()) / total}

    def close_window(self) -> None:
        self.state = self.graph = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The numbers that decide ``correct``, each with its limit."""
        limits = self.cell["limits"]
        dep, n = self.dep, len(self.placements)
        P = np.stack(self.placements)
        prev = np.concatenate([self.placement0[None, :], P[:-1]])
        after_eval = self._objective(P, list(range(n)))
        before_eval = self._objective(prev, list(range(n)))
        after = np.asarray(self.objective_after, dtype=np.float64)
        before = np.asarray(self.objective_before, dtype=np.float64)
        on_node = (P >= 0) & (P < dep.nodes)
        loads = np.stack([np.bincount(p[ok], minlength=dep.nodes) for p, ok in zip(P, on_node)])
        budget = dep.node_cpu_m * float(self.config["solver"]["capacity_frac"])

        sample = [0] + [self.warmup + r for r in traffic.sample_rounds(
            n - self.warmup, int(self.cell["check"]["sample_rounds"]), self.seed)]
        ref = self.reference({r: prev[r] for r in sample})
        mismatch = max(float(np.mean(ref[r].placement.cpu().numpy() != P[r])) for r in sample)
        solve_gap = max(float(abs(ref[r].objective_after - after[r]) / ref[r].objective_after)
                        for r in sample)
        after_eval = np.maximum(after_eval, 1e-30)
        before_eval = np.maximum(before_eval, 1e-30)
        checks = {
            "services_off_node": int((~on_node).sum()),
            "nodes_over_budget": int((loads * dep.pod_cpu_m > budget).sum()),
            "rounds_worse_than_input": int((after > before).sum()),
            "objective_after_rel_gap": float(np.max(np.abs(after - after_eval) / after_eval)),
            "objective_before_rel_gap": float(np.max(np.abs(before - before_eval) / before_eval)),
            "placement_mismatch_share": mismatch,
            "solve_objective_rel_gap": solve_gap,
        }
        return {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}

    def run_control(self, rounds: int, weight_dtype=torch.float8_e4m3fn,
                    cost_dtype=torch.bfloat16) -> None:
        """The control: the reference put in the port's place for
        ``rounds`` rounds (the warm-up's first), computed in the precisions
        below the configuration's. :meth:`check` then judges its rounds."""
        place = self.placement0
        for r in range(rounds):
            res = self.reference({r: place}, weight_dtype, cost_dtype)[r]
            place = res.placement.cpu().numpy()
            self.placements.append(place.astype(np.int64))
            self.objective_after.append(res.objective_after)
            self.objective_before.append(res.objective_before)
        self.state = self.graph = None

    def reference(self, starts: dict[int, np.ndarray], weight_dtype=torch.bfloat16,
                  cost_dtype=torch.float32) -> dict:
        """The reference's solve of each round ``r`` of ``starts`` from the
        placement ``starts[r]`` the round started from."""
        rounds = sorted(starts)
        dep, dev = self.dep, self.device
        solver = self.config["solver"]
        lay = dense_solve.layout(dep.services, dep.nodes, int(solver["chunk_size"]))
        gen = torch.Generator().manual_seed(self.plan_seed)
        plans = {}
        for r in range(max(rounds) + 1):
            p = dense_solve.draw_plans(gen, int(solver["sweeps"]), lay)
            if r in rounds:
                plans[r] = p
        ii = torch.as_tensor(dep.ii, device=dev)
        jj = torch.as_tensor(dep.jj, device=dev)
        out = {}
        for r in rounds:
            w = torch.as_tensor(self._weights(r), device=dev)
            adj = torch.zeros((dep.services, dep.services), device=dev)
            adj = adj.index_put((ii, jj), w).index_put((jj, ii), w)
            out[r] = dense_solve.solve(
                adj, *node_arrays(dep, dev),
                torch.as_tensor(starts[r], device=dev, dtype=torch.int64), plans[r], solver, lay,
                weight_dtype=weight_dtype, cost_dtype=cost_dtype)
            del adj
        return out
