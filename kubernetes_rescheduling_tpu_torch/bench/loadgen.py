"""Request-level load generation — the port of
``kubernetes_rescheduling_tpu.bench.loadgen``.

The reference validates placements with ~1000 concurrent curl clients
against the µBench entry service for 180 s, reporting success and error
counts and min/avg/max latency (reference release1.sh:7-10, 29-42, 74-117),
and keeps the same load on while the rescheduling loop runs (reference
release2.sh:50-59). This module simulates that request stream, so the
response-time results come from per-request dynamics.

Model
-----
A request enters at the entry service (µBench ``s0``) and fans out along
the *directed* call graph: each request to a service issues one sub-request
to every callee. End-to-end latency is the recursive sum over the call
DAG::

    L(s) = proc(s) · q(node(s)) + Σ_{c ∈ callees(s)} [ hop(s, c) + L(c) ]

- ``proc(s)``: base service time, inflated by the M/M/1-shaped factor
  ``q = 1/(1-ρ)`` of the replica's node;
- ``hop(s, c)``: cheap if caller and callee replicas share a node, a network
  round trip if not — the quantity CAR minimizes;
- each request picks one replica per service uniformly at random, and the
  latency carries multiplicative lognormal jitter.

Errors come from Deployment teardown windows (**outage**: the request
traverses a service whose Deployment is being re-created) and from nodes
past 100% CPU, which drop a utilization-dependent share of their requests
(**overload**).

On the device
-------------
:func:`request_chunk` simulates one fixed-size chunk of requests in plain
torch ops: the call graph is an edge list, and latency propagates in
``depth`` rounds of gather and ordered scatter-add (``depth`` = the longest
path of the cycle-broken DAG). The tensors are laid out service- or
edge-major (``[S, chunk]``, ``[E, chunk]``), so each scatter adds whole rows
along one index of E entries: ``index_put(accumulate=True)`` sorts those
indices and adds each caller's edges in edge order, on the card and on the
CPU alike, so two runs on the same draws give equal bits (``index_add_``
on floats would add with atomics in no fixed order). The visited scatter
counts in int32, which is order-free. Memory is O(chunk · E), never O(S²).

Randomness comes from an explicit device ``torch.Generator`` seeded per
(phase seed, chunk index) — the counterpart of the JAX package's
``fold_in(key, chunk_i)``. The ``draws=`` seam of :meth:`LoadGenerator.run`
feeds the five draws in from outside (the tests feed jax's stream).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch._random import derive_seed
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState
from kubernetes_rescheduling_tpu_torch.core.workmodel import Workmodel, kahn_traversal
from kubernetes_rescheduling_tpu_torch.elastic.rates import (  # noqa: F401  (re-exported)
    RateProfile,
    service_rate_series,
)
from kubernetes_rescheduling_tpu_torch.telemetry.accounting import pull_arrays

# the five draws of one chunk, in the JAX package's layout: replica uniform
# [chunk, S], arrival uniform [chunk], jitter normal [chunk], drop uniform
# [chunk], edge uniform [chunk, E]
Draws = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class LoadGenConfig:
    """Knobs of the simulated client fleet (reference release1.sh:7-10).

    The reference's ~1000 concurrent clients show up twice: the *offered
    CPU load* is the simulator's ``LoadModel.entry_rps``, and the
    *measurement sample* is ``requests_per_phase`` requests drawn uniformly
    over ``duration_s``."""

    duration_s: float = 180.0      # load duration (release1.sh:8)
    requests_per_phase: int = 8192 # sampled requests per measurement phase
    chunk: int = 1024              # requests per chunk (a static shape)
    entry_service: str = "s0"      # NodePort target (release1.sh:7)
    proc_ms: float = 1.5           # base per-service processing time
    hop_local_ms: float = 0.2      # same-node call
    hop_remote_ms: float = 3.0     # cross-node call
    queue_rho_cap: float = 0.95    # ρ clamp of the 1/(1-ρ) factor
    jitter_sigma: float = 0.15     # lognormal latency jitter
    drop_rho: float = 1.0          # nodes past this utilization drop requests
    max_drop_p: float = 0.95       # per-service drop probability ceiling


@dataclass(frozen=True)
class RequestStats:
    """The reference's client-side stat block (release1.sh:74-117)."""

    sent: int
    ok: int
    err_outage: int
    err_overload: int
    duration_s: float
    latency_min_ms: float
    latency_avg_ms: float
    latency_max_ms: float
    latency_p50_ms: float
    latency_p95_ms: float
    latency_p99_ms: float
    # pods recreated by Deployment moves (every replica of a moved service
    # restarts): the disruption the rescheduler causes
    restarts: int = 0
    # the measured container-crash delta over the window (the reference's
    # restartCount metric, release1.sh:101-102); None = not measurable
    container_crashes: int | None = None

    @property
    def errors(self) -> int:
        return self.err_outage + self.err_overload

    @property
    def error_rate(self) -> float:
        return self.errors / self.sent if self.sent else 0.0

    def as_dict(self) -> dict:
        return {
            "sent": self.sent,
            "ok": self.ok,
            "errors": self.errors,
            "err_outage": self.err_outage,
            "err_overload": self.err_overload,
            "error_rate": self.error_rate,
            "duration_s": self.duration_s,
            "latency_min_ms": self.latency_min_ms,
            "latency_avg_ms": self.latency_avg_ms,
            "latency_max_ms": self.latency_max_ms,
            "latency_p50_ms": self.latency_p50_ms,
            "latency_p95_ms": self.latency_p95_ms,
            "latency_p99_ms": self.latency_p99_ms,
            "restarts": self.restarts,
            "container_crashes": self.container_crashes,
        }


@dataclass(frozen=True)
class CallPlan:
    """Host-side precomputation of the call DAG (static across a phase)."""

    names: tuple[str, ...]
    entry: int
    src: np.ndarray          # i32[E] caller service index per edge
    dst: np.ndarray          # i32[E] callee service index per edge
    reach: np.ndarray        # bool[S] reachable from entry (cycle-broken DAG)
    depth: int               # longest entry-reachable path, in edges

    @property
    def num_services(self) -> int:
        return len(self.reach)


def build_call_plan(
    relation: Mapping[str, Sequence[str]],
    names: Sequence[str],
    entry_service: str,
) -> CallPlan:
    """The cycle-broken edge list with entry reachability and depth, from
    :func:`core.workmodel.kahn_traversal` — the rule the simulator's CPU
    load propagation uses, so both agree on which edges exist."""
    names = tuple(names)
    index = {n: i for i, n in enumerate(names)}
    S = len(names)

    order, name_edges = kahn_traversal(relation, names)
    edges = [(index[s], index[d]) for s, d in name_edges]
    src = np.asarray([e[0] for e in edges], dtype=np.int32)
    dst = np.asarray([e[1] for e in edges], dtype=np.int32)

    reach = np.zeros(S, dtype=bool)
    depth = 0
    if entry_service in index:
        reach[index[entry_service]] = True
        out_edges: dict[int, list[int]] = {}
        for s, d in edges:
            out_edges.setdefault(s, []).append(d)
        # reachability and the longest path, in topological order
        dist = np.full(S, -1, dtype=np.int64)
        dist[index[entry_service]] = 0
        for svc in order:
            i = index[svc]
            if dist[i] < 0:
                continue
            for d in out_edges.get(i, ()):
                if dist[d] < dist[i] + 1:
                    dist[d] = dist[i] + 1
                    reach[d] = True
        depth = int(dist.max()) if (dist >= 0).any() else 0
    return CallPlan(
        names=names,
        entry=index.get(entry_service, -1),
        src=src,
        dst=dst,
        reach=reach,
        depth=max(depth, 1),
    )


def draw_chunk(chunk: int, S: int, E: int, generator: torch.Generator,
               device: torch.device) -> Draws:
    """The five draws of one chunk from ``generator`` (on ``device``), in
    the JAX layout (:data:`Draws`)."""
    u_rep = torch.rand((chunk, S), generator=generator, device=device)
    t = torch.rand((chunk,), generator=generator, device=device)
    z = torch.randn((chunk,), generator=generator, device=device)
    u_drop = torch.rand((chunk,), generator=generator, device=device)
    u_edge = torch.rand((chunk, E), generator=generator, device=device)
    return u_rep, t, z, u_drop, u_edge


def request_chunk(
    draws: Draws,
    src: torch.Tensor,            # i64[E]
    dst: torch.Tensor,            # i64[E]
    entry: int,
    proc_ms: torch.Tensor,        # f32[S]
    replica_nodes: torch.Tensor,  # i64[S, Rmax] node of each replica (pad = 0)
    replica_counts: torch.Tensor, # i32[S] placed replicas (0 = unavailable)
    node_rho: torch.Tensor,       # f32[N] utilization fraction
    outage_frac: torch.Tensor,    # f32[S, 2] outage window as fractions of the phase
    edge_p: torch.Tensor,         # f32[E] per-edge call probability
    n_valid: int,                 # real requests in this chunk
    cfg_vec: torch.Tensor,        # f32[6] local, remote, rho_cap, jitter, drop_rho,
                                  #        max_drop_p
    *,
    depth: int,
):
    """Simulate one chunk of requests on the draws' device. Returns
    per-request ``(latency_ms f32, ok, err_outage, err_overload)`` [chunk]
    and the per-edge traversal count i32[E] over the chunk's first
    ``n_valid`` requests (the observed-traffic signal)."""
    local_ms, remote_ms, rho_cap, jitter, drop_rho, max_drop_p = cfg_vec.unbind()
    u_rep, t, z, u_drop, u_edge = draws
    S = proc_ms.shape[0]
    chunk = t.shape[0]

    # each sub-request picks a replica uniformly (k8s Service balancing);
    # service-major [S, chunk] from here on
    counts = replica_counts[:, None]
    ridx = torch.minimum((u_rep.T * counts.clamp_min(1)).to(torch.int32),
                         (counts - 1).clamp_min(0))
    svc_node = replica_nodes.gather(1, ridx.long())              # [S, chunk]

    # the request's call tree: each kept edge fires with its probability
    active = u_edge.T < edge_p[:, None]                          # [E, chunk]

    # queue-inflated processing time per (service, request)
    q = 1.0 / (1.0 - torch.minimum(torch.clamp_min(node_rho, 0.0), rho_cap))
    proc_q = proc_ms[:, None] * q[svc_node]                      # [S, chunk]

    # per-edge hop: local if caller and callee replicas share a node; the
    # endpoints' nodes gathered once a chunk
    hop = torch.where(svc_node[src] == svc_node[dst], local_ms, remote_ms)
    af = active.to(proc_q.dtype)

    # latency: depth rounds of L = proc·q + the ordered scatter-add of the
    # active sub-calls
    lat = proc_q
    for _ in range(depth):
        lat = proc_q.index_put((src,), af * (hop + lat[dst]), accumulate=True)
    latency = lat[entry] * torch.exp(jitter * z)

    # which services the sampled call tree visits (a count, order-free)
    entry_visit = torch.zeros((S, chunk), dtype=torch.bool, device=proc_q.device)
    entry_visit[entry] = True
    visited = entry_visit
    for _ in range(depth):
        hits = torch.zeros((S, chunk), dtype=torch.int32, device=proc_q.device)
        hits.index_add_(0, dst, (active & visited[src]).to(torch.int32))
        visited = entry_visit | (hits > 0)

    # outage: the arrival falls inside a visited service's teardown window
    down = (t[None, :] >= outage_frac[:, 0:1]) & (t[None, :] < outage_frac[:, 1:2])
    unavailable = (replica_counts == 0)[:, None]
    err_outage = (visited & (down | unavailable)).any(0)

    # overload: each visited service on a node past drop_rho drops requests
    rho_at = node_rho[svc_node]
    p_drop = torch.minimum(
        torch.clamp_min(1.0 - drop_rho / torch.clamp_min(rho_at, 1e-6), 0.0), max_drop_p)
    p_drop = torch.where(visited, p_drop, 0.0)
    survive = torch.exp(torch.log1p(-p_drop).sum(0))
    err_overload = ~err_outage & (u_drop > survive)
    ok = ~(err_outage | err_overload)

    # observed traffic: an edge is traversed when its caller is visited and
    # the edge fired; only the chunk's real (non-padding) rows count
    rowmask = torch.arange(chunk, device=proc_q.device) < n_valid
    edge_count = (active & visited[src] & rowmask[None, :]).sum(1).to(torch.int32)
    return latency, ok, err_outage, err_overload, edge_count


@dataclass
class _Samples:
    """Accumulated per-request outcomes across chunks and segments."""

    latencies: list[np.ndarray] = field(default_factory=list)
    sent: int = 0
    err_outage: int = 0
    err_overload: int = 0
    sim_s: float = 0.0
    restarts: int = 0
    container_crashes: int | None = None
    # per-edge traversal totals (aligned with the generator's CallPlan edge
    # list): the observed-traffic signal for weight estimation
    edge_counts: np.ndarray | None = None

    def extend(self, latency, ok, e_out, e_over, n: int, edge_count=None) -> None:
        lat = np.asarray(latency[:n])
        okm = np.asarray(ok[:n])
        self.latencies.append(lat[okm])
        self.sent += n
        self.err_outage += int(np.asarray(e_out[:n]).sum())
        self.err_overload += int(np.asarray(e_over[:n]).sum())
        if edge_count is not None:
            ec = np.asarray(edge_count, dtype=np.int64)
            if self.edge_counts is None:
                self.edge_counts = ec.copy()
            else:
                self.edge_counts += ec

    def stats(self) -> RequestStats:
        lat = (np.concatenate(self.latencies) if self.latencies
               else np.zeros(0, dtype=np.float32))
        have = lat.size > 0
        return RequestStats(
            sent=self.sent,
            ok=int(lat.size),
            err_outage=self.err_outage,
            err_overload=self.err_overload,
            duration_s=self.sim_s,
            latency_min_ms=float(lat.min()) if have else 0.0,
            latency_avg_ms=float(lat.mean()) if have else 0.0,
            latency_max_ms=float(lat.max()) if have else 0.0,
            latency_p50_ms=float(np.percentile(lat, 50)) if have else 0.0,
            latency_p95_ms=float(np.percentile(lat, 95)) if have else 0.0,
            latency_p99_ms=float(np.percentile(lat, 99)) if have else 0.0,
            restarts=self.restarts,
            container_crashes=self.container_crashes,
        )


def new_samples() -> _Samples:
    """A fresh accumulator for a multi-segment phase (reference release2.sh)."""
    return _Samples()


class LoadGenerator:
    """Simulated client fleet over a workmodel and placements, on ``device``.

    Reusable across phases and segments: the call plan and the static
    tensors are built once; each :meth:`run` binds the placement,
    utilization and outage windows."""

    def __init__(
        self,
        workmodel: Workmodel,
        cfg: LoadGenConfig | None = None,
        *,
        fanout_frac: float = 1.0,
        edge_probs: Mapping[tuple[str, str], float] | None = None,
        device: str | torch.device | None = DEFAULT_DEVICE,
    ):
        """``fanout_frac`` is the per-edge call probability and comes from
        the simulator's CPU-load model (``backends.sim.LoadModel.
        fanout_frac``), passed by the caller rather than kept twice.
        ``edge_probs`` overrides the probability of single directed edges
        ``(caller, callee)``: how actual traffic drifts from the declared
        call graph, which the weight estimator recovers."""
        self.cfg = cfg or LoadGenConfig()
        self.workmodel = workmodel
        self.fanout_frac = fanout_frac
        self.device = resolve_device(device)
        names = workmodel.names
        self.plan = build_call_plan(workmodel.directed_relation(), names,
                                    self.cfg.entry_service)
        self._svc_index = {n: i for i, n in enumerate(names)}
        c, dev = self.cfg, self.device
        self._cfg_vec = torch.tensor(
            [c.hop_local_ms, c.hop_remote_ms, c.queue_rho_cap, c.jitter_sigma, c.drop_rho,
             c.max_drop_p], dtype=torch.float32, device=dev)
        edge_p = np.full(len(self.plan.src), fanout_frac, dtype=np.float32)
        for (a, b), p in (edge_probs or {}).items():
            ia, ib = self._svc_index.get(a), self._svc_index.get(b)
            if ia is None or ib is None:
                continue
            edge_p[(self.plan.src == ia) & (self.plan.dst == ib)] = p
        self._edge_p = torch.from_numpy(edge_p).to(dev)
        self._src = torch.from_numpy(self.plan.src.astype(np.int64)).to(dev)
        self._dst = torch.from_numpy(self.plan.dst.astype(np.int64)).to(dev)
        # per-service base service time: proc_ms scaled by the workmodel's
        # relative cost (each service carries its own stress parameters)
        self._proc_ms = torch.tensor([c.proc_ms * s.proc_cost for s in workmodel.services],
                                     dtype=torch.float32, device=dev)
        self._declared_cache: tuple | None = None

    def _placement_arrays(self, state: ClusterState) -> tuple[np.ndarray, np.ndarray]:
        """Per-service replica → node tables from a snapshot: ``nodes``
        i32[S, Rmax] (each service's placed pods in pod order, 0-padded) and
        ``counts`` i32[S]."""
        S = self.plan.num_services
        pod_svc = state.pod_service.cpu().numpy()
        pod_node = state.pod_node.cpu().numpy()
        valid = state.pod_valid.cpu().numpy() & (pod_node >= 0)
        idx = np.flatnonzero(valid & (pod_svc >= 0) & (pod_svc < S))
        svc = pod_svc[idx].astype(np.int64)
        counts = np.bincount(svc, minlength=S).astype(np.int32)
        nodes = np.zeros((S, max(1, int(counts.max(initial=0)))), dtype=np.int32)
        order = np.argsort(svc, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(order.size) - starts[svc[order]]
        nodes[svc[order], rank] = pod_node[idx[order]]
        return nodes, counts

    def chunk_generator(self, seed: int, chunk_i: int) -> torch.Generator:
        """The device generator of chunk ``chunk_i`` of a phase seeded
        ``seed`` (the counterpart of ``fold_in(key, chunk_i)``)."""
        return torch.Generator(device=self.device).manual_seed(derive_seed(seed, chunk_i))

    def run(
        self,
        state: ClusterState,
        seed: int,
        *,
        duration_s: float | None = None,
        n_requests: int | None = None,
        outages: Sequence[tuple[str, float, float]] = (),
        samples: _Samples | None = None,
        draws: Callable[[int], Draws] | None = None,
    ) -> _Samples:
        """Simulate one phase or segment of load against a snapshot.

        ``outages``: (service, start_s, end_s) windows within the phase in
        which that service's Deployment serves nothing — at most one a
        service (a second raises rather than merging). ``samples``
        accumulates across segments (phase r2). ``draws(chunk_i)`` replaces
        the generator's draws of each chunk (the tests' seam)."""
        cfg = self.cfg
        duration = cfg.duration_s if duration_s is None else duration_s
        total = cfg.requests_per_phase if n_requests is None else n_requests
        samples = samples if samples is not None else _Samples()
        if total <= 0 or self.plan.entry < 0:
            samples.sim_s += duration
            return samples

        nodes, counts = self._placement_arrays(state)
        S, E, dev = self.plan.num_services, len(self.plan.src), self.device
        outage = np.zeros((S, 2), dtype=np.float32)
        seen: set[int] = set()
        for svc, start, end in outages:
            i = self._svc_index.get(svc)
            if i is None or duration <= 0:
                continue
            if i in seen:
                raise ValueError(
                    f"multiple outage windows for {svc!r}; split the phase into segments "
                    "instead (one window per service each)"
                )
            seen.add(i)
            outage[i] = (start / duration, end / duration)

        rho = state.to(dev).node_cpu_pct().to(torch.float32) / 100.0
        head = (self._src, self._dst, self.plan.entry, self._proc_ms,
                torch.from_numpy(nodes.astype(np.int64)).to(dev),
                torch.from_numpy(counts).to(dev), rho,
                torch.from_numpy(outage).to(dev), self._edge_p)
        done = chunk_i = 0
        while done < total:
            n = min(cfg.chunk, total - done)
            d = (draws(chunk_i) if draws is not None
                 else draw_chunk(cfg.chunk, S, E, self.chunk_generator(seed, chunk_i), dev))
            latency, ok, e_out, e_over, edge_count = request_chunk(
                tuple(x.to(dev) for x in d), *head, n, self._cfg_vec, depth=self.plan.depth)
            host = pull_arrays({"latency": latency, "ok": ok, "e_out": e_out,
                                "e_over": e_over, "edges": edge_count}, site="loadgen")
            samples.extend(host["latency"], host["ok"], host["e_out"], host["e_over"], n,
                           host["edges"])
            done += n
            chunk_i += 1
        samples.sim_s += duration
        return samples

    def measure(
        self,
        state: ClusterState,
        seed: int,
        *,
        duration_s: float | None = None,
        outages: Sequence[tuple[str, float, float]] = (),
        draws: Callable[[int], Draws] | None = None,
    ) -> RequestStats:
        """One self-contained measurement phase (reference release1.sh)."""
        return self.run(state, seed, duration_s=duration_s, outages=outages,
                        draws=draws).stats()

    def observed_weights(self, edge_counts: np.ndarray, sent: int) -> dict[tuple[str, str], float]:
        """Symmetric pair weights from OBSERVED traversal counts: expected
        traversals per request per service pair (the reference's objective
        is defined on deployed traffic, README.md:47)."""
        out: dict[tuple[str, str], float] = {}
        if sent <= 0:
            return out
        names = self.plan.names
        for e in range(len(self.plan.src)):
            a = names[int(self.plan.src[e])]
            b = names[int(self.plan.dst[e])]
            pair = (a, b) if a <= b else (b, a)
            out[pair] = out.get(pair, 0.0) + float(edge_counts[e]) / sent
        return out

    def observed_graph(self, edge_counts: np.ndarray | None, sent: int, base, *,
                       prior_requests: float = 50.0):
        """``base`` with its edge weights replaced by observed traffic rates,
        blended with the declared weight through a pseudo-count prior:
        ``(count + prior_requests·declared) / (sent + prior_requests)`` (a
        live low-rate edge is not zeroed by a small sample). Declared pairs
        the request model can never traverse (cycle-broken back edges) go
        to 0. Returns ``base`` unchanged while nothing is observed."""
        from kubernetes_rescheduling_tpu_torch.bench.trace import with_weights

        if edge_counts is None or sent <= 0:
            return base
        declared = self._declared_pairs(base)
        k = max(float(prior_requests), 0.0)
        updates = {
            pair: (rate * sent + k * declared.get(pair, 0.0)) / (sent + k)
            for pair, rate in self.observed_weights(edge_counts, sent).items()
        }
        for pair in declared:
            updates.setdefault(pair, 0.0)
        return with_weights(base, updates)

    def _declared_pairs(self, base) -> dict[tuple[str, str], float]:
        """The base graph's nonzero pairs with their declared weights (the
        blending prior), enumerated once per graph object and cached: the
        estimator runs every round against the same declared graph, and
        reading the S×S adjacency back each round would dominate it."""
        cached = self._declared_cache
        if cached is not None and cached[0] is base:
            return cached[1]
        adj = base.adj.cpu().numpy()
        names = list(base.names)
        pairs = {
            tuple(sorted((names[int(i)], names[int(j)]))): float(adj[i, j])
            for i, j in np.argwhere(adj > 0)
            if i < j
        }
        self._declared_cache = (base, pairs)
        return pairs


def open_loop_arrivals(rate_rps: float, n: int, seed: int = 0) -> np.ndarray:
    """Seeded open-loop arrival offsets: ``n`` cumulative exponential
    inter-arrival gaps at mean rate ``rate_rps`` (a Poisson process), f64[n]
    seconds from stream start. Open loop: arrivals are drawn independently
    of completions, so a slow server faces a growing queue — the regime
    where tail latency and counted shedding mean something."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / float(rate_rps), size=int(n)))
