"""Batched global assignment solver — the port of
``kubernetes_rescheduling_tpu.solver.global_solver``.

Re-places every service at once:

    minimize  0.5 · Σ_{i,j} W[i,j] · [node(i) != node(j)]
              + λ · load-imbalance + over-budget repulsion
    s.t.      per-node CPU and memory capacity

by chunked synchronous best response. Each sweep walks the services in
random chunks; per chunk: the neighbor mass ``M = W[chunk] @ X``, the
score → first-max proposal, the sort-free pairwise admission race, the
commit, and on every ``swap_every``-th sweep the pairwise-exchange phase.
The best state seen across sweeps is returned, re-evaluated exactly, and
adopted only if it beats the input (never worse than the input).

Two lowerings, chosen as in the JAX package:

- ``sweep``: a materialized occupancy matrix X, ``M`` from a float32
  product, then the score and admission kernels (or their plain twin,
  :func:`reference_score_admission`, with ``fused_epilogue="off"``);
- ``sweep_inline``: mass kernel → score kernel → admission kernel, with no
  occupancy matrix at all; ``assign`` is the only state between chunks.

``fused_epilogue="auto"`` runs the kernels on CUDA tensors at any size
(the JAX package keeps solves under C, N = 128 off its TPU kernels; the
CUDA kernels take any size, and the plain versions serve CPU tensors
only); ``"on"`` runs the same lowering on any device (through the plain
versions for CPU tensors); ``"off"`` is the plain path.

Randomness comes from a ``torch.Generator`` through a per-sweep
:class:`SweepPlan` (chunk composition, kernel seeds, and for the plain
``sweep`` path the gumbel noise). A caller may pass the plan instead —
the parity tests build it from the JAX package's key stream and so compare
the two solvers decision by decision.

A solve reads nothing back to the host: move and swap counts stay on the
device, the seed and temperature tables live there, and the input
placement's cost takes both branches of :func:`input_comm_cost` and picks
one on the device. So on CUDA the whole solve — set-up, sweeps, epilogue —
runs as one replay of a CUDA graph captured once per solve shape
(``solver/compiled.py``, the counterpart of the JAX package's jit); on the
CPU, and under ``compiled.eager()``, the same body runs op by op. State
that the JAX package carries functionally (``assign``, the occupancy
matrix) is updated in place here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from kubernetes_rescheduling_tpu_torch._random import gumbel as _gumbel
from kubernetes_rescheduling_tpu_torch.core.state import (
    ClusterState,
    CommGraph,
    _count,
    segment_sum,
)
from kubernetes_rescheduling_tpu_torch.objectives.metrics import (
    ROW_BLOCK,
    communication_cost,
    load_std,
)
from kubernetes_rescheduling_tpu_torch.ops.fused_admission import (
    fused_neighbor_mass,
    fused_score_admission,
    reference_score_admission,
)
from kubernetes_rescheduling_tpu_torch.solver.compiled import CACHE, to_device
from kubernetes_rescheduling_tpu_torch.solver.swap import (
    BIG_CAP,
    chunk_swap_phase,
    commit_moves,
    scan_sweeps,
    swap_flags,
)
from kubernetes_rescheduling_tpu_torch.telemetry.phases import END, phase_mark

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_EPILOGUES = ("auto", "on", "off")


@dataclass(frozen=True)
class GlobalSolverConfig:
    """Solver knobs, defaults identical to the JAX package's (see its
    ``GlobalSolverConfig`` for the measurements behind each)."""

    sweeps: int = 9
    # 0 = auto: ~S/10 in [1, 1024], rounded up to a multiple of 256 past
    # that size so the inline-mass kernels tile (see auto_chunk)
    chunk_size: int = 0
    balance_weight: float = 0.0
    enforce_capacity: bool = True
    # feasibility uses capacity_frac·capacity, the operator's packing budget
    capacity_frac: float = 1.0
    # repulsion per % of load beyond the budget (with enforce_capacity)
    overload_weight: float = 10.0
    # gumbel annealing temperature, linearly decayed to zero over sweeps
    noise_temp: float = 1.0
    # comm-weight units charged per restarted pod (0 = moves are free)
    move_cost: float = 0.0
    # the swap phase runs on every swap_every-th sweep (0 = off)
    swap_every: int = 3
    # swap-candidate subset size per chunk
    swap_k: int = 256
    # dtype of the pair-weight copy the mass contraction reads
    matmul_dtype: str = "bfloat16"
    # "auto" | "on" | "off": the chunk-step kernels (see module docstring)
    fused_epilogue: str = "auto"
    # dense pair weights (mm-dtype copy + f32 adjacency) above this raise
    max_weight_bytes: int = 12 * 1024**3


@dataclass(frozen=True)
class SweepPlan:
    """The random decisions of one sweep.

    ``chunk_ids`` [n_chunks, C]: which services form each chunk;
    ``block_rows`` [n_chunks, C // B]: the same composition as W row-block
    ids (B = 256 on the inline path, 1 elsewhere); ``seeds`` [n_chunks]:
    per-chunk noise seeds of the score kernel (which reads them from
    device memory); ``gumbel`` [n_chunks, C, N] or None: unit gumbel noise
    of the plain ``sweep`` path (None there draws it from the solver's
    generator before the solve)."""

    chunk_ids: torch.Tensor
    block_rows: torch.Tensor
    seeds: torch.Tensor
    gumbel: torch.Tensor | None = None


def _service_aggregates(state: ClusterState, num_services: int):
    """Per-service totals: replica count, CPU, memory; and a current node
    (the node of the service's first valid pod; -1 if absent)."""
    p = state.num_pods
    dev = state.device
    svc = torch.where(state.pod_valid, state.pod_service, num_services).long()
    svc = torch.where((svc >= 0) & (svc < num_services), svc, num_services)
    replicas = _count(svc, num_services + 1)[:num_services].float()
    cpu = segment_sum(torch.where(state.pod_valid, state.pod_cpu, 0.0), svc, num_services)
    mem = segment_sum(torch.where(state.pod_valid, state.pod_mem, 0.0), svc, num_services)
    pod_idx = torch.where(state.pod_valid, torch.arange(p, device=dev), p)
    first = torch.full((num_services + 1,), p, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, svc, pod_idx, reduce="amin")[:num_services]
    has = first < p
    cur_node = torch.where(has, state.pod_node[torch.clamp(first, 0, p - 1)], -1)
    return replicas, cpu, mem, cur_node.to(torch.int32), has


def _pad_to(x: torch.Tensor, size: int, fill=0) -> torch.Tensor:
    pad = torch.full((size - x.shape[0],) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


COMPOSITION_BLOCK = 256


def sweep_composition(
    generator: torch.Generator, SP: int, C: int, n_chunks: int, block: int = 1
):
    """Random per-sweep chunk composition: which services move together.

    Returns ``(chunk_ids [n_chunks, C], block_rows [n_chunks, C // B])``
    where B is the composition granularity: ``block`` where it tiles C and
    SP (the inline-mass path gathers W row-blocks by id), else 1 (a full
    permutation of the services). Drawn on the host."""
    B = block if block > 1 and C % block == 0 and SP % block == 0 else 1
    NB = SP // B
    bp = torch.randperm(NB, generator=generator)
    if B == 1:
        return bp.reshape(n_chunks, C), bp.reshape(n_chunks, C)
    ids = bp[:, None] * B + torch.arange(B)[None, :]
    return ids.reshape(n_chunks, C), bp.reshape(n_chunks, C // B)


class _TorchNamespace:
    """The few array functions :func:`pct_balance_terms` calls, in torch."""

    where = staticmethod(torch.where)
    sum = staticmethod(torch.sum)
    sqrt = staticmethod(torch.sqrt)
    maximum = staticmethod(torch.clamp_min)


def pct_balance_terms(loads, cap, node_valid, balance_weight, overload_weight,
                      xp=_TorchNamespace):
    """The objective's balance + over-budget terms: ``balance_weight·std(pct
    of budget) + overload_weight·Σ relu(pct − 100)``. ``cap`` must already
    be ``capacity_frac``-scaled.

    ``xp`` is the array namespace: torch for the solvers, ``numpy`` for the
    controller's wave-cap ranking on the host, so the cap ranks moves by
    the very expression the solver optimizes (the JAX package evaluates it
    host-side the same way, with numpy's dtype rules)."""
    pct = xp.where(node_valid, loads / cap * 100.0, 0.0)
    n = xp.maximum(xp.sum(node_valid), 1)
    mean = xp.sum(pct) / n
    var = xp.sum(xp.where(node_valid, (pct - mean) ** 2, 0.0)) / n
    over = xp.sum(xp.maximum(pct - 100.0, 0.0))
    return balance_weight * xp.sqrt(var) + overload_weight * over


def check_weight_budget(SP: int, config: GlobalSolverConfig) -> None:
    """Fail with a sizing error when the dense pair-weight residency (the
    mm-dtype copy plus the f32 adjacency it is built from) exceeds
    ``config.max_weight_bytes``."""
    mm_bytes = torch.empty((), dtype=_DTYPES[config.matmul_dtype]).element_size()
    need = SP * SP * (mm_bytes + 4)
    if need > config.max_weight_bytes:
        raise ValueError(
            f"dense pair weights need {need / 2**30:.2f} GiB "
            f"({SP} padded services: {config.matmul_dtype} matmul copy + "
            f"f32 adjacency) — over "
            f"max_weight_bytes={config.max_weight_bytes / 2**30:.2f} GiB. "
            "Raise max_weight_bytes on larger-memory devices or reduce the "
            "service count."
        )


def build_pair_weights(adj, rv, *, SP: int, dtype) -> torch.Tensor:
    """The mm-dtype pair-weight matrix ``pad(adj·rv·rvᵀ)``, built in row
    blocks so no f32 SP×SP product exists at once."""
    S = adj.shape[0]
    W = torch.zeros((SP, SP), dtype=dtype, device=adj.device)
    for r0 in range(0, S, ROW_BLOCK):
        r1 = min(r0 + ROW_BLOCK, S)
        W[r0:r1, :S] = (adj[r0:r1] * rv[r0:r1, None] * rv[None, :]).to(dtype)
    return W


def total_pair_weight(adj, rv) -> torch.Tensor:
    """ΣW over the input adjacency."""
    return rv @ (adj @ rv)


def exact_comm_cost(adj, rv, assign) -> torch.Tensor:
    """0.5·Σ adj·rv·rvᵀ over CUT pairs — a direct sum (error ~ eps·cut), in
    row blocks."""
    S = adj.shape[0]
    a = assign[:S]
    total = torch.zeros((), dtype=torch.float32, device=adj.device)
    for r0 in range(0, S, ROW_BLOCK):
        r1 = min(r0 + ROW_BLOCK, S)
        cut = a[r0:r1, None] != a[None, :]
        w = adj[r0:r1] * rv[r0:r1, None] * rv[None, :]
        total = total + torch.sum(torch.where(cut, w, 0.0))
    return 0.5 * total


def collapsed_placement(idx, node, counted, size: int, n):
    """Collapse detection over ``size`` groups of pods: ``(nmin, rv_eff,
    collapsed)`` — each group's lowest counted node (``n`` when empty), its
    counted-pod count, and whether every nonempty group sits on ONE node."""
    idx_c = torch.where(counted, idx, size).long()
    node_c = torch.where(counted, node, n).long()
    nmin = torch.full((size + 1,), n, dtype=torch.int64, device=idx.device)
    nmin = nmin.scatter_reduce(0, idx_c, node_c, reduce="amin")[:size]
    nmax = torch.full((size + 1,), -1, dtype=torch.int64, device=idx.device)
    nmax = nmax.scatter_reduce(0, idx_c, torch.where(counted, node_c, -1), reduce="amax")[:size]
    rv_eff = _count(idx_c, size + 1)[:size].float()
    return nmin.to(torch.int32), rv_eff, torch.all((rv_eff == 0) | (nmin == nmax))


def comm_cost_collapse(state: ClusterState, graph: CommGraph):
    """The ``(nmin, rv_eff, collapsed)`` routing inputs of
    :func:`input_comm_cost`; per-pod service validity joins the counted
    predicate, so a split invalid service cannot defeat the fast path."""
    num_s = graph.num_services
    n = state.num_nodes
    svc = torch.where(state.pod_valid, state.pod_service, num_s)
    node = torch.clamp(torch.where(state.pod_valid, state.pod_node, n), -1, n)
    svc_ok = (svc < num_s) & graph.service_valid[torch.clamp(svc, 0, num_s - 1)]
    counted = state.pod_valid & (node >= 0) & (node < n) & svc_ok
    return collapsed_placement(svc, node, counted, num_s, n)


def input_comm_cost(state: ClusterState, graph: CommGraph) -> torch.Tensor:
    """``communication_cost`` with the collapsed fast path: when every
    service's pods sit on one node, the direct cut-sum; otherwise the
    general quadratic form. Both are computed and the branch is picked on
    the device (the JAX package's ``lax.cond`` runs one side; a CUDA graph
    can skip one only through a conditional node, which PyTorch 2.11 does
    not expose), so the solve reads nothing back; the general form's
    work is the price of that on collapsed inputs, which every solver
    output is."""
    nmin, rv_eff, collapsed = comm_cost_collapse(state, graph)
    fast = exact_comm_cost(graph.adj, rv_eff * graph.service_valid, nmin)
    return torch.where(collapsed, fast, communication_cost(state, graph))


def restart_bill_from_arrays(pod_mask, pod_node, tgt, move_cost) -> torch.Tensor:
    """The array-level core of :func:`pod_restart_bill`, for callers that
    hold only the pod arrays (the restart selection of the node-sharded
    solves ranks every restart with it)."""
    return move_cost * torch.sum(torch.where(pod_mask & (pod_node != tgt), 1.0, 0.0))


def pod_restart_bill(state: ClusterState, tgt, move_cost) -> torch.Tensor:
    """Exact restart bill of adopting per-pod target nodes ``tgt``: every
    already-placed pod whose node would change pays ``move_cost``. One
    definition: every adopt gate and every restart ranking prices with it."""
    return restart_bill_from_arrays(state.pod_valid & (state.pod_node >= 0), state.pod_node,
                                    tgt, move_cost)


def node_caps(state: ClusterState, config: GlobalSolverConfig):
    """The budget-scaled CPU and memory capacities (an invalid node's 0;
    no memory capacity is an infinite one; inf·frac stays inf)."""
    cpu_cap = torch.where(state.node_valid, state.node_cpu_cap, 0.0)
    mem_cap_raw = torch.where(state.node_valid, state.node_mem_cap, 0.0)
    mem_cap = torch.where(mem_cap_raw > 0, mem_cap_raw, float("inf")) * config.capacity_frac
    cap = torch.where(cpu_cap > 0, cpu_cap, 1.0) * config.capacity_frac
    return cap, mem_cap


def input_objective(state: ClusterState, comm, config: GlobalSolverConfig, cap) -> torch.Tensor:
    """The TRUE objective of the input placement, which may split a
    service's replicas across nodes: its pod-level cost ``comm`` plus the
    balance and over-budget terms. ``load_std`` measures % of raw
    capacity, the solver % of the packing budget ``cap`` — the same units
    once divided by ``capacity_frac``. The adopt gate's reference point."""
    ow = config.overload_weight if config.enforce_capacity else 0.0
    pct0 = torch.where(state.node_valid, state.node_cpu_used() / cap * 100.0, 0.0)
    return (comm + config.balance_weight * (load_std(state) / config.capacity_frac)
            + ow * torch.sum(torch.clamp_min(pct0 - 100.0, 0.0)))


def adopt(state: ClusterState, tgt_pod_node, raw_after, obj_true0, move_cost) -> dict:
    """The adopt gate every global solve ends with: the per-pod targets
    ``tgt_pod_node`` (the best placement scattered to pods) replace the
    input only when their exact objective ``raw_after`` plus the exact
    pod-level restart bill strictly beats the input's ``obj_true0``.
    Returns ``pod_node``, ``objective_before`` / ``objective_after``,
    ``improved`` and the adopted ``move_penalty``."""
    bill = (pod_restart_bill(state, tgt_pod_node, move_cost) if move_cost > 0
            else torch.zeros((), dtype=torch.float32, device=raw_after.device))
    improved = raw_after + bill < obj_true0
    return {
        "pod_node": torch.where(improved & state.pod_valid, tgt_pod_node, state.pod_node),
        "objective_before": obj_true0,
        "objective_after": torch.where(improved, raw_after, obj_true0),
        "improved": improved,
        "move_penalty": torch.where(improved, bill, 0.0),
    }


def auto_chunk(S: int, chunk_size: int = 0) -> int:
    """Resolve the chunk size: explicit, or ~S/10 in [1, 1024]; auto sizes
    >= 256 round up to a multiple of 256 so the padded service count tiles
    cleanly for the inline-mass kernels."""
    if chunk_size:
        return chunk_size
    C = max(1, min(1024, S // 10))
    if C >= 256:
        C = min(1024, -(-C // 256) * 256)
    return C


def prepare_weights(
    state: ClusterState,
    graph: CommGraph,
    config: GlobalSolverConfig = GlobalSolverConfig(),
) -> torch.Tensor:
    """Build the mm-dtype pair-weight matrix once, for reuse across rounds
    with an unchanged service set via ``global_assign(..., w_mm=...)``."""
    S = graph.num_services
    C = min(auto_chunk(S, config.chunk_size), S)
    SP = -(-S // C) * C
    check_weight_budget(SP, config)
    replicas, _, _, _, has_pods = _service_aggregates(state, S)
    svc_valid = _pad_to(graph.service_valid & has_pods, SP, False)
    rv = (_pad_to(replicas, SP) * svc_valid)[:S]
    return build_pair_weights(graph.adj, rv, SP=SP, dtype=_DTYPES[config.matmul_dtype])


def draw_plans(generator, sweeps, SP, C, n_chunks, block) -> list[SweepPlan]:
    """``sweeps`` plans from ``generator``: each sweep's composition
    (:func:`sweep_composition` with granularity ``block``) and its chunks'
    kernel seeds. A plan drawn once can drive solves on two devices."""
    plans = []
    for _ in range(sweeps):
        chunk_ids, block_rows = sweep_composition(generator, SP, C, n_chunks, block)
        seeds = torch.randint(0, 2**31 - 1, (n_chunks,), generator=generator)
        plans.append(SweepPlan(chunk_ids, block_rows, seeds))
    return plans


def kernel_lowering(config: GlobalSolverConfig, device) -> bool:
    """Whether a solve on ``device`` takes the kernel lowering: ``"on"``
    everywhere, ``"auto"`` on CUDA at any size, never under ``"off"``.
    Every kernel sums in a fixed order, so a solve on the card gives the
    same placements on every run for any pair weights."""
    return config.fused_epilogue == "on" or (
        config.fused_epilogue == "auto" and torch.device(device).type == "cuda"
    )


STATE_TENSORS = tuple(f.name for f in dataclasses.fields(ClusterState)
                      if f.name not in ("node_names", "pod_names"))


def state_inputs(state: ClusterState) -> dict[str, torch.Tensor]:
    """The state's arrays, as a solve's inputs."""
    return {name: getattr(state, name) for name in STATE_TENSORS}


def state_from_inputs(t: dict) -> ClusterState:
    """The state a solve body reads: its arrays from the inputs ``t``."""
    return ClusterState(**{name: t[name] for name in STATE_TENSORS})


@dataclass(frozen=True)
class DenseLayout:
    """The static shape of one dense solve: ``services`` padded to
    ``n_chunks`` chunks of ``chunk`` rows, ``nodes``, and the lowering —
    the kernels or the plain twin (``use_fused``), and the inline-mass path
    with its contraction tile ``mass_bj``."""

    services: int
    nodes: int
    chunk: int
    n_chunks: int
    use_fused: bool
    inline_mass: bool
    mass_bj: int | None

    @property
    def sp(self) -> int:
        return self.n_chunks * self.chunk


def dense_layout(S: int, N: int, config: GlobalSolverConfig, device) -> DenseLayout:
    C = min(auto_chunk(S, config.chunk_size), S)
    n_chunks = -(-S // C)
    SP = n_chunks * C
    use_fused = kernel_lowering(config, device)
    mass_bj = next((b for b in (1024, 512, 256) if SP % b == 0), None)
    # inline-mass lowering: the composition is block-granular (256 | C and
    # 256 | SP), so the mass kernel gathers W row-blocks by id and no
    # occupancy matrix exists
    inline = (use_fused and C % COMPOSITION_BLOCK == 0 and SP % COMPOSITION_BLOCK == 0
              and mass_bj is not None)
    return DenseLayout(S, N, C, n_chunks, use_fused, inline, mass_bj)


def sweep_temps(config: GlobalSolverConfig) -> torch.Tensor:
    """f32[sweeps] annealing temperatures, decayed linearly to zero: the
    last sweeps polish greedily (the JAX package's f32 values)."""
    return config.noise_temp * (
        1.0 - torch.arange(config.sweeps, dtype=torch.float32) / max(config.sweeps - 1, 1)
    )


def noise_generator(generator: torch.Generator | None, device) -> torch.Generator:
    """The device generator a plain solve draws its gumbel noise from,
    seeded from the host one."""
    if generator is None:
        raise ValueError("a plan without gumbel noise needs a generator")
    noise_gen = torch.Generator(device=device)
    noise_gen.manual_seed(int(torch.randint(0, 2**62, (1,), generator=generator)))
    return noise_gen


def _stacked(parts, empty_shape, dtype, dev) -> torch.Tensor:
    x = torch.stack(parts) if parts else torch.zeros(empty_shape, dtype=dtype)
    return to_device(x.to(dtype), dev)


def dense_plan_inputs(plan, lay: DenseLayout, config: GlobalSolverConfig, dev,
                      generator=None) -> dict[str, torch.Tensor]:
    """A solve's plans as inputs, stacked over the sweeps and on ``dev``:
    ``chunk_ids``, ``block_rows``, ``seeds`` (i32) and ``temps``; on the
    plain path with noise also ``gumbel`` [sweeps, n_chunks, C, N], drawn
    here from ``generator`` for a plan that has none. All of it reaches the
    device before the solve starts and without a wait."""
    n, C = lay.n_chunks, lay.chunk
    t = {
        "chunk_ids": _stacked([p.chunk_ids for p in plan], (0, n, C), torch.int64, dev),
        "block_rows": _stacked([p.block_rows for p in plan], (0, n, 1), torch.int32, dev),
        "seeds": _stacked([p.seeds for p in plan], (0, n), torch.int32, dev),
        "temps": to_device(sweep_temps(config), dev),
    }
    if not lay.use_fused and config.noise_temp > 0:
        noise_gen = None
        if any(p.gumbel is None for p in plan):
            noise_gen = noise_generator(generator, dev)
        t["gumbel"] = _stacked(
            [p.gumbel.to(dev) if p.gumbel is not None
             else _gumbel((n, C, lay.nodes), noise_gen, dev) for p in plan],
            (0, n, C, lay.nodes), torch.float32, dev,
        )
    return t


def check_solve_args(config: GlobalSolverConfig, plan, generator, what: str) -> None:
    """The arguments every single-device solve refuses: a budget that is
    not positive, an unknown lowering, a plan of the wrong length, neither
    a plan nor a generator (``what`` names the entry point)."""
    if not config.capacity_frac > 0:
        raise ValueError(f"capacity_frac must be > 0, got {config.capacity_frac}")
    if config.fused_epilogue not in _EPILOGUES:
        raise ValueError(
            f"fused_epilogue must be one of {_EPILOGUES}, got {config.fused_epilogue!r}"
        )
    if plan is not None and len(plan) != config.sweeps:
        raise ValueError(f"plan has {len(plan)} sweeps, config.sweeps={config.sweeps}")
    if plan is None and generator is None:
        raise ValueError(f"{what} needs a generator or an explicit plan")


def dense_solve_inputs(state: ClusterState, graph: CommGraph, generator, config,
                       plan=None) -> tuple[DenseLayout, dict[str, torch.Tensor]]:
    """The layout of one dense solve and its inputs (the state's arrays, the
    graph's validity mask, the per-sweep plans drawn from ``generator``
    unless ``plan`` gives them), checked as :func:`global_assign` checks
    them; shared with the fleet's solve, which stages T of them."""
    check_solve_args(config, plan, generator, "global_assign")
    dev = state.device
    lay = dense_layout(graph.num_services, state.num_nodes, config, dev)
    check_weight_budget(lay.sp, config)
    if plan is None:
        plan = draw_plans(generator, config.sweeps, lay.sp, lay.chunk, lay.n_chunks,
                          COMPOSITION_BLOCK if lay.inline_mass else 1)
    inputs = {**state_inputs(state), "service_valid": graph.service_valid,
              **dense_plan_inputs(plan, lay, config, dev, generator)}
    return lay, inputs


def global_assign(
    state: ClusterState,
    graph: CommGraph,
    generator: torch.Generator | None = None,
    config: GlobalSolverConfig = GlobalSolverConfig(),
    w_mm: torch.Tensor | None = None,
    plan: list[SweepPlan] | None = None,
) -> tuple[ClusterState, dict[str, torch.Tensor]]:
    """Re-place every service; returns the new state and solve info.

    The initial point is the current placement, and only configurations
    that improve the true objective are adopted — the result is never worse
    than the input. ``generator`` (a CPU ``torch.Generator``) draws the
    per-sweep plans unless ``plan`` gives them; ``w_mm`` injects a prebuilt
    pair-weight matrix (:func:`prepare_weights`). The solve runs on the
    state's device; on CUDA as a replay of the graph captured for its
    shape, config and operands (``solver/compiled.py``)."""
    lay, inputs = dense_solve_inputs(state, graph, generator, config, plan)
    adj = graph.adj

    def make_body():
        def body(t):
            g = CommGraph(adj=adj, service_valid=t["service_valid"])
            return dense_solve(state_from_inputs(t), g, config, lay, t, w_mm)
        return body

    out = CACHE.run("global_assign", (config, lay), inputs, make_body,
                    operands=(adj, w_mm))
    return solve_result(state, out, inline_mass=torch.tensor(lay.inline_mass))


def solve_result(state: ClusterState, out: dict, **static) -> tuple[ClusterState, dict]:
    """``(new state, info)`` from a solve body's outputs."""
    info = {k: v for k, v in out.items() if k != "pod_node"}
    return state.replace(pod_node=out["pod_node"]), dict(info, **static)


def dense_solve(
    state: ClusterState,
    graph: CommGraph,
    config: GlobalSolverConfig,
    lay: DenseLayout,
    t: dict,
    w_mm: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """One dense solve as a function of device tensors that reads nothing
    back to the host: ``t`` holds the plans (:func:`dense_plan_inputs`).
    Returns the new ``pod_node`` and the info tensors. Marks the phases
    ``setup``, ``sweeps`` / ``swap_sweeps`` and ``ranking`` a sweep, and
    ``epilogue`` (``telemetry/phases.py``)."""
    phase_mark("setup")
    dev = state.device
    f32 = torch.float32
    # over-budget repulsion only exists alongside budget enforcement
    ow = config.overload_weight if config.enforce_capacity else 0.0
    S, N, C, n_chunks, SP = lay.services, lay.nodes, lay.chunk, lay.n_chunks, lay.sp

    replicas, svc_cpu, svc_mem, cur_node, has_pods = _service_aggregates(state, S)
    svc_valid = graph.service_valid & has_pods

    # all service-level arrays padded to SP so chunk ids never alias
    svc_valid = _pad_to(svc_valid, SP, False)
    svc_cpu = _pad_to(svc_cpu, SP)
    svc_mem = _pad_to(svc_mem, SP)
    replicas = _pad_to(replicas, SP)
    cur_node = _pad_to(cur_node, SP, -1)

    mm_dtype = _DTYPES[config.matmul_dtype]
    # rv = replica count per service, zeroed for invalid services: the
    # pair weight is W[s,t] = adj[s,t]·rv[s]·rv[t]; the f32 W is never built
    rv = (replicas * svc_valid)[:S]
    W_mm = w_mm if w_mm is not None else build_pair_weights(graph.adj, rv, SP=SP, dtype=mm_dtype)

    # capacity_frac shrinks the budget everywhere
    cap, mem_cap = node_caps(state, config)
    base_cpu = state.node_base_cpu
    base_mem = state.node_base_mem
    node_valid = state.node_valid

    assign0 = torch.where(svc_valid, torch.clamp(cur_node, 0, N - 1), 0).to(torch.int32)
    # disruption pricing: per-service restart bill = cost × replica count,
    # anchored at the round-start placement
    mc_on = config.move_cost > 0
    pen_vec = config.move_cost * replicas * svc_valid if mc_on else None

    def move_penalty(assign):
        return config.move_cost * torch.sum(
            torch.where(svc_valid & (assign != assign0), replicas, 0.0)
        )

    cols = torch.arange(N, device=dev)

    def one_hot_rows(assign, valid, dtype):
        return ((assign[:, None] == cols[None, :]) & valid[:, None]).to(dtype)

    def loads(assign):
        oh = one_hot_rows(assign, svc_valid, f32)
        return base_cpu + svc_cpu @ oh, base_mem + svc_mem @ oh

    def _balance_terms(cpu_load):
        return pct_balance_terms(cpu_load, cap, node_valid, config.balance_weight, ow)

    w_total = total_pair_weight(graph.adj, rv)

    def objective_fast(assign, cpu_load):
        """Per-sweep best-seen ranking: comm = (ΣW − Σ W·[same])/2 on the
        mm-dtype W, contracted in row blocks with f32 accumulation."""
        kept = torch.zeros((), dtype=f32, device=dev)
        for r0 in range(0, SP, ROW_BLOCK):
            r1 = min(r0 + ROW_BLOCK, SP)
            same = assign[r0:r1, None] == assign[None, :]
            kept = kept + torch.where(same, W_mm[r0:r1], 0).sum(dtype=f32)
        obj = 0.5 * (w_total - kept) + _balance_terms(cpu_load)
        return obj + move_penalty(assign) if mc_on else obj

    use_fused, inline_mass, mass_bj = lay.use_fused, lay.inline_mass, lay.mass_bj
    use_noise = config.noise_temp > 0

    use_swaps = config.swap_every > 0 and C >= 2
    sw_flags = swap_flags(config.sweeps, config.swap_every)
    mem_cap_sw = torch.where(torch.isinf(mem_cap), BIG_CAP, mem_cap)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    gumbel = t.get("gumbel")
    plan = [
        SweepPlan(t["chunk_ids"][i], t["block_rows"][i], t["seeds"][i],
                  None if gumbel is None else gumbel[i])
        for i in range(config.sweeps)
    ]
    temps = list(t["temps"].unbind(0)) if config.sweeps else []

    def swap_step(ids, M, assign, cpu_load, mem_load, admitted):
        """The chunk's swap phase on the post-singles state (``M`` the
        chunk-start neighbor mass; services the single phase just moved sit
        out), the pair weights read from ``W_mm`` at the chunk's ids."""
        return chunk_swap_phase(
            M, W_mm, ids, assign, ids, svc_valid, admitted, node_valid, svc_cpu, svc_mem,
            cpu_load, mem_load, cap, mem_cap_sw, config.balance_weight, ow, pen_vec,
            assign0 if mc_on else None, config.swap_k, enforce_capacity=config.enforce_capacity,
            use_kernels=use_fused)

    def best_seen(assign, cpu_load, best_assign, best_obj):
        obj = objective_fast(assign, cpu_load)
        better = obj < best_obj
        return torch.where(better, assign, best_assign), torch.where(better, obj, best_obj)

    def sweep_phase(do_swap: bool) -> str:
        return "swap_sweeps" if use_swaps and do_swap else "sweeps"

    def make_sweep(do_swap: bool):
        phase = sweep_phase(do_swap)

        def sweep(carry, xs):
            phase_mark(phase)
            sp, temp = xs
            assign, best_assign, best_obj = carry
            assign = assign.clone()
            X = one_hot_rows(assign, svc_valid, mm_dtype)
            cpu_load, mem_load = loads(assign)
            chunk_ids = sp.chunk_ids
            seeds = sp.seeds
            moves, sws = zero, zero
            for c in range(n_chunks):
                ids = chunk_ids[c]
                valid_c = svc_valid[ids]
                # f32 product: a bf16 matmul would round M back to bf16
                M = W_mm[ids].to(f32) @ X.to(f32)
                c_cpu = svc_cpu[ids]
                c_mem = svc_mem[ids]
                cur = assign[ids]
                home = assign0[ids] if mc_on else None
                pen = pen_vec[ids] if mc_on else None
                if use_fused:
                    new_node, admitted, x_rows, d_cpu, d_mem = fused_score_admission(
                        M, cur, c_cpu, c_mem, valid_c,
                        cpu_load, mem_load, cap, mem_cap, node_valid,
                        config.balance_weight, temp, seeds[c],
                        overload_weight=ow, home=home, move_pen=pen,
                        enforce_capacity=config.enforce_capacity,
                        use_noise=use_noise,
                        x_dtype=mm_dtype,
                    )
                    assign[ids] = new_node
                    X[ids] = x_rows
                    cpu_load = cpu_load + d_cpu
                    mem_load = mem_load + d_mem
                else:
                    noise = temp * sp.gumbel[c] if use_noise else None
                    new_node, admitted = reference_score_admission(
                        M, cur, c_cpu, c_mem, valid_c,
                        cpu_load, mem_load, cap, mem_cap, node_valid,
                        config.balance_weight, noise,
                        overload_weight=ow, home=home, move_pen=pen,
                        enforce_capacity=config.enforce_capacity,
                    )
                    assign[ids] = new_node
                    X[ids] = one_hot_rows(new_node, valid_c, mm_dtype)
                    cpu_load, mem_load = commit_moves(cpu_load, mem_load, cur, new_node,
                                                      admitted, c_cpu, c_mem)
                moves = moves + admitted.sum()
                if use_swaps and do_swap:
                    cpu_load, mem_load, n_sw = swap_step(ids, M, assign, cpu_load, mem_load,
                                                         admitted)
                    X[ids] = one_hot_rows(assign[ids], valid_c, mm_dtype)
                    sws = sws + n_sw
            phase_mark("ranking")
            best_assign, best_obj = best_seen(assign, loads(assign)[0], best_assign, best_obj)
            return (assign, best_assign, best_obj), (moves, sws)

        return sweep

    def make_sweep_inline(do_swap: bool):
        phase = sweep_phase(do_swap)

        def sweep_inline(carry, xs):
            """Same decisions as ``sweep`` (M is exact for integer weights),
            but the occupancy matrix never exists: the mass kernel gathers
            the chunk's W row-blocks and rebuilds occupancy from
            ``assign``; per-node loads are carried through the chunks and
            refreshed from the assignment at the sweep boundary."""
            phase_mark(phase)
            sp, temp = xs
            assign, cpu_load, mem_load, best_assign, best_obj = carry
            assign = assign.clone()
            chunk_ids, block_rows = sp.chunk_ids, sp.block_rows
            seeds = sp.seeds
            moves, sws = zero, zero
            for c in range(n_chunks):
                ids = chunk_ids[c]
                blocks = block_rows[c]
                valid_c = svc_valid[ids]
                c_cpu = svc_cpu[ids]
                c_mem = svc_mem[ids]
                cur = assign[ids]
                M = fused_neighbor_mass(
                    W_mm, assign, svc_valid, blocks,
                    num_nodes=N, block_b=COMPOSITION_BLOCK, block_j=mass_bj,
                )
                new_node, admitted, d_cpu, d_mem = fused_score_admission(
                    M, cur, c_cpu, c_mem, valid_c,
                    cpu_load, mem_load, cap, mem_cap, node_valid,
                    config.balance_weight, temp, seeds[c],
                    overload_weight=ow,
                    home=assign0[ids] if mc_on else None,
                    move_pen=pen_vec[ids] if mc_on else None,
                    enforce_capacity=config.enforce_capacity,
                    use_noise=use_noise,
                    emit_x_rows=False,
                )
                assign[ids] = new_node
                cpu_load = cpu_load + d_cpu
                mem_load = mem_load + d_mem
                moves = moves + admitted.sum()
                if use_swaps and do_swap:
                    cpu_load, mem_load, n_sw = swap_step(ids, M, assign, cpu_load, mem_load,
                                                         admitted)
                    sws = sws + n_sw
            # refresh the carried loads from the assignment each sweep:
            # incremental f32 drift stays bounded to one sweep
            phase_mark("ranking")
            cpu_fresh, mem_fresh = loads(assign)
            best_assign, best_obj = best_seen(assign, cpu_fresh, best_assign, best_obj)
            return (assign, cpu_fresh, mem_fresh, best_assign, best_obj), (moves, sws)

        return sweep_inline

    # the result only replaces the input when it beats the input's true
    # objective
    comm_true0 = input_comm_cost(state, graph)
    obj_true0 = input_objective(state, comm_true0, config, cap)
    cpu0, mem0 = loads(assign0)
    obj0 = objective_fast(assign0, cpu0)
    if inline_mass:
        (_, _, _, best_assign, _), outs = scan_sweeps(
            make_sweep_inline, (assign0, cpu0, mem0, assign0, obj0), plan, temps, sw_flags
        )
    else:
        (_, best_assign, _), outs = scan_sweeps(
            make_sweep, (assign0, assign0, obj0), plan, temps, sw_flags
        )
    phase_mark("epilogue")
    moves_per_sweep = torch.stack([m for m, _ in outs]) if outs else zero[None][:0]
    swaps_per_sweep = torch.stack([s for _, s in outs]) if outs else zero[None][:0]

    # best-seen ranking used the fast objective; the adopted value is
    # re-evaluated exactly
    best_comm = exact_comm_cost(graph.adj, rv, best_assign)
    best_obj = best_comm + _balance_terms(loads(best_assign)[0])
    out = adopt(state, best_assign[torch.clamp(state.pod_service, 0, SP - 1)], best_obj,
                obj_true0, config.move_cost)
    out.update(
        moves_per_sweep=moves_per_sweep,
        swaps_per_sweep=swaps_per_sweep,
        # an adopted placement colocates every service's replicas, so its
        # pod-level cost equals the exact service-level cut of best_assign
        communication_cost=torch.where(out["improved"], best_comm, comm_true0),
        load_std=load_std(state.replace(pod_node=out["pod_node"])),
    )
    phase_mark(END)
    return out
