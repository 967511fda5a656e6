"""The measured multichip harness: the fleet scan over the dp mesh — the
port of ``kubernetes_rescheduling_tpu.bench.multichip``.

- :func:`fleet_scan_rounds_dp`: ``bench.scan.fleet_scan_rounds`` over this
  rank's contiguous block of tenants (one replay of the block's captured
  program advances them K rounds), then ONE ``gather(..., mesh, "dp")`` of
  the blocks' flat bundles, outside the captured graph. The body is the
  single-device scan's, so the dp plane decides as that scan does, bit for
  bit. Without a process group (dp = 1) it is the single-device call.
- :func:`decode_fleet_block_dp`: the gathered bundle is dp block bundles
  back to back; re-split, decode each with ``decode_fleet_block``, merge
  on the tenant axis.
- :func:`bench_multichip`: timed scan blocks over the dp mesh, ONE counted
  ``round_end`` read a block, the per-device step attribution through
  ``telemetry.mesh.MeshPlane``, and the ``fleet_scan_rounds_per_sec``
  headline, with the JAX package's record keys. ``device_kind`` is the
  port's ledger key (``telemetry.perf_ledger.device_kind``: the card's name,
  ``"cpu"`` on the CPU), so a card's records never share a series with
  the TPU's. Under ``torchrun`` every rank runs the same blocks and returns
  the same record.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch.bench import scan as scan_mod
from kubernetes_rescheduling_tpu_torch.parallel.fleet import (
    _block,
    _fleet_mesh,
    dp_device_names,
)
from kubernetes_rescheduling_tpu_torch.parallel.mesh import Mesh, gather
from kubernetes_rescheduling_tpu_torch.telemetry.registry import get_registry


def fleet_scan_rounds_dp(states, graphs, edges, policy_id: int, threshold: float,
                         gumbel: torch.Tensor | None = None, *, rounds: int,
                         pinned: bool = True, mesh: Mesh | None = None) -> torch.Tensor:
    """:func:`bench.scan.fleet_scan_rounds` with the tenant axis sharded
    over the mesh's ``dp`` ranks: each rank scans its block of tenants
    ``rounds`` rounds, and the block bundles are gathered in rank order.
    ``states`` / ``graphs`` / ``edges`` are per tenant (``states`` may be
    stacked); ``gumbel`` the ``random`` policy's rows [rounds, T, N]. The
    tenant count must be a multiple of dp. Returns the flat bundle
    (:func:`decode_fleet_block_dp` unpacks it)."""
    from kubernetes_rescheduling_tpu_torch.solver.fleet import tenant_states

    T = len(graphs)
    sts = tenant_states(states, T)
    mesh = _fleet_mesh(T, mesh, device=sts[0].device)
    kw = dict(rounds=int(rounds), pinned=bool(pinned))
    if mesh.groups["dp"] is None:
        return scan_mod.fleet_scan_rounds(sts, list(graphs), list(edges), policy_id, threshold,
                                          gumbel, **kw)
    sl = _block(mesh, T)
    flat = scan_mod.fleet_scan_rounds(sts[sl], list(graphs)[sl], list(edges)[sl], policy_id,
                                      threshold, gumbel[:, sl] if gumbel is not None else None,
                                      **kw)
    return gather(flat, mesh, "dp").reshape(-1)


def decode_fleet_block_dp(flat, *, rounds: int, tenants: int, num_nodes: int, dp: int):
    """Decode the dp bundle: ``(decisions i64[K, T, 4], hazard bool[K, T, N],
    landed i64[K, T], metrics f32[K, T, 2])``, as
    ``bench.scan.decode_fleet_block`` returns them."""
    flat = np.asarray(flat, dtype=np.float32)
    if tenants % dp:
        raise ValueError(f"tenants {tenants} not divisible by dp={dp}")
    per = tenants // dp
    block = flat.reshape(dp, -1)
    parts = [scan_mod.decode_fleet_block(block[d], rounds=rounds, tenants=per,
                                         num_nodes=num_nodes) for d in range(dp)]
    return tuple(np.concatenate([p[i] for p in parts], axis=1) for i in range(4))


def _rtt_ms(reps: int = 7, device: str | torch.device | None = DEFAULT_DEVICE) -> float:
    """The host↔device round-trip floor: the median of ``reps`` one-element
    round trips (an add on the device, read back)."""
    dev = resolve_device(device)
    x = torch.zeros(1, device=dev)
    float((x + 1.0).cpu())  # warm
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        float((x + float(i)).cpu())
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2] * 1e3


def _captures(fn: str) -> float:
    return get_registry().counter("cuda_graph_captures_total",
                                  labelnames=("fn",)).labels(fn=fn).value


def bench_multichip(tenants: int = 16, n_services: int = 2000, n_nodes: int = 256,
                    rounds: int = 8, reps: int = 3, *, registry=None,
                    rtt_ms: float | None = None,
                    device: str | torch.device | None = DEFAULT_DEVICE,
                    mesh: Mesh | None = None) -> dict:
    """The measured multichip cell: :func:`fleet_scan_rounds_dp` over
    ``tenants`` same-shaped power-law tenants, timed as whole fenced blocks
    (dispatch → K rounds on every rank → the gather → ONE ``round_end``
    read). Headline: ``fleet_scan_rounds_per_sec``, rounds over the median
    block wall of ``reps`` blocks after one untimed block (the capture).

    Every block feeds a ``MeshPlane`` (the fence attributed across the dp
    devices by each block's pulled comm-cost column — an attribution, not
    a per-device clock), so the record carries the per-device step rollup
    and the imbalance ratio; ``device_step_reading`` is its own ledger
    series (``multichip_device_step_ms_p99``, lower is better)."""
    from kubernetes_rescheduling_tpu_torch.bench.harness import make_fleet_problem
    from kubernetes_rescheduling_tpu_torch.objectives.metrics import comm_edge_list
    from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS
    from kubernetes_rescheduling_tpu_torch.telemetry.mesh import MeshPlane
    from kubernetes_rescheduling_tpu_torch.telemetry.perf_ledger import device_kind

    dev = resolve_device(device)
    registry = registry if registry is not None else get_registry()
    reps = max(1, int(reps))
    mesh = _fleet_mesh(int(tenants), mesh, device=dev)
    dev = mesh.device
    dp = mesh.shape["dp"]
    names = dp_device_names(mesh)
    plane = MeshPlane(registry, device_names=names)
    if rtt_ms is None:
        rtt_ms = _rtt_ms(device=dev)

    states, graphs = make_fleet_problem(tenants=tenants, n_services=n_services,
                                        n_nodes=n_nodes, device=dev)
    edges = [comm_edge_list(g) for g in graphs]
    pid = POLICY_IDS["communication"]
    c0 = _captures("fleet_scan_rounds")

    def block():
        return scan_mod.pull_block(
            fleet_scan_rounds_dp(states, graphs, edges, pid, 30.0, rounds=rounds, mesh=mesh),
            registry=registry)

    flat = block()  # the capture, outside the timed blocks
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        flat = block()
        elapsed = time.perf_counter() - t0
        times.append(elapsed)
        _dec, _hz, _landed, metrics = decode_fleet_block_dp(
            flat, rounds=rounds, tenants=tenants, num_nodes=n_nodes, dp=dp)
        # per-tenant comm cost summed over the block: tenant block i's share
        # of the fence lands on device i (the fleet loop's weights)
        summary, _event = plane.observe_block(
            dispatch_s=elapsed, transfer_bytes=int(flat.nbytes),
            weights=metrics[..., 0].sum(axis=0), rounds=rounds, round=(i + 1) * rounds)
        scan_mod.count_scan_block(registry, rounds)

    block_s = sorted(times)[len(times) // 2]
    rounds_per_sec = rounds / max(block_s, 1e-9)
    step = plane.health_block()["step_ms"]
    kind = device_kind(dev)
    base_extra = {"scenario": "multichip", "tenants": tenants, "n_devices": dp,
                  "device_kind": kind, "devices": list(names)}
    return {
        "metric": "fleet_scan_rounds_per_sec",
        "value": round(rounds_per_sec, 3),
        "unit": "rounds/s",
        "better": "higher",
        "extra": {
            **base_extra,
            "services_per_tenant": n_services,
            "nodes_per_tenant": n_nodes,
            "dp": dp,
            "rounds_per_block": rounds,
            "reps": reps,
            "block_ms": round(block_s * 1e3, 3),
            # fenced ≈ rtt + device + dispatch
            "rtt_ms": round(rtt_ms, 3),
            "dispatch_frac": round(min(1.0, (rtt_ms / 1e3) / max(block_s, 1e-9)), 4),
            "step_ms_p50": round(step["p50"], 4),
            "step_ms_p99": round(step["p99"], 4),
            "step_ms_max": round(step["max"], 4),
            "imbalance_ratio": round(summary["ratio"], 4),
            "worst_device": summary["worst_device"],
            # captures of the block's program in this run (one on the card,
            # none on the CPU, where the body runs eagerly)
            "fleet_scan_rounds_dp_traces": int(_captures("fleet_scan_rounds") - c0),
        },
        "device_step_reading": {
            "metric": "multichip_device_step_ms_p99",
            "value": round(step["p99"], 4),
            "unit": "ms",
            "better": "lower",
            "extra": {**base_extra, "step_ms_p50": round(step["p50"], 4),
                      "step_ms_max": round(step["max"], 4),
                      "imbalance_ratio": round(summary["ratio"], 4)},
        },
    }
