"""Carry state across from the JAX package: its ``ClusterState``,
``CommGraph``, ``SparseCommGraph`` and ``GlobalSolverConfig`` fields,
handed over as numpy arrays and plain values, become the port's — the
scheduler's equivalent of carrying weights across. Nothing here imports
the JAX package; a caller that holds JAX objects turns them into arrays
first (``np.asarray`` of each field).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch.core.sparsegraph import SparseCommGraph, integral
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.solver.global_solver import GlobalSolverConfig

STATE_ARRAYS = (
    "node_cpu_cap", "node_mem_cap", "node_base_cpu", "node_base_mem", "node_valid",
    "node_lex_rank", "pod_node", "pod_service", "pod_cpu", "pod_mem", "pod_valid",
)
STATE_NAMES = ("node_names", "pod_names")
_DTYPES = {
    "node_valid": torch.bool, "pod_valid": torch.bool, "service_valid": torch.bool,
    "node_lex_rank": torch.int32, "pod_node": torch.int32, "pod_service": torch.int32,
    "u_ids": torch.int32, "edges_src": torch.int32, "edges_dst": torch.int32,
    "perm": torch.int32, "inv": torch.int32,
}


def _tensor(name: str, a, dev: torch.device) -> torch.Tensor:
    # np.array copies: the port owns its state, whatever the caller holds
    return torch.as_tensor(np.array(a), device=dev).to(_DTYPES.get(name, torch.float32))


def state_from_arrays(
    d: Mapping[str, Any], device: str | torch.device | None = DEFAULT_DEVICE
) -> ClusterState:
    """A :class:`ClusterState` from a mapping of the JAX state's fields
    (arrays; ``node_names``/``pod_names`` optional sequences)."""
    dev = resolve_device(device)
    missing = [k for k in STATE_ARRAYS if k not in d]
    if missing:
        raise KeyError(f"state arrays missing: {missing}")
    return ClusterState(
        **{k: _tensor(k, d[k], dev) for k in STATE_ARRAYS},
        **{k: tuple(d.get(k, ())) for k in STATE_NAMES},
    )


def graph_from_arrays(
    d: Mapping[str, Any], device: str | torch.device | None = DEFAULT_DEVICE
) -> CommGraph:
    """A :class:`CommGraph` from ``adj``, ``service_valid`` and optional
    ``names``."""
    dev = resolve_device(device)
    return CommGraph(
        adj=_tensor("adj", d["adj"], dev),
        service_valid=_tensor("service_valid", d["service_valid"], dev),
        names=tuple(d.get("names", ())),
    )


SPARSE_ARRAYS = (
    "w_local", "u_ids", "edges_src", "edges_dst", "edges_w", "perm", "inv", "service_valid",
)
SPARSE_STATIC = (
    "block_toff", "block_ntiles", "hub_blocks", "regular_blocks", "zero_toff", "bu",
    "reg_tiles", "num_services",
)


def sparse_graph_from_arrays(
    d: Mapping[str, Any], device: str | torch.device | None = DEFAULT_DEVICE
) -> SparseCommGraph:
    """A :class:`SparseCommGraph` from the JAX graph's fields: its arrays
    (``dense_adj`` optional, None for multi-block graphs) and its static
    metadata (``block_toff`` … ``num_services`` and optional ``names``).
    Whether the weights are integers is read off ``edges_w``."""
    dev = resolve_device(device)
    missing = [k for k in SPARSE_ARRAYS + SPARSE_STATIC if k not in d]
    if missing:
        raise KeyError(f"sparse graph fields missing: {missing}")
    static = {
        k: (int(d[k]) if isinstance(d[k], (int, np.integer)) else tuple(int(x) for x in d[k]))
        for k in SPARSE_STATIC
    }
    dense = d.get("dense_adj")
    return SparseCommGraph(
        **{k: _tensor(k, d[k], dev) for k in SPARSE_ARRAYS},
        dense_adj=None if dense is None else _tensor("dense_adj", dense, dev),
        names=tuple(d.get("names", ())),
        integral_weights=integral(d["edges_w"]),
        **static,
    )


def config_from_dict(d: Mapping[str, Any]) -> GlobalSolverConfig:
    """A :class:`GlobalSolverConfig` from the JAX config's fields (unknown
    keys raise). The JAX package's ``fused_epilogue="interpret"`` — its
    kernels through the Pallas interpreter — is this port's ``"on"``."""
    known = {f.name for f in dataclasses.fields(GlobalSolverConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise KeyError(f"unknown solver config fields: {unknown}")
    values = dict(d)
    if values.get("fused_epilogue") == "interpret":
        values["fused_epilogue"] = "on"
    return GlobalSolverConfig(**values)
