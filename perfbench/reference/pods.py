"""Plain pod expansion of a service call graph, as the per-pod cells
define it: every undirected call pair ``(s, t)`` of services becomes every
pair (pod of ``s``, pod of ``t``), each carrying the call pair's whole
weight. NumPy only, nothing of the port.
"""

from __future__ import annotations

import numpy as np


def pod_services(services: int, replicas: int) -> np.ndarray:
    """i64[S·R]: each pod's service, pods grouped by service (pod
    ``s·R + r`` is replica ``r`` of service ``s``)."""
    return np.repeat(np.arange(services, dtype=np.int64), replicas)


def expand(ii: np.ndarray, jj: np.ndarray,
           pod_service: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The pod pairs of the call pairs ``(ii[e], jj[e])``: ``(pa, pb,
    call)``, ``pa[k]`` a pod of ``ii[call[k]]`` and ``pb[k]`` one of
    ``jj[call[k]]``; call pair by call pair, and within one by ``pa``,
    then ``pb``, each in ascending pod id."""
    ii, jj = np.asarray(ii, dtype=np.int64), np.asarray(jj, dtype=np.int64)
    svc = np.asarray(pod_service, dtype=np.int64)
    S = int(max(svc.max(initial=-1), ii.max(initial=-1), jj.max(initial=-1))) + 1
    order = np.argsort(svc, kind="stable")
    counts = np.bincount(svc, minlength=S)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ca, cb = counts[ii], counts[jj]
    m = ca * cb
    call = np.repeat(np.arange(len(ii), dtype=np.int64), m)
    r = np.arange(int(m.sum()), dtype=np.int64) - np.repeat(np.cumsum(m) - m, m)
    pa = order[starts[ii][call] + r // cb[call]]
    pb = order[starts[jj][call] + r % cb[call]]
    return pa, pb, call


def call_index(ii: np.ndarray, jj: np.ndarray, services: int, a: np.ndarray,
               b: np.ndarray) -> np.ndarray:
    """i64: for each service pair ``(a[k], b[k])`` in either order, its
    index among the call pairs ``(ii, jj)`` (``ii < jj``, row-major)."""
    keys = np.asarray(ii, dtype=np.int64) * services + np.asarray(jj, dtype=np.int64)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    want = lo.astype(np.int64) * services + hi
    idx = np.searchsorted(keys, want)
    if not np.array_equal(keys[np.minimum(idx, len(keys) - 1)], want):
        raise ValueError("a pair that is not a call pair")
    return idx
