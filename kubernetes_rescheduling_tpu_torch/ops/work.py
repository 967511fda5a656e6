"""The work of one kernel launch, from its shapes: the operations it does
and the bytes it must move (each input read once, each output written
once). The formulas are ``chip_smoke.py``'s bounds (``bound_ms``,
``score_bound``, ``admission_bound``) at the launch's static shapes: a
captured graph reads nothing back, so the counts are the dense work of the
shapes, not the data-dependent counts a bound of one run may use (the
mass kernels skip zero weights; the admission race sorts only the rows
that want to move). Multiply-adds count two operations; the score counts
its instructions per (row, node) pair, 97 with noise and 31 without (the
SASS count behind ``score_bound``).

Each wrapper adds its launch's work to its ``work_ops`` / ``work_bytes``
beside ``launches``; ``solver/compiled.py`` reads the deltas of a capture
into the compiled-cost book (``telemetry/costmodel.py``).
"""

from __future__ import annotations

import math

SCORE_OPS_PER_PAIR = {True: 97, False: 31}
# f32 operations of one exchange gain in kernel 8: the kept-mass side (5),
# the two departure-corrected balance terms (9 each), their combination
# (4), the pair and fit masks (11) and the argmax compares (2)
SWAP_OPS_PER_PAIR = 40


def count(fn, ops: float, nbytes: float) -> None:
    """Add one launch's work to wrapper ``fn``'s totals."""
    fn.work_ops += ops
    fn.work_bytes += nbytes


def mass(C: int, SP: int, N: int, w_itemsize: int) -> tuple[float, float]:
    """Kernel 1: C rows of W (SP wide) against the occupancy built on the
    fly from assign and valid (5 bytes a service); M [C, N] f32 written."""
    return 2.0 * C * SP, float(C * SP * w_itemsize + SP * 5 + C * N * 4)


def score(C: int, N: int, use_noise: bool) -> tuple[float, float]:
    """Kernel 2: M read once, six row vectors and five node vectors read,
    five row outputs written."""
    return (float(C * N * SCORE_OPS_PER_PAIR[bool(use_noise)]),
            float(C * N * 4 + C * (4 * 5 + 1) + N * (4 * 4 + 1) + C * 4 * 5))


def admission(C: int, N: int, x_itemsize: int = 0) -> tuple[float, float]:
    """Kernel 3: two comparison sorts of the C rows, three segmented scans
    and two slack compares a row; eight row inputs and the valid byte read,
    new_node, admitted and the two node deltas written (and the one-hot
    ``x_rows`` when asked)."""
    sort = C * math.log2(C) if C > 1 else 0.0
    return (2.0 * sort + 8.0 * C,
            float(C * (8 * 4 + 1) + C * (4 + 1) + N * 4 * 2 + C * N * x_itemsize))


def strips(rows: int, cols: int, out_rows: int, N: int, w_itemsize: int,
           slab: int) -> tuple[float, float]:
    """Kernels 4 and 5: ``rows`` × ``cols`` W strip elements against their
    slabs (a target and a replica factor, 8 bytes a slab entry); M
    [out_rows, N] f32 written."""
    return 2.0 * rows * cols, float(rows * cols * w_itemsize + slab * 8 + out_rows * N * 4)


def mass_score(C: int, cols: int, N: int, w_itemsize: int, slab: int,
               use_noise: bool) -> tuple[float, float]:
    """Kernel 6: kernel 4's strips times the row replica factor, then
    kernel 2's score on the mass it keeps on chip (M neither written nor
    read)."""
    s_ops, s_bytes = score(C, N, use_noise)
    return (2.0 * C * cols + s_ops,
            float(C * cols * w_itemsize + slab * 8 + C * 4) + s_bytes - C * N * 4)


def swap_desire(C: int, N: int, k: int) -> tuple[float, float]:
    """Kernel 7: M [C, N] read once for the row maxima (compares); a row's
    service id, assignment, validity and moved bytes, its node's validity,
    move bill and anchor read (23 bytes a row) and its key written. With
    k >= C it reads and writes nothing."""
    if k >= C:
        return 0.0, 0.0
    return float(C * N), float(C * N * 4 + C * 23 + C * 4)


def swap_decide(C: int, N: int, k: int, w_itemsize: int) -> tuple[float, float]:
    """Kernel 8: the rank counts over the C keys (where k < C), the k x k
    exchange gains (``SWAP_OPS_PER_PAIR`` each) from the k x k entries of M
    and of the pair weights they need; a chunk row's key, service id,
    assignment, validity, moved byte, node validity and demands (27 bytes)
    and a subset row's weight row, node loads and budgets, own mass, move
    bill and anchor (36 bytes) read; new_node, swapped and the assignment
    written at full width (9 bytes a row), n_swaps once; the loads read and
    written once (16 bytes a node). The coupling, the capacity race and
    the commit's sums touch only the candidates and the nodes their swaps
    touch, which the shapes do not fix: they are not counted."""
    rank = float(C * C) if k < C else 0.0
    return (rank + SWAP_OPS_PER_PAIR * k * k,
            float(k * k * (4 + w_itemsize) + C * 27 + k * 36 + C * 9 + 8 + N * 16))


def pod_cross(E2: int, SP: int, P: int) -> tuple[float, float]:
    """Kernel 9: an edge's slot ids and weight read and its term written (16
    bytes), the slot offsets (8 bytes a slot) and the pods' sorted keys (8
    bytes a pod) read once; the pair count, the difference and the weight's
    product, three f32 operations an edge. The searches depend on the
    placement, which the shapes do not fix: they are not counted."""
    return 3.0 * E2, float(E2 * 16 + (SP + 1) * 8 + P * 8)
