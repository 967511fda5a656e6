"""Kernel 3, the admission race (``ops/csrc/admission.cu``): eight row
inputs and the valid byte read, new node and admitted written, the two
per-node load deltas written. Its operations (comparison sorts of at most
C rows, segmented scans) bound it a hundredth as tightly as its bytes at
the benchmark's shapes, so the bytes decide."""

import math

from perfbench.peaks import bound_ms as _bound

SYMBOL = "admission_kernel"


def bound_ms(C: int, N: int) -> float:
    sort = C * math.log2(C) if C > 1 else 0.0
    return _bound(C * (8 * 4 + 1) + C * (4 + 1) + N * 4 * 2, 2.0 * sort + 8.0 * C)
