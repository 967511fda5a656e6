"""Kernel 1, the dense neighbour mass (``ops/csrc/mass.cu``): C rows of the
pair weights (SP wide) against the occupancy built from the assignment;
M [C, N] f32 written. Each input byte read once, each output written once."""

from perfbench.peaks import bound_ms as _bound

SYMBOL = "mass_kernel"


def bound_ms(C: int, SP: int, N: int, w_itemsize: int) -> float:
    return _bound(C * SP * w_itemsize + SP * 5 + C * N * 4, 2.0 * C * SP)
