"""Kernel 6, the fused chunk mass and score (``ops/csrc/mass_score.cu``):
kernel 4's strip and slab reads, the score's row and node vectors and its
five row outputs, the mass kept on chip; the score's instructions a
(row, node) pair (``counts/score.py``) with the ``nnz`` products'
multiply-adds issued beside them."""

from perfbench.counts import score

SYMBOL = "mass_score_kernel"


def bound_ms(C: int, U: int, KB: int, N: int, nnz: float, noise: bool = True,
             w_itemsize: int = 2) -> float:
    nbytes = (C * U * w_itemsize + KB * U * 8 + KB * 8 + C * (4 * 6 + 1) + N * (4 * 4 + 1)
              + C * 4 * 5)
    return score.bound_ms(C, N, noise, nbytes=nbytes, extra_ops=2.0 * nnz)
