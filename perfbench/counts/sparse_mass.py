"""Kernel 4, the chunk mass of the block-local form
(``ops/csrc/sparse_mass.cu``): each of the chunk's C rows reads its
block's strip of U = ``u_reg`` columns, the KB blocks' slabs (a target
and a replica factor, 8 bytes a column) and block offsets; M [C, nn] f32
written. Operations: a multiply-add for each of the ``nnz`` products the
inputs need (the rows' call pairs)."""

from perfbench.peaks import bound_ms as _bound

SYMBOL = "chunk_mass_kernel"


def bound_ms(C: int, U: int, KB: int, nn: int, nnz: float, w_itemsize: int = 2) -> float:
    return _bound(C * U * w_itemsize + KB * U * 8 + KB * 8 + C * nn * 4, 2.0 * nnz)
