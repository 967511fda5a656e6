"""Kernel 5, the hub groups' mass (``ops/csrc/sparse_mass.cu``): the
group's T column tiles of ``bu`` columns across 256 rows, their slab (8
bytes a column) and tile table (16 bytes a tile); M [blocks·256, N] f32
written. Operations: a multiply-add for each of the ``nnz`` products."""

from perfbench.peaks import bound_ms as _bound

SYMBOL = "hub_mass_kernel"


def bound_ms(T: int, blocks: int, N: int, nnz: float, bu: int = 512,
             w_itemsize: int = 2) -> float:
    return _bound(256 * T * bu * w_itemsize + T * bu * 8 + T * 16 + blocks * 256 * N * 4,
                  2.0 * nnz)
