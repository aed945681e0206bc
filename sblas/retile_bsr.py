"""Dense-block BSR retiling: sparse matrix as a list of dense (R x 128)
blocks (SURVEY.md C5/C6 "padded-segment" alternative).

For matrices whose nonzeros cluster into panels (FEM suite), storing the
touched panels *dense* turns the irregular per-nonzero gather into a
gather of contiguous (128, k) X panels and a batched dense contraction:

    Y = segment_sum_over_block_rows( A_blocks @ X[block_col] )

Traffic is block_bytes = dense panels; worthwhile when block density (nnz /
touched-panel area) is above ~15-25%. The planner reports density so callers
can fall back to ELL for scattered matrices.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .formats import CSR, INDEX_DTYPE


@dataclasses.dataclass(frozen=True, eq=False)
class BsrBlocks:
    m: int
    n: int
    nnz: int
    br: int  # block rows (sublane dim)
    bc: int  # block cols (lane dim)
    nblocks: int
    blocks: np.ndarray   # (nblocks, br, bc) dense values
    brow: np.ndarray     # (nblocks,) block-row index (sorted)
    bcol: np.ndarray     # (nblocks,) block-col index
    num_brows: int
    num_bcols: int

    @property
    def density(self) -> float:
        return self.nnz / max(self.blocks.size, 1)

    @property
    def bytes_per_iter(self) -> int:
        return self.blocks.size * self.blocks.itemsize + self.nblocks * 8


def bsr_stats(a: CSR, *, br: int = 128, bc: int = 128) -> dict:
    """Block count/density WITHOUT allocating the dense blocks (cheap probe
    for method auto-selection; dense packing of a scattered matrix would
    explode memory)."""
    m, n = a.shape
    num_bcols = -(-max(n, 1) // bc)
    rows = a.row_ids().astype(np.int64)
    cols = a.indices.astype(np.int64)
    bid = (rows // br) * num_bcols + (cols // bc)
    nblocks = len(np.unique(bid))
    area = max(nblocks, 1) * br * bc
    return {"nblocks": nblocks, "density": a.nnz / area,
            "bytes": area * a.data.itemsize}


def pack_bsr(a: CSR, *, br: int = 128, bc: int = 128) -> BsrBlocks:
    """Dense-block pack: one dense (br, bc) block per touched block of A."""
    return _pack_bsr_impl(a, br=br, bc=bc)


def _pack_bsr_impl(a: CSR, *, br: int, bc: int) -> BsrBlocks:
    m, n = a.shape
    num_brows = -(-max(m, 1) // br)
    num_bcols = -(-max(n, 1) // bc)
    rows = a.row_ids().astype(np.int64)
    cols = a.indices.astype(np.int64)
    bid = (rows // br) * num_bcols + (cols // bc)
    uniq, inv = np.unique(bid, return_inverse=True)
    nblocks = len(uniq)
    blocks = np.zeros((max(nblocks, 1), br, bc), dtype=a.data.dtype)
    np.add.at(blocks, (inv, rows % br, cols % bc), a.data)
    brow = (uniq // num_bcols).astype(INDEX_DTYPE)
    bcol = (uniq % num_bcols).astype(INDEX_DTYPE)
    if nblocks == 0:
        brow = np.zeros(1, INDEX_DTYPE)
        bcol = np.zeros(1, INDEX_DTYPE)
        nblocks = 1
    return BsrBlocks(m, n, a.nnz, br, bc, nblocks, blocks, brow, bcol,
                     num_brows, num_bcols)
