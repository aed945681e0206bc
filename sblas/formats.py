"""Host-side sparse matrix containers and conversions (layer L0).

Mirrors the capability surface of the reference's format utilities
(COO->CSR/CSC conversion, sort/dedup, triangular extraction; see SURVEY.md
C2/C3 -- reference paths unverifiable, empty mount) but is a fresh numpy
implementation. Index dtype is int32 (sufficient for SuiteSparse-class
matrices, half the index bandwidth of int64 on the device); values are
float32 or float64.

All containers are immutable-by-convention numpy holders. Device-side layouts
(ELL / degree buckets / dense blocks) are built from these by
``sblas.retile`` and ``sblas.retile_bsr``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

INDEX_DTYPE = np.int32
VALUE_DTYPES = (np.float32, np.float64, np.complex64, np.complex128)


def _check_values(data: np.ndarray) -> np.ndarray:
    data = np.asarray(data)
    if data.dtype not in tuple(np.dtype(d) for d in VALUE_DTYPES):
        # Complex inputs of odd precision widen to complex128; everything else
        # (ints, bools, f16) widens to float64. Never silently drop imag parts.
        if np.issubdtype(data.dtype, np.complexfloating):
            data = data.astype(np.complex128)
        else:
            data = data.astype(np.float64)
    return data


def _check_index(idx: np.ndarray) -> np.ndarray:
    idx = np.asarray(idx)
    if idx.size and idx.min(initial=0) < 0:
        # negative indices silently wrap in gathers/scatters — reject
        raise ValueError("negative index")
    if idx.dtype != INDEX_DTYPE:
        if idx.size and (idx.max(initial=0) > np.iinfo(INDEX_DTYPE).max):
            raise ValueError("index exceeds int32 range")
        idx = idx.astype(INDEX_DTYPE)
    return idx


@dataclasses.dataclass(frozen=True, eq=False)
class COO:
    """Coordinate-format sparse matrix (row, col, data triplets)."""

    shape: Tuple[int, int]
    row: np.ndarray
    col: np.ndarray
    data: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "row", _check_index(self.row))
        object.__setattr__(self, "col", _check_index(self.col))
        object.__setattr__(self, "data", _check_values(self.data))
        if not (len(self.row) == len(self.col) == len(self.data)):
            raise ValueError("row/col/data length mismatch")

    @property
    def nnz(self) -> int:
        return len(self.data)

    @property
    def dtype(self):
        return self.data.dtype

    def todense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        np.add.at(out, (self.row, self.col), self.data)
        return out

    def tocsr(self) -> "CSR":
        return coo_to_csr(self)

    def tocsc(self) -> "CSC":
        return coo_to_csc(self)


@dataclasses.dataclass(frozen=True, eq=False)
class CSR:
    """Compressed sparse row. ``indptr`` has length ``shape[0]+1``; column
    indices within each row are sorted ascending and unique."""

    shape: Tuple[int, int]
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "indptr", _check_index(self.indptr))
        object.__setattr__(self, "indices", _check_index(self.indices))
        object.__setattr__(self, "data", _check_values(self.data))
        if len(self.indptr) != self.shape[0] + 1:
            raise ValueError("indptr length must be nrows+1")
        if len(self.indices) != len(self.data):
            raise ValueError("indices/data length mismatch")

    @property
    def nnz(self) -> int:
        return len(self.data)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def row_ids(self) -> np.ndarray:
        """Per-nnz row index (the COO row array in CSR order)."""
        return np.repeat(
            np.arange(self.shape[0], dtype=INDEX_DTYPE), self.row_lengths
        )

    def tocoo(self) -> COO:
        return COO(self.shape, self.row_ids(), self.indices.copy(), self.data.copy())

    def tocsc(self) -> "CSC":
        t = csr_transpose(self)
        return CSC(self.shape, t.indptr, t.indices, t.data)

    def todense(self) -> np.ndarray:
        return self.tocoo().todense()

    def astype(self, dtype) -> "CSR":
        return CSR(self.shape, self.indptr, self.indices, self.data.astype(dtype))

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.data, self.indices, self.indptr), shape=self.shape
        )

    @staticmethod
    def from_scipy(m) -> "CSR":
        m = m.tocsr()
        m.sort_indices()
        m.sum_duplicates()
        return CSR(m.shape, m.indptr, m.indices, m.data)


@dataclasses.dataclass(frozen=True, eq=False)
class CSC:
    """Compressed sparse column. ``indptr`` has length ``shape[1]+1``."""

    shape: Tuple[int, int]
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "indptr", _check_index(self.indptr))
        object.__setattr__(self, "indices", _check_index(self.indices))
        object.__setattr__(self, "data", _check_values(self.data))
        if len(self.indptr) != self.shape[1] + 1:
            raise ValueError("indptr length must be ncols+1")

    @property
    def nnz(self) -> int:
        return len(self.data)

    @property
    def dtype(self):
        return self.data.dtype

    def tocsr(self) -> CSR:
        # CSC of A is CSR of A^T; transposing that CSR yields CSR of A.
        as_csr_of_t = CSR((self.shape[1], self.shape[0]), self.indptr, self.indices, self.data)
        t = csr_transpose(as_csr_of_t)
        return CSR(self.shape, t.indptr, t.indices, t.data)

    def tocoo(self) -> COO:
        col = np.repeat(
            np.arange(self.shape[1], dtype=INDEX_DTYPE), np.diff(self.indptr)
        )
        return COO(self.shape, self.indices.copy(), col, self.data.copy())

    def todense(self) -> np.ndarray:
        return self.tocoo().todense()

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csc_matrix(
            (self.data, self.indices, self.indptr), shape=self.shape
        )


def coo_to_csr(a: COO, *, sum_duplicates: bool = True) -> CSR:
    """Sort triplets by (row, col), optionally merge duplicates, compress rows."""
    m, n = a.shape
    order = np.lexsort((a.col, a.row))
    row = a.row[order]
    col = a.col[order]
    data = a.data[order]
    if sum_duplicates and len(row):
        # Boundary where (row, col) changes.
        new = np.empty(len(row), dtype=bool)
        new[0] = True
        np.logical_or(row[1:] != row[:-1], col[1:] != col[:-1], out=new[1:])
        group = np.cumsum(new) - 1
        ngroups = int(group[-1]) + 1
        merged = np.zeros(ngroups, dtype=data.dtype)
        np.add.at(merged, group, data)
        row = row[new]
        col = col[new]
        data = merged
    counts = np.bincount(row, minlength=m).astype(INDEX_DTYPE)
    indptr = np.zeros(m + 1, dtype=INDEX_DTYPE)
    np.cumsum(counts, out=indptr[1:])
    return CSR((m, n), indptr, col, data)


def coo_to_csc(a: COO) -> CSC:
    at = COO((a.shape[1], a.shape[0]), a.col, a.row, a.data)
    csr_t = coo_to_csr(at)
    return CSC(a.shape, csr_t.indptr, csr_t.indices, csr_t.data)


def csr_transpose(a: CSR) -> CSR:
    """CSR of A^T.

    A stable sort of the nnz stream by column key yields exactly the
    transpose's CSR order: entries grouped by column, and within each column
    ordered by source row (CSR order is row-major, so stability preserves it).
    """
    m, n = a.shape
    counts = np.bincount(a.indices, minlength=n).astype(INDEX_DTYPE)
    indptr = np.zeros(n + 1, dtype=INDEX_DTYPE)
    np.cumsum(counts, out=indptr[1:])
    order = np.argsort(a.indices, kind="stable")
    return CSR((n, m), indptr, a.row_ids()[order], a.data[order])


def tril(a: CSR, k: int = 0, *, unit_diagonal: bool = False) -> CSR:
    """Extract the lower-triangular part (col <= row + k).

    With ``unit_diagonal`` the stored diagonal is replaced with exact 1.0
    (entries are kept so indptr stays dense in rows). Rows missing a diagonal
    entry get one inserted when ``unit_diagonal`` or ``ensure_diagonal``-style
    SpTRSV use requires it — handled in `sblas.ops.sptrsv` preprocessing.
    """
    coo = a.tocoo()
    mask = coo.col <= coo.row + k
    out = COO(a.shape, coo.row[mask], coo.col[mask], coo.data[mask]).tocsr()
    if unit_diagonal:
        d = out.tocoo()
        data = d.data.copy()
        data[d.row == d.col] = 1.0
        out = COO(a.shape, d.row, d.col, data).tocsr()
    return out


def triu(a: CSR, k: int = 0) -> CSR:
    coo = a.tocoo()
    mask = coo.col >= coo.row + k
    return COO(a.shape, coo.row[mask], coo.col[mask], coo.data[mask]).tocsr()


def has_full_diagonal(a: CSR) -> bool:
    """True iff every row i (i < min(shape)) stores an explicit (i, i) entry."""
    m = min(a.shape)
    coo = a.tocoo()
    diag_rows = np.unique(coo.row[coo.row == coo.col])
    return len(diag_rows) == m


def ensure_sorted_indices(a: CSR) -> CSR:
    """Return an equivalent CSR with per-row sorted, deduplicated columns."""
    return a.tocoo().tocsr()
