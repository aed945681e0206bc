"""Matrix Market (.mtx) reader/writer (layer L0).

Covers the full capability of the reference's ``mmio``-style loader
(SURVEY.md C1): ``coordinate`` and dense ``array`` formats;
real/integer/pattern/complex fields; general/symmetric/skew-symmetric/
hermitian symmetry; 1-based indices; ``%`` comments; ``.gz`` transparency.
Parsing is chunked numpy text parsing (with a C++ body parser for the hot
real-coordinate case) rather than line-by-line C — fast enough for
SuiteSparse-class files (SURVEY.md C1 note).

Parity is tested round-trip against ``scipy.io.mmread``/``mmwrite`` on a
generated corpus (tests/test_io.py).
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Union

import numpy as np

from .formats import COO, CSR, coo_to_csr

_FIELDS = {"real", "integer", "pattern", "double", "complex"}
_SYMMETRIES = {"general", "symmetric", "skew-symmetric", "hermitian"}


def _open(path: Union[str, Path]):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, "rt")
    return open(path, "r")


def _resolve_dtype(field: str, dtype):
    """Complex fields force a complex dtype; real fields keep the request."""
    if field == "complex":
        if not np.issubdtype(np.dtype(dtype), np.complexfloating):
            return np.complex128
    return dtype


def _read_header(f, path):
    header = f.readline().strip().lower().split()
    if len(header) < 5 or header[0] != "%%matrixmarket" or header[1] != "matrix":
        raise ValueError(f"not a MatrixMarket matrix file: {path}")
    fmt, field, symmetry = header[2], header[3], header[4]
    if fmt not in ("coordinate", "array"):
        raise ValueError(f"unsupported format {fmt!r}")
    if field not in _FIELDS:
        raise ValueError(f"unsupported field {field!r}")
    if symmetry not in _SYMMETRIES:
        raise ValueError(f"unsupported symmetry {symmetry!r}")
    if fmt == "array" and field == "pattern":
        raise ValueError("pattern field is invalid for array format")
    # Skip comments, read the size line.
    line = f.readline()
    while line.startswith("%") or not line.strip():
        line = f.readline()
    sizes = [int(t) for t in line.split()]
    return fmt, field, symmetry, sizes


def _parse_coordinate(body, nnz, field, dtype):
    """Parse a coordinate body -> (row, col, data) 0-based."""
    pattern = field == "pattern"
    if field != "complex":
        parsed = None
        from . import native

        try:
            parsed = native.parse_mtx_body(body.encode(), nnz, not pattern)
        except ValueError:
            raise
        except Exception:
            parsed = None
        if parsed is not None:
            row64, col64, vals = parsed
            row = row64.astype(np.int64)
            col = col64.astype(np.int64)
            data = np.ones(nnz, dtype=dtype) if pattern else vals.astype(dtype)
            return row, col, data

    ncols = {"pattern": 2, "complex": 4}.get(field, 3)
    toks = np.array(body.split(), dtype=np.float64)
    if len(toks) < nnz * ncols:
        raise ValueError(
            f"truncated .mtx body: expected {nnz * ncols} tokens, got {len(toks)}"
        )
    toks = toks[: nnz * ncols].reshape(nnz, ncols)
    row = toks[:, 0].astype(np.int64) - 1  # 1-based -> 0-based
    col = toks[:, 1].astype(np.int64) - 1
    if pattern:
        data = np.ones(nnz, dtype=dtype)
    elif field == "complex":
        data = (toks[:, 2] + 1j * toks[:, 3]).astype(dtype)
    else:
        data = toks[:, 2].astype(dtype)
    return row, col, data


def _parse_array(body, m, n, field, symmetry, dtype):
    """Parse a dense ``array`` body (column-major) -> ndarray (m, n).

    Non-general symmetries store only the on/below-diagonal part per column
    (skew-symmetric omits the diagonal), exactly as ``scipy.io.mmread``.
    """
    toks = np.array(body.split(), dtype=np.float64)
    if field == "complex":
        if len(toks) % 2:
            raise ValueError("odd token count in complex array body")
        vals = toks[0::2] + 1j * toks[1::2]
    else:
        vals = toks
    vals = vals.astype(dtype)

    dense = np.zeros((m, n), dtype=dtype)
    if symmetry == "general":
        if len(vals) < m * n:
            raise ValueError(
                f"truncated array body: expected {m * n} values, got {len(vals)}"
            )
        return np.ascontiguousarray(vals[: m * n].reshape(n, m).T)

    if m != n:
        raise ValueError(f"{symmetry} array matrix must be square, got {m}x{n}")
    start = 1 if symmetry == "skew-symmetric" else 0
    counts = np.maximum(m - np.arange(n) - start, 0)
    total = int(counts.sum())
    if len(vals) < total:
        raise ValueError(
            f"truncated array body: expected {total} values, got {len(vals)}"
        )
    cols = np.repeat(np.arange(n), counts)
    rows = np.concatenate(
        [np.arange(j + start, m) for j in range(n)]
    ) if n else np.empty(0, dtype=np.int64)
    dense[rows, cols] = vals[:total]
    mirror = {"symmetric": lambda v: v,
              "skew-symmetric": lambda v: -v,
              "hermitian": np.conj}[symmetry]
    off = rows != cols
    dense[cols[off], rows[off]] = mirror(dense[rows[off], cols[off]])
    return dense


def read_mtx_dense(path: Union[str, Path], dtype=np.float64) -> np.ndarray:
    """Read any .mtx file as a dense ndarray (symmetry expanded).

    For ``array``-format files this is the natural representation; coordinate
    files are densified (small matrices only).
    """
    coo = read_mtx_coo(path, dtype=dtype)
    return coo.todense()


def read_mtx_coo(path: Union[str, Path], dtype=np.float64) -> COO:
    """Parse a Matrix Market file into COO (symmetry expanded).

    Supports both ``coordinate`` and dense ``array`` formats; array files are
    sparsified (explicit zeros dropped).
    """
    with _open(path) as f:
        fmt, field, symmetry, sizes = _read_header(f, path)
        body = f.read()
    dtype = _resolve_dtype(field, dtype)

    if fmt == "array":
        m, n = sizes[0], sizes[1]
        dense = _parse_array(body, m, n, field, symmetry, dtype)
        row, col = np.nonzero(dense)
        return COO((m, n), row.astype(np.int64), col.astype(np.int64),
                   dense[row, col])

    m, n, nnz = sizes[0], sizes[1], sizes[2]
    row, col, data = _parse_coordinate(body, nnz, field, dtype)

    # 0-based or otherwise out-of-range indices must fail loudly, not wrap
    # through downstream gathers.
    if nnz and (row.min(initial=0) < 0 or col.min(initial=0) < 0
                or row.max(initial=-1) >= m or col.max(initial=-1) >= n):
        raise ValueError(
            f"index out of range in {path}: rows in "
            f"[{row.min() + 1}, {row.max() + 1}], cols in "
            f"[{col.min() + 1}, {col.max() + 1}] (1-based) vs shape {m}x{n}"
        )

    if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
        off = row != col
        if symmetry == "skew-symmetric":
            mirrored = -data[off]
        elif symmetry == "hermitian":
            mirrored = np.conj(data[off])
        else:
            mirrored = data[off]
        row_full = np.concatenate([row, col[off]])
        col_full = np.concatenate([col, row[off]])
        data = np.concatenate([data, mirrored])
        row, col = row_full, col_full

    return COO((m, n), row, col, data)


def read_mtx(path: Union[str, Path], dtype=np.float64) -> CSR:
    """Parse a .mtx file straight to canonical CSR (sorted, deduplicated)."""
    return coo_to_csr(read_mtx_coo(path, dtype=dtype))


def write_mtx(path: Union[str, Path], a, *, symmetry: str = "general") -> None:
    """Write COO/CSR as a MatrixMarket coordinate file (1-based).

    Real values write the ``real`` field; complex values write ``complex``
    (``i j re im`` rows).
    """
    coo = a.tocoo() if isinstance(a, CSR) else a
    if symmetry != "general":
        raise ValueError("only general symmetry supported for writing")
    path = Path(path)
    is_complex = np.issubdtype(coo.data.dtype, np.complexfloating)
    field = "complex" if is_complex else "real"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        f.write(f"{coo.shape[0]} {coo.shape[1]} {coo.nnz}\n")
        # Vectorized formatting via savetxt on a stacked array.
        idx = [coo.row.astype(np.int64) + 1, coo.col.astype(np.int64) + 1]
        if is_complex:
            stacked = np.column_stack(idx + [coo.data.real, coo.data.imag])
            np.savetxt(f, stacked, fmt="%d %d %.17g %.17g")
        else:
            stacked = np.column_stack(idx + [coo.data])
            np.savetxt(f, stacked, fmt="%d %d %.17g")
