"""ctypes loader for the native C++ helpers (csrc/sblas_native.cpp).

Compiles the shared library on first use (g++, ~1 s) into the package
directory and caches it; every entry point has a numpy fallback so the
library works without a C++ toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "sblas_native.cpp"
_LIB_DIR = Path(__file__).resolve().parent
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if not _SRC.exists():
        return None
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    so = _LIB_DIR / f"_sblas_native_{tag}.so"
    if not so.exists():
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", str(so), str(_SRC)],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.sblas_level_schedule_lower.restype = ctypes.c_int32
    lib.sblas_level_schedule_lower.argtypes = [i32p, i32p, ctypes.c_int64, i32p]
    lib.sblas_level_schedule_upper.restype = ctypes.c_int32
    lib.sblas_level_schedule_upper.argtypes = [i32p, i32p, ctypes.c_int64, i32p]
    lib.sblas_parse_mtx_body.restype = ctypes.c_int64
    lib.sblas_parse_mtx_body.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        i32p, i32p, f64p,
    ]
    lib.sblas_sptrsv_lower_f64.restype = None
    lib.sblas_sptrsv_lower_f64.argtypes = [
        i32p, i32p, f64p, ctypes.c_int64, f64p, f64p, ctypes.c_int,
    ]
    lib.sblas_ic0_f64.restype = ctypes.c_int64
    lib.sblas_ic0_f64.argtypes = [i32p, i32p, f64p, ctypes.c_int64]
    lib.sblas_ilu0_f64.restype = ctypes.c_int64
    lib.sblas_ilu0_f64.argtypes = [i32p, i32p, f64p, ctypes.c_int64]
    _lib = lib
    return _lib


def _as_i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _as_f64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def have_native() -> bool:
    return _build_and_load() is not None


def level_schedule(indptr: np.ndarray, indices: np.ndarray, n: int,
                   *, lower: bool = True) -> tuple[np.ndarray, int]:
    """Per-row dependency level of a triangular CSR matrix.

    Returns (levels[n] int32, nlevels). Native: one O(nnz) sweep. Fallback:
    numpy frontier relaxation, O(depth * nnz).
    """
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    lib = _build_and_load()
    if lib is not None:
        levels = np.zeros(n, dtype=np.int32)
        fn = (lib.sblas_level_schedule_lower if lower
              else lib.sblas_level_schedule_upper)
        nlev = fn(_as_i32p(indptr), _as_i32p(indices), n, _as_i32p(levels))
        return levels, int(nlev)
    return _level_schedule_numpy(indptr, indices, n, lower=lower)


def _level_schedule_numpy(indptr, indices, n, *, lower=True):
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = indices.astype(np.int64)
    off = cols < rows if lower else cols > rows
    rows, cols = rows[off], cols[off]
    levels = np.zeros(n, dtype=np.int32)
    # Relax until fixpoint: level[i] = max(level[deps]) + 1.
    for _ in range(n + 1):
        cand = levels[cols] + 1
        new = np.zeros(n, dtype=np.int32)
        np.maximum.at(new, rows, cand)
        if np.array_equal(new, levels):
            break
        levels = np.maximum(levels, new)
    else:  # pragma: no cover
        raise RuntimeError("level schedule did not converge (cycle?)")
    return levels, int(levels.max(initial=-1)) + 1


def parse_mtx_body(body: bytes, nnz: int, has_value: bool):
    """Parse the body of a MatrixMarket coordinate file. Returns
    (rows, cols, vals) as int32/int32/float64 arrays, or None if native
    library unavailable."""
    lib = _build_and_load()
    if lib is None:
        return None
    rows = np.empty(nnz, dtype=np.int32)
    cols = np.empty(nnz, dtype=np.int32)
    vals = np.empty(nnz, dtype=np.float64)
    got = lib.sblas_parse_mtx_body(
        body, len(body), nnz, int(has_value),
        _as_i32p(rows), _as_i32p(cols), _as_f64p(vals),
    )
    if got != nnz:
        raise ValueError(f"malformed .mtx body: parsed {got} of {nnz} entries")
    return rows, cols, vals


def sptrsv_golden_native(indptr, indices, data, b, *, unit_diagonal=False):
    """Serial CSR forward substitution in C++ (exact reference-style golden)."""
    lib = _build_and_load()
    if lib is None:
        return None
    n = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    x = np.empty(n, dtype=np.float64)
    lib.sblas_sptrsv_lower_f64(
        _as_i32p(indptr), _as_i32p(indices), _as_f64p(data), n,
        _as_f64p(b), _as_f64p(x), int(unit_diagonal),
    )
    return x


def ic0_inplace(indptr, indices, data64) -> int:
    """Native IC(0) over the tril(A) CSR values (sorted cols, diag last in
    each row). Returns 0, or i+1 on a non-positive pivot at row i.
    Returns -1 when no native library is available (caller falls back)."""
    lib = _build_and_load()
    if lib is None:
        return -1
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    assert data64.dtype == np.float64 and data64.flags.c_contiguous
    return int(lib.sblas_ic0_f64(_as_i32p(indptr), _as_i32p(indices),
                                 _as_f64p(data64), len(indptr) - 1))


def ilu0_inplace(indptr, indices, data64) -> int:
    """Native ILU(0) over the full-pattern CSR values (sorted cols, full
    diagonal): in place, L unit-lower + U upper. Returns 0, or i+1 on a
    zero pivot / missing diagonal at row i. Returns -1 when no native
    library is available (caller falls back)."""
    lib = _build_and_load()
    if lib is None:
        return -1
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    assert data64.dtype == np.float64 and data64.flags.c_contiguous
    return int(lib.sblas_ilu0_f64(_as_i32p(indptr), _as_i32p(indices),
                                  _as_f64p(data64), len(indptr) - 1))


