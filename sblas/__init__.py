"""sblas: scalable sparse BLAS in JAX (SpMV / SpMM / SpTRSV).

Public API (mirrors the reference's entry points over CSR — SURVEY.md §1/§2,
BASELINE.json north_star):

    A = sblas.read_mtx("cant.mtx")          # CSR
    y = sblas.spmv(A, x, alpha=1.0, beta=0.0, y=None)
    Y = sblas.spmm(A, X, alpha=1.0, beta=0.0, y=None)
    x = sblas.sptrsv(L, b, lower=True, unit_diagonal=False)
    X = sblas.sptrsm(L, B, lower=True)      # K right-hand sides, one analysis

All three accept CSR or CSC and a ``trans=`` flag (op(A) = A^T), matching
the reference's CSR/CSC surface; e.g. the Cholesky backsolve is
``sblas.sptrsv(L, b, trans=True)``.

Matrices are host-side CSR; on first use they are retiled into device
layouts (ELL / degree buckets / dense blocks / level schedules, chosen from
the matrix) and cached. Multi-device execution goes through
``sblas.parallel``.
"""

from .formats import COO, CSR, CSC, coo_to_csr, coo_to_csc, csr_transpose, tril, triu
from .io import read_mtx, read_mtx_coo, write_mtx
from . import datasets, golden, reorder

__version__ = "0.1.0"

__all__ = [
    "COO", "CSR", "CSC",
    "coo_to_csr", "coo_to_csc", "csr_transpose", "tril", "triu",
    "read_mtx", "read_mtx_coo", "write_mtx",
    "datasets", "golden", "reorder", "solvers",
    "spmv", "spmm", "sptrsv", "sptrsm",
]


def __getattr__(name):
    # Lazy: importing sblas for host-side format work should not import JAX.
    if name in ("spmv", "spmm", "sptrsv", "sptrsm"):
        from . import ops

        return getattr(ops, name)
    if name == "solvers":
        # importlib, not `from . import`: the latter re-enters this
        # __getattr__ for the same name before the import binds it
        import importlib

        return importlib.import_module(".solvers", __name__)
    raise AttributeError(f"module 'sblas' has no attribute {name!r}")
