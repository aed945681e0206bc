"""SpTRSM: solve op(L) X = B for K right-hand sides (B is (n, k)).

The reference family ships a multi-RHS triangular solve alongside SpTRSV
(cuSPARSE: csrsm2); here it reuses SpTRSV's analysis wholesale — the level
schedule is per matrix, not per right-hand side, so a ``SptrsmPlan`` pays
one analysis for any number of columns. Both SpTRSV routes take a (n, K)
right-hand side:

- ``'tiles'``  — each level tile gathers its dependency rows once and
  applies them to all K columns (``einsum('rw,rwk->rk')``), so the index
  stream amortizes K-fold against K SpTRSV calls.
- ``'triton'`` — one kernel launch, one program per column.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .spmv import _PLAN_CACHE
from .sptrsv import SptrsvPlan


class SptrsmPlan:
    """Multi-RHS triangular-solve executor sharing SpTRSV's analysis."""

    def __init__(self, l, *, lower: bool = True, unit_diagonal: bool = False,
                 tile_rows: int = 0, method: str = "auto",
                 validate: bool = False):
        self._sv = SptrsvPlan(l, lower=lower, unit_diagonal=unit_diagonal,
                              tile_rows=tile_rows, method=method,
                              validate=validate)
        self.shape = self._sv.shape
        self.dtype = self._sv.dtype
        self.lower = lower
        self.unit_diagonal = unit_diagonal
        self.method = self._sv.method
        self.nlevels = self._sv.nlevels
        self.padding_ratio = self._sv.padding_ratio

    def bytes_per_iter(self, k: int) -> int:
        """Traffic model for one K-column solve: the tiles route reads the
        schedule once; the kernel reads it once per column."""
        sv = self._sv.bytes_per_iter
        rhs = self.shape[0] * 2 * np.dtype(self.dtype).itemsize
        if self.method == "triton":
            return sv * k
        return sv + rhs * (k - 1)

    def device_arrays(self):
        return self._sv.device_arrays()

    def apply_pure(self, arrs, b):
        """X = op(L)^{-1} B with arrays passed explicitly (jit-safe). b is
        (n, k)."""
        return self._sv.apply_pure(arrs, b)

    def apply_traced(self, b):
        return self.apply_pure(self.device_arrays(), b)

    def __call__(self, b):
        n = self.shape[0]
        b = jnp.asarray(b, dtype=self.dtype)
        if b.ndim != 2 or b.shape[0] != n:
            raise ValueError(f"B must have shape ({n}, k), got {b.shape}")
        return self._sv._jit_pure(self._sv.device_arrays(), b)


def sptrsm(l, b, *, lower: bool = True, unit_diagonal: bool = False,
           trans: bool = False, method: str = "auto", **kw):
    """Solve op(L) X = B for (n, k) B, op = L^T if trans else L.

    ``l`` may be CSR or CSC; analysis is cached per derived matrix and
    shared across RHS widths.
    """
    from .common import as_csr

    l = as_csr(l, trans)
    if trans:
        lower = not lower
    plans = _PLAN_CACHE.setdefault(l, {})
    key = ("sptrsm", lower, unit_diagonal, method, tuple(sorted(kw.items())))
    if key not in plans:
        if method == "jacobi":
            # truncated-Neumann sweep solve: one SpMM per sweep serves
            # all k RHS — see ops/sptrsv_iter.py
            from .sptrsv_iter import SptrsmJacobiPlan

            plans[key] = SptrsmJacobiPlan(
                l, lower=lower, unit_diagonal=unit_diagonal, **kw)
        else:
            plans[key] = SptrsmPlan(l, lower=lower,
                                    unit_diagonal=unit_diagonal,
                                    method=method, **kw)
    return plans[key](b)
