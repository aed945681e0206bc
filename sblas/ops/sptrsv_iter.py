"""Iterative (Jacobi-sweep / truncated-Neumann) triangular solve.

Solve ``L x = b`` with the stationary split ``L = D + E`` (``D`` the
diagonal, ``E`` the strictly triangular part) by the Jacobi recurrence

    x_0     = D^{-1} b
    x_{k+1} = D^{-1} (b - E x_k)

``D^{-1}E`` is strictly triangular, hence nilpotent with index equal to
the dependency-DAG depth (the level count of the classic level-set
analysis), so the sweep is **exact after nlevels-1 applications** — and
useful far earlier: preconditioner applications (IC(0)/ILU(0) inside
CG/GMRES) tolerate truncated triangular solves, which replaces the
latency-bound level-by-level solve with a handful of *bandwidth-bound*
SpMV passes. Each sweep rides the SpMV route; the multi-RHS variant rides
SpMM, amortizing the E stream over all k right-hand sides per sweep.

This is the iterative sparse triangular solve of the GPU literature (Anzt/Chow/Dongarra, "Iterative sparse
triangular solves for preconditioning"). The reference library's SpTRSV
is exact-only (SURVEY.md C7-C9); this is a deliberate capability
extension along the same roofline logic that motivated it there:
wavefront solves are latency-bound on any SIMD machine, SpMV is not.

Caveat (documented, also asserted in tests): truncation error after k
sweeps is ``(-D^{-1}E)^k e_0`` — bounded only through the spectral decay
of ``D^{-1}E``, which for diagonally-dominant factors (shifted IC/ILU)
is fast, but for ill-conditioned factors can transiently *grow* before
nilpotency kills it. ``sweeps=None`` therefore defaults to the exact
count; truncation is an explicit caller opt-in.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .. import native
from ..formats import CSR, tril, triu


def _split_diag(l: CSR, lower: bool, unit_diagonal: bool):
    """(strict part E as CSR, inv_diag vector) of a triangular matrix."""
    n = l.shape[0]
    strict = tril(l, -1) if lower else triu(l, 1)
    if unit_diagonal:
        inv_d = np.ones(n, dtype=l.dtype)
        return strict, inv_d
    coo = l.tocoo()
    mask = coo.row == coo.col
    d = np.zeros(n, dtype=np.float64)
    d[coo.row[mask]] = coo.data[mask]
    if not mask.any() or (d == 0).any():
        raise ValueError("jacobi sweep needs a full nonzero diagonal "
                         "(or unit_diagonal=True)")
    return strict, (1.0 / d).astype(l.dtype)


class SptrsvJacobiPlan:
    """Jacobi-sweep triangular solve plan (single RHS).

    ``sweeps=None`` -> exact (= nlevels-1, from the O(nnz) native level
    sweep). Smaller ``sweeps`` gives the truncated preconditioner-grade
    solve. ``spmv_method``/extra kwargs go to the inner SpmvPlan on E.
    """

    def __init__(self, l, *, lower: bool = True,
                 unit_diagonal: bool = False, sweeps: int | None = None,
                 spmv_method: str = "auto", **spmv_kw):
        from .common import as_csr
        from .spmv import SpmvPlan

        l = as_csr(l)
        if l.shape[0] != l.shape[1]:
            raise ValueError("sptrsv needs a square matrix")
        self.shape = l.shape
        self.dtype = l.dtype
        self.lower = lower
        self.unit_diagonal = unit_diagonal
        strict, inv_d = _split_diag(l, lower, unit_diagonal)
        _, self.nlevels = native.level_schedule(
            l.indptr, l.indices, l.shape[0], lower=lower)
        self.sweeps = max(self.nlevels - 1, 0) if sweeps is None else sweeps
        self._inv_d = jnp.asarray(inv_d)
        self._spmv = (SpmvPlan(strict, method=spmv_method, **spmv_kw)
                      if strict.nnz else None)
        self.method = ("jacobi+" + self._spmv.method) if self._spmv \
            else "jacobi+diag"
        # bytes per solve: sweeps E streams + per-sweep x/b/invd traffic
        per_sweep = (self._spmv.bytes_per_iter if self._spmv else 0) \
            + 3 * l.shape[0] * l.data.itemsize
        self.bytes_per_iter = max(self.sweeps, 1) * per_sweep
        self._fn = None

    def device_arrays(self):
        d = {"invd": self._inv_d}
        if self._spmv is not None:
            d["e"] = self._spmv.device_arrays()
        return d

    def apply_pure(self, arrs, b, sweeps: int | None = None):
        """x ~= solve(L, b); jit-argument-safe. ``sweeps`` must be static."""
        k = self.sweeps if sweeps is None else sweeps
        invd = arrs["invd"]
        x = invd * b
        if self._spmv is None or k == 0:
            return x

        def body(_, x):
            return invd * (b - self._spmv.apply_pure(arrs["e"], x))

        return lax.fori_loop(0, k, body, x, unroll=False)

    def apply_traced(self, b):
        return self.apply_pure(self.device_arrays(), b)

    def __call__(self, b):
        n = self.shape[0]
        b = jnp.asarray(b, dtype=self.dtype)
        if b.shape != (n,):
            raise ValueError(f"b must have shape ({n},), got {b.shape}")
        if self._fn is None:
            self._fn = jax.jit(self.apply_pure)
        return self._fn(self.device_arrays(), b)


class SptrsmJacobiPlan:
    """Jacobi-sweep triangular solve plan for (n, k) multi-RHS.

    One SpMM per sweep serves all k right-hand sides — the E stream is
    read once per sweep instead of once per RHS, so the truncated solve's
    advantage over k wavefront solves grows with k.
    """

    def __init__(self, l, *, lower: bool = True,
                 unit_diagonal: bool = False, sweeps: int | None = None,
                 spmm_method: str = "auto", **spmm_kw):
        from .common import as_csr
        from .spmm import SpmmPlan

        l = as_csr(l)
        if l.shape[0] != l.shape[1]:
            raise ValueError("sptrsm needs a square matrix")
        self.shape = l.shape
        self.dtype = l.dtype
        self.lower = lower
        self.unit_diagonal = unit_diagonal
        strict, inv_d = _split_diag(l, lower, unit_diagonal)
        _, self.nlevels = native.level_schedule(
            l.indptr, l.indices, l.shape[0], lower=lower)
        self.sweeps = max(self.nlevels - 1, 0) if sweeps is None else sweeps
        self._inv_d = jnp.asarray(inv_d)
        self._spmm = (SpmmPlan(strict, method=spmm_method, **spmm_kw)
                      if strict.nnz else None)
        self.method = ("jacobi+" + self._spmm.method) if self._spmm \
            else "jacobi+diag"
        self._fn = None

    def device_arrays(self):
        d = {"invd": self._inv_d}
        if self._spmm is not None:
            d["e"] = self._spmm.device_arrays()
        return d

    def apply_pure(self, arrs, b, sweeps: int | None = None):
        k = self.sweeps if sweeps is None else sweeps
        invd = arrs["invd"][:, None]
        x = invd * b
        if self._spmm is None or k == 0:
            return x

        def body(_, x):
            return invd * (b - self._spmm.apply_pure(arrs["e"], x))

        return lax.fori_loop(0, k, body, x, unroll=False)

    def apply_traced(self, b):
        return self.apply_pure(self.device_arrays(), b)

    def __call__(self, b):
        n = self.shape[0]
        b = jnp.asarray(b, dtype=self.dtype)
        if b.ndim != 2 or b.shape[0] != n:
            raise ValueError(f"B must have shape ({n}, k), got {b.shape}")
        if self._fn is None:
            self._fn = jax.jit(self.apply_pure)
        return self._fn(self.device_arrays(), b)
