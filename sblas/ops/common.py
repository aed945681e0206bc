"""Input normalization shared by the op entry points.

The reference's routines operate over CSR *and* CSC (SURVEY.md §0 "SpMV,
SpMM, and SpTRSV over CSR/CSC"); its drivers also expose transposed
variants implicitly by feeding the CSC of a matrix to a CSR kernel. Here
both are explicit: every entry point accepts ``CSR | CSC`` and a
``trans=`` flag, and this module reduces the four combinations to the one
thing the plans understand — a CSR of the operator actually applied.

Derived matrices (CSC→CSR conversion, transposes) are cached weakly per
source object so repeated calls reuse both the host-side conversion and,
through the plan cache keyed on the derived CSR's identity, the retiled
device arrays.
"""

from __future__ import annotations

import weakref

import jax.numpy as jnp
from jax import lax

from ..formats import CSR, CSC, csr_transpose

# source matrix -> {"csr": CSR of A, "csr_T": CSR of A^T}
_DERIVED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def as_csr(a, trans: bool = False) -> CSR:
    """CSR of (A^T if trans else A), for ``a`` given as CSR or CSC.

    A CSC of A is byte-identical to a CSR of A^T, so the (CSC, trans=True)
    corner is a zero-copy reinterpretation; the other derived forms run one
    cached host-side stable-sort transpose (formats.csr_transpose).
    """
    if isinstance(a, CSR):
        if not trans:
            return a
        return _derived(a, "csr_T", lambda: csr_transpose(a))
    if isinstance(a, CSC):
        m, n = a.shape
        if trans:
            return _derived(
                a, "csr_T",
                lambda: CSR((n, m), a.indptr, a.indices, a.data),
            )
        return _derived(a, "csr", a.tocsr)
    raise TypeError(
        f"expected sblas.CSR or sblas.CSC, got {type(a).__name__}"
    )


def _derived(src, key: str, build) -> CSR:
    cache = _DERIVED.setdefault(src, {})
    if key not in cache:
        cache[key] = build()
    return cache[key]


def ell_dot(val, col, x):
    """Row sums of ``val * x[col]`` for one ELL slab: (r, w) ``val``/``col``
    against ``x`` of shape (n,) or (n, k), giving (r,) or (r, k).

    The K-wide form is a contraction; its precision is pinned to HIGHEST
    because a float32 dot on a GPU may otherwise run in TF32 (about three
    decimal digits)."""
    if x.ndim == 1:
        return jnp.sum(val * x[col], axis=1)
    return jnp.einsum("rw,rwk->rk", val, x[col],
                      precision=lax.Precision.HIGHEST)
