"""SpMV: y = alpha * A @ x + beta * y  (SURVEY.md C5).

Methods (selected by ``method=`` or ``'auto'``):

- ``'coo'``    — jnp ``segment_sum(vals * x[cols], rows)``. Reads 12 B/nnz
                 (val+col+row). Always available; the correctness anchor.
- ``'ell'``    — ELLPACK gather: ``sum(val * x[col], axis=1)``. Reads 8 B/nnz
                 of padded stream; best when fill is high (FEM suite).
- ``'bucket'`` — degree-bucketed ELLPACK with heavy-row splitting; bounded
                 padding on power-law matrices.
- ``'bsr'``    — dense-block BSR, one batched block-times-vector contraction.

``'auto'`` chooses from the matrix alone (:meth:`SpmvPlan._pick`): ELL when
the longest row is within 4x the mean, else buckets. The reference exposes
csr-scalar / csr-vector / LightSpMV-style variants that trade off
row-length regularity; these methods are the analogue of that variant set
(thread-per-row <-> ELL rows, warp-per-row <-> bucketed widths, dynamic
scheduling <-> heavy-row splitting).
"""

from __future__ import annotations

import weakref

import jax
import jax.numpy as jnp
from jax import lax

from ..formats import CSR
from ..retile import to_ell, to_bucket_ell
from ..retile_bsr import pack_bsr
from .common import ell_dot

METHODS = ("coo", "ell", "bucket", "bsr")

# plan cache shared by all op entry points, keyed weakly on the matrix
_PLAN_CACHE = weakref.WeakKeyDictionary()


def pick_layout(row_lengths) -> str:
    """ELL when the longest row is within 4x the mean row, or fits the
    narrowest bucket (8 entries) anyway; else degree buckets (power-law
    rows would pad ELL to the hub degree)."""
    mx = int(row_lengths.max(initial=0))
    mean = float(row_lengths.mean()) if len(row_lengths) else 0.0
    return "ell" if mx <= max(4 * mean, 8) else "bucket"


def _epilogue(out, alpha, beta, y):
    out = jnp.asarray(alpha, out.dtype) * out
    if y is not None:
        out = out + jnp.asarray(beta, out.dtype) * y
    return out


class SpmvPlan:
    """Retiled device-resident SpMV executor for one CSR matrix."""

    def __init__(self, a, method: str = "auto", *, max_width: int = 2048):
        from .common import as_csr

        a = as_csr(a)
        self.shape = a.shape
        self.dtype = a.dtype
        self.nnz = a.nnz
        if method == "auto":
            method = self._pick(a)
        if method not in METHODS:
            raise ValueError(f"unknown spmv method {method!r}; "
                             f"choose from {METHODS}")
        self.method = method
        m, n = a.shape

        if method == "coo":
            self._vals = jnp.asarray(a.data)
            self._cols = jnp.asarray(a.indices)
            self._rows = jnp.asarray(a.row_ids())
            self.bytes_per_iter = a.nnz * (a.data.itemsize + 8)
        elif method == "ell":
            ell = to_ell(a)
            self._val = jnp.asarray(ell.val)
            self._col = jnp.asarray(ell.col)
            self.fill = ell.fill
            self.bytes_per_iter = ell.col.size * (a.data.itemsize + 4)
        elif method == "bucket":
            be = to_bucket_ell(a, max_width=max_width)
            self._buckets = tuple(
                (jnp.asarray(b.val), jnp.asarray(b.col)) for b in be.buckets
            )
            self._perm = jnp.asarray(be.perm)
            self.fill = be.fill
            self.bytes_per_iter = sum(
                b.col.size for b in be.buckets
            ) * (a.data.itemsize + 4)
        else:
            bsr = pack_bsr(a)
            self._blocks = jnp.asarray(bsr.blocks)
            self._brow = jnp.asarray(bsr.brow)
            self._bcol = jnp.asarray(bsr.bcol)
            self._bsr_meta = bsr
            self.fill = bsr.density
            self.bytes_per_iter = bsr.bytes_per_iter + (n + m) * a.data.itemsize
        self._jit_call = jax.jit(self._call_pure)

    @staticmethod
    def _pick(a: CSR) -> str:
        return pick_layout(a.row_lengths)

    def __repr__(self):
        m, n = self.shape
        fill = getattr(self, "fill", None)
        fs = f", fill={fill:.2f}" if fill is not None else ""
        return (f"SpmvPlan({m}x{n}, nnz={self.nnz}, method={self.method!r}"
                f"{fs}, ~{self.bytes_per_iter / 1e6:.1f} MB/iter)")

    def device_arrays(self):
        """Pytree of this plan's device-resident arrays, to pass as jit
        arguments to :meth:`apply_pure` (closing over them would embed
        them in the compiled program as constants)."""
        if self.method == "coo":
            return {"vals": self._vals, "cols": self._cols, "rows": self._rows}
        if self.method == "ell":
            return {"val": self._val, "col": self._col}
        if self.method == "bucket":
            return {"buckets": self._buckets, "perm": self._perm}
        return {"blocks": self._blocks, "brow": self._brow,
                "bcol": self._bcol}

    def apply_pure(self, arrs, x):
        """y = A @ x with arrays passed explicitly (jit-argument safe)."""
        m = self.shape[0]
        if self.method == "coo":
            return jax.ops.segment_sum(arrs["vals"] * x[arrs["cols"]],
                                       arrs["rows"], num_segments=m)
        if self.method == "ell":
            return ell_dot(arrs["val"], arrs["col"], x)[:m]
        if self.method == "bucket":
            flat = jnp.concatenate([ell_dot(val, col, x)
                                    for (val, col) in arrs["buckets"]])
            return jnp.zeros(m + 1, dtype=flat.dtype).at[arrs["perm"]].add(
                flat)[:m]
        meta = self._bsr_meta
        pad = meta.num_bcols * meta.bc - self.shape[1]
        x2d = jnp.pad(x, (0, pad)).reshape(meta.num_bcols, meta.bc)
        partial = jnp.einsum("bij,bj->bi", arrs["blocks"], x2d[arrs["bcol"]],
                             precision=lax.Precision.HIGHEST)
        y = jax.ops.segment_sum(partial, arrs["brow"],
                                num_segments=meta.num_brows)
        return y.reshape(-1)[:m]

    def apply_traced(self, x):
        """Pure y = A @ x inside jit, closing over the plan's arrays."""
        return self.apply_pure(self.device_arrays(), x)

    def _call_pure(self, arrs, x, alpha, beta, y):
        return _epilogue(self.apply_pure(arrs, x), alpha, beta, y)

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        n = self.shape[1]
        x = jnp.asarray(x, dtype=self.dtype)
        if x.shape != (n,):
            raise ValueError(f"x must have shape ({n},), got {x.shape}")
        if beta != 0.0 and y is None:
            raise ValueError("beta != 0 requires y")
        # Python scalars: jit's dispatch converts them far more cheaply
        # than a jnp.asarray per call would
        al, be = float(alpha), float(beta)
        yv = None if y is None else jnp.asarray(y, dtype=self.dtype)
        return self._jit_call(self.device_arrays(), x, al, be, yv)


def _get_plan(a: CSR, method: str, **kw) -> SpmvPlan:
    plans = _PLAN_CACHE.setdefault(a, {})
    key = ("spmv", method, tuple(sorted(kw.items())))
    if key not in plans:
        plans[key] = SpmvPlan(a, method, **kw)
    return plans[key]


def spmv(a, x, alpha: float = 1.0, beta: float = 0.0, y=None,
         *, trans: bool = False, method: str = "auto", **kw):
    """y_out = alpha * op(A) @ x + beta * y, op = A^T if trans else A.

    ``a`` may be CSR or CSC (the reference operates over both); plans are
    cached per derived matrix.
    """
    from .common import as_csr

    return _get_plan(as_csr(a, trans), method, **kw)(x, alpha, beta, y)
