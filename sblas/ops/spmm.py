"""SpMM: Y = alpha * A @ X + beta * Y, dense row-major X of shape (n, k)
(SURVEY.md C6; BASELINE config #2 uses K = 8 / 32).

Methods: ``'ell'``, ``'bucket'`` and ``'bsr'`` as in SpMV, with the
per-row dot widened to K columns, and ``'spmv_passes'`` (K SpMV passes
over one shared SpMV plan). ``'auto'`` chooses from the matrix
(:meth:`SpmmPlan._pick`): dense-block BSR when the touched 128x128 blocks
are dense enough and fit the device, else ELL or buckets by row-degree
skew.

The ELL gather X[col] materializes (rows, width, k) values, so execution is
chunked over row blocks with ``lax.map`` to bound that intermediate at a
sixteenth of the device's memory (256 MiB where the platform reports no
limit).
Arithmetic intensity is K times SpMV's, so K=32 leaves the pure
bandwidth-bound regime (SURVEY.md §3.2). Every float32 contraction runs at
``Precision.HIGHEST`` (see :func:`sblas.ops.common.ell_dot`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..formats import CSR
from ..retile import to_ell, to_bucket_ell
from ..retile_bsr import pack_bsr, bsr_stats
from .common import ell_dot
from .spmv import _PLAN_CACHE, SpmvPlan, _epilogue

METHODS = ("ell", "bucket", "bsr", "spmv_passes")

# block density above which the dense-block route beats a gather route
_BSR_MIN_DENSITY = 0.15


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _ell_rows(val, col, x, blk):
    """ell_dot over row blocks of ``blk`` rows (bounds the gather)."""
    mp = val.shape[0]
    if blk >= mp:
        return ell_dot(val, col, x)

    def f(i):
        v = lax.dynamic_slice_in_dim(val, i * blk, blk)
        c = lax.dynamic_slice_in_dim(col, i * blk, blk)
        return ell_dot(v, c, x)

    return lax.map(f, jnp.arange(mp // blk)).reshape(mp, x.shape[1])


class SpmmPlan:
    """Retiled device-resident SpMM executor for one CSR matrix."""

    def __init__(self, a, method: str = "auto", *,
                 max_width: int = 2048, intermediate_mb: int | None = None,
                 k_hint: int | None = None):
        from ..utils.backend import device_bytes_limit
        from .common import as_csr

        a = as_csr(a)
        self.shape = a.shape
        self.dtype = a.dtype
        self.nnz = a.nnz
        if intermediate_mb is None:
            limit = device_bytes_limit()
            self._intermediate = limit // 16 if limit else 256 << 20
        else:
            self._intermediate = intermediate_mb << 20
        if method == "auto":
            method = self._pick(a)
        if method not in METHODS:
            raise ValueError(f"unknown spmm method {method!r}; "
                             f"choose from {METHODS}")
        self.method = method

        if method == "spmv_passes":
            # k SpMV passes sharing ONE SpmvPlan: each column re-streams the
            # matrix, so the model is k x the SpMV schedule stream
            self._spmv = SpmvPlan(a, "auto")
            sched = self._spmv.bytes_per_iter - (
                (a.shape[0] + a.shape[1]) * a.data.itemsize)
            self.bytes_per_iter_nx = (k_hint or 8) * sched
        elif method == "ell":
            ell = to_ell(a)
            self._val = jnp.asarray(ell.val)
            self._col = jnp.asarray(ell.col)
            self._width = ell.width
            self.bytes_per_iter_nx = ell.col.size * (a.data.itemsize + 4)
        elif method == "bucket":
            be = to_bucket_ell(a, max_width=max_width)
            self._buckets = tuple(
                (jnp.asarray(b.val), jnp.asarray(b.col)) for b in be.buckets
            )
            self._bucket_widths = tuple(b.width for b in be.buckets)
            self._perm = jnp.asarray(be.perm)
            self.bytes_per_iter_nx = sum(
                b.col.size for b in be.buckets
            ) * (a.data.itemsize + 4)
        else:
            bsr = pack_bsr(a)
            self._blocks = jnp.asarray(bsr.blocks)
            self._brow = jnp.asarray(bsr.brow)
            self._bcol = jnp.asarray(bsr.bcol)
            self._bsr_meta = bsr
            self.bytes_per_iter_nx = bsr.bytes_per_iter
        self._jit_call = jax.jit(self._call_pure)

    @staticmethod
    def _pick(a: CSR) -> str:
        """Dense blocks when they are dense enough and take at most a
        quarter of the device's memory; else the SpMV choice (ELL or
        degree buckets)."""
        from ..utils.backend import device_bytes_limit

        stats = bsr_stats(a)
        limit = device_bytes_limit()
        fits = limit is None or stats["bytes"] <= limit // 4
        if stats["density"] > _BSR_MIN_DENSITY and fits:
            return "bsr"
        return SpmvPlan._pick(a)

    def device_arrays(self):
        if self.method == "bsr":
            return {"blocks": self._blocks, "brow": self._brow,
                    "bcol": self._bcol}
        if self.method == "ell":
            return {"val": self._val, "col": self._col}
        if self.method == "bucket":
            return {"buckets": self._buckets, "perm": self._perm}
        return self._spmv.device_arrays()

    def apply_pure(self, arrs, x):
        """Y = A @ X with arrays passed explicitly (jit-argument safe)."""
        m = self.shape[0]
        k = x.shape[1]
        if self.method == "ell":
            blk = self._blk(self._width, k, x.dtype.itemsize,
                            arrs["val"].shape[0])
            return _ell_rows(arrs["val"], arrs["col"], x, blk)[:m]
        if self.method == "bucket":
            flat = jnp.concatenate([
                _ell_rows(val, col, x,
                          self._blk(w, k, x.dtype.itemsize, val.shape[0]))
                for (val, col), w in zip(arrs["buckets"],
                                         self._bucket_widths)])
            return jnp.zeros((m + 1, k),
                             dtype=flat.dtype).at[arrs["perm"]].add(flat)[:m]
        if self.method == "spmv_passes":
            cols = [self._spmv.apply_pure(arrs, x[:, j]) for j in range(k)]
            return jnp.stack(cols, axis=1)
        meta = self._bsr_meta
        pad = meta.num_bcols * meta.bc - self.shape[1]
        x3d = jnp.pad(x, ((0, pad), (0, 0))).reshape(meta.num_bcols, meta.bc, k)
        partial = jnp.einsum("bij,bjk->bik", arrs["blocks"], x3d[arrs["bcol"]],
                             precision=lax.Precision.HIGHEST)
        y = jax.ops.segment_sum(partial, arrs["brow"],
                                num_segments=meta.num_brows)
        return y.reshape(-1, k)[:m]

    def apply_traced(self, x):
        """Pure Y = A @ X inside jit, closing over the plan's arrays."""
        return self.apply_pure(self.device_arrays(), x)

    def _call_pure(self, arrs, x, alpha, beta, y):
        return _epilogue(self.apply_pure(arrs, x), alpha, beta, y)

    def _blk(self, width: int, k: int, itemsize: int, mp: int) -> int:
        per_row = max(width * k * itemsize, 1)
        blk = max(self._intermediate // per_row, 8)
        blk = min(_round_up(blk, 8), mp)
        while mp % blk:
            blk -= 8
        return max(blk, 8)

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        n = self.shape[1]
        x = jnp.asarray(x, dtype=self.dtype)
        if x.ndim != 2 or x.shape[0] != n:
            raise ValueError(f"X must have shape ({n}, k), got {x.shape}")
        if beta != 0.0 and y is None:
            raise ValueError("beta != 0 requires y")
        # Python scalars: jit's dispatch converts them far more cheaply
        # than a jnp.asarray per call would
        al, be = float(alpha), float(beta)
        yv = None if y is None else jnp.asarray(y, dtype=self.dtype)
        return self._jit_call(self.device_arrays(), x, al, be, yv)


def spmm(a, x, alpha: float = 1.0, beta: float = 0.0, y=None,
         *, trans: bool = False, method: str = "auto", **kw):
    """Y_out = alpha * op(A) @ X + beta * Y, op = A^T if trans else A.

    ``a`` may be CSR or CSC; plans are cached per derived matrix.
    """
    from .common import as_csr

    a = as_csr(a, trans)
    plans = _PLAN_CACHE.setdefault(a, {})
    key = ("spmm", method, tuple(sorted(kw.items())))
    if key not in plans:
        plans[key] = SpmmPlan(a, method, **kw)
    return plans[key](x, alpha, beta, y)
