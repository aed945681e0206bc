"""SpTRSV: solve L x = b for triangular CSR L (SURVEY.md C7/C8).

Mirrors the reference's analysis/solve split: ``SptrsvPlan`` runs the host
level-set analysis once (native C++ sweep) into a
:class:`~sblas.sptrsv_schedule.LevelSchedule`, then every solve walks that
schedule. Two routes consume it:

- ``'tiles'``  — a jitted ``lax.fori_loop`` over level tiles, one trip per
  tile (:func:`_solve_tiles`). Runs everywhere; the reference for the other.
- ``'triton'`` — the whole level walk inside one Pallas-Triton kernel launch
  (:mod:`sblas.ops.kernels.sptrsv_triton`). GPU only.

``'auto'`` picks by platform (:meth:`SptrsvPlan._pick`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..sptrsv_schedule import build_level_schedule, validate_schedule
from .spmv import _PLAN_CACHE

METHODS = ("tiles", "triton")


def _solve_tiles_body(slot_row, col, val, inv_diag, b_pad, n, tile_rows,
                      num_tiles):
    """Serial scan over tiles; each tile solves tile_rows independent rows.
    ``b_pad`` is (n + 2,) or (n + 2, K).

    x buffer layout: [0:n] solution, [n] constant zero (gather target of
    padded columns), [n+1] dump slot (scatter target of padded rows).
    """
    from .common import ell_dot

    def body(t, x):
        s0 = t * tile_rows
        rows = lax.dynamic_slice_in_dim(slot_row, s0, tile_rows)
        c = lax.dynamic_slice_in_dim(col, s0, tile_rows)
        v = lax.dynamic_slice_in_dim(val, s0, tile_rows)
        idg = lax.dynamic_slice_in_dim(inv_diag, s0, tile_rows)
        if b_pad.ndim == 2:
            idg = idg[:, None]
        xb = (b_pad[rows] - ell_dot(v, c, x)) * idg
        # pad rows carry slot_row == n -> redirect their write to dump n+1
        safe_rows = jnp.where(rows == n, n + 1, rows)
        return x.at[safe_rows].set(xb)

    x0 = jnp.zeros_like(b_pad)
    return lax.fori_loop(0, num_tiles, body, x0)[:n]


_solve_tiles = jax.jit(_solve_tiles_body,
                       static_argnames=("n", "tile_rows", "num_tiles"))


class SptrsvPlan:
    """Analysis-phase product for one triangular matrix (reference: the
    per-matrix level-set analysis kernel, SURVEY.md C7)."""

    def __init__(self, l, *, lower: bool = True,
                 unit_diagonal: bool = False, tile_rows: int = 0,
                 method: str = "auto", validate: bool = False):
        from .common import as_csr

        l = as_csr(l)
        self.shape = l.shape
        self.dtype = l.dtype
        self.lower = lower
        self.unit_diagonal = unit_diagonal
        if method == "auto":
            method = self._pick()
        if method not in METHODS:
            raise ValueError(f"unknown sptrsv method {method!r}; "
                             f"choose from {METHODS}")
        self.method = method
        sched = build_level_schedule(
            l, lower=lower, unit_diagonal=unit_diagonal, tile_rows=tile_rows
        )
        if validate:
            validate_schedule(sched)
        self.nlevels = sched.nlevels
        self.tile_rows = sched.tile_rows
        self.num_tiles = sched.num_tiles
        self.padding_ratio = sched.padded_slots / max(l.shape[0], 1)
        if method == "triton":
            from ..utils.backend import platform
            from .kernels import sptrsv_triton

            if platform() != "gpu":
                raise ValueError("the 'triton' sptrsv route needs a GPU")
            self._wb, self._num_warps = sptrsv_triton.launch_shape(
                sched.tile_rows, sched.width)
            arrs = sptrsv_triton.kernel_arrays(sched, self._wb)
        else:
            arrs = {"slot_row": sched.slot_row, "col": sched.col,
                    "val": sched.val, "inv_diag": sched.inv_diag}
        self._arrs = {k: jnp.asarray(v) for k, v in arrs.items()}
        self._jit_pure = jax.jit(self.apply_pure)
        # bytes touched per solve: schedule stream + x/b traffic
        self.bytes_per_iter = (
            sched.col.size * (4 + l.data.itemsize)
            + sched.padded_slots * (4 + l.data.itemsize)
            + l.shape[0] * 2 * l.data.itemsize
        )

    @staticmethod
    def _pick() -> str:
        """The one-launch kernel on a GPU, the XLA tile loop elsewhere."""
        from ..utils.backend import platform

        return "triton" if platform() == "gpu" else "tiles"

    def device_arrays(self):
        return dict(self._arrs)

    def apply_pure(self, arrs, b):
        """x = solve(L, b) with arrays passed explicitly (jit-argument
        safe); ``b`` is (n,) or (n, K)."""
        n = self.shape[0]
        if self.method == "triton":
            from .kernels import sptrsv_triton

            return sptrsv_triton.solve(
                arrs, b, n=n, tile_rows=self.tile_rows,
                num_tiles=self.num_tiles, wb=self._wb,
                num_warps=self._num_warps)
        pad = ((0, 2),) + ((0, 0),) * (b.ndim - 1)
        return _solve_tiles_body(arrs["slot_row"], arrs["col"], arrs["val"],
                                 arrs["inv_diag"], jnp.pad(b, pad), n,
                                 self.tile_rows, self.num_tiles)

    def apply_traced(self, b):
        return self.apply_pure(self.device_arrays(), b)

    def __call__(self, b):
        n = self.shape[0]
        b = jnp.asarray(b, dtype=self.dtype)
        if b.shape != (n,):
            raise ValueError(f"b must have shape ({n},), got {b.shape}")
        return self._jit_pure(self._arrs, b)


def sptrsv(l, b, *, lower: bool = True, unit_diagonal: bool = False,
           trans: bool = False, method: str = "auto", **kw):
    """Solve op(L) x = b, op = L^T if trans else L.

    ``lower`` describes the *stored* matrix ``l`` (CSR or CSC); with
    ``trans=True`` the solved operator's triangularity flips (the classic
    Cholesky backsolve L^T x = b given lower L). The level-set analysis is
    cached per derived matrix.
    """
    from .common import as_csr

    l = as_csr(l, trans)
    if trans:
        lower = not lower
    plans = _PLAN_CACHE.setdefault(l, {})
    key = ("sptrsv", lower, unit_diagonal, method, tuple(sorted(kw.items())))
    if key not in plans:
        if method == "jacobi":
            # truncated-Neumann sweep solve (bandwidth-bound; exact at
            # nlevels-1 sweeps) — see ops/sptrsv_iter.py
            from .sptrsv_iter import SptrsvJacobiPlan

            plans[key] = SptrsvJacobiPlan(
                l, lower=lower, unit_diagonal=unit_diagonal, **kw)
        else:
            plans[key] = SptrsvPlan(l, lower=lower,
                                    unit_diagonal=unit_diagonal,
                                    method=method, **kw)
    return plans[key](b)
