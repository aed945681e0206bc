"""Distributed Krylov solvers over the multi-chip SpMV plans.

The reference library's end use is driving its multi-GPU SpMV from
CG-style iteration loops (SURVEY.md §2 C5/C11 — the kernels exist to be
iterated). This version keeps the WHOLE iteration on-device:
``sblas.solvers``'s jitted ``lax.while_loop`` bodies are reused verbatim,
with ``apply_a = DistSpmvPlan.apply_pure`` — each iteration's SpMV runs
the shard_map body (all_gather of x, per-device ELL or bucket local
compute, psum merge under nnz_split), the vector algebra runs on the same
sharded arrays under one jit, and the dot products reduce globally via
GSPMD-inserted collectives. One dispatch per solve; zero host↔device
traffic inside the loop.

    from sblas.parallel import solvers_dist
    x, info = solvers_dist.dist_cg(A, b, tol=1e-6)              # builds plan
    x, info = solvers_dist.dist_cg(plan, b, M=solvers.jacobi(A))  # reuse plan

Preconditioners are the same ``(arrs, apply)`` pairs as the single-chip
solvers (``solvers.jacobi`` works unchanged: diagonal scaling is
elementwise, so it shards trivially).
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import solvers as _solvers
from .spmv_dist import DistSpmvPlan


def _as_plan(a, mesh, strategy) -> DistSpmvPlan:
    if isinstance(a, DistSpmvPlan):
        return a
    return DistSpmvPlan(a, mesh, strategy=strategy)


def dist_cg(a, b, *, mesh=None, strategy: str = "nnz_balanced",
            tol: float = 1e-6,
            maxiter: int = 1000, M=None, x0=None):
    """Conjugate gradient for SPD A, distributed over the 'chips' mesh.

    ``a`` is a CSR/CSC or an existing :class:`DistSpmvPlan` (reuse the plan
    across solves — partitioning/retiling is host work). Returns
    ``(x, {"iterations", "rel_residual"})`` like :func:`sblas.solvers.cg`.
    """
    plan = _as_plan(a, mesh, strategy)
    m, n = plan.shape
    if m != n:
        raise ValueError("cg needs a square matrix")
    b = jnp.asarray(b, dtype=plan.dtype)
    x0 = (jnp.zeros(n, dtype=plan.dtype) if x0 is None
          else jnp.asarray(x0, dtype=plan.dtype))
    arrs_m, apply_m = (None, None) if M is None else M
    x, it, res = _solvers._cg_loop(
        plan.device_arrays(), arrs_m, b, x0,
        jnp.asarray(tol, dtype=plan.dtype),
        jnp.asarray(maxiter, jnp.int32),
        apply_a=plan.apply_pure, apply_m=apply_m,
    )
    return x, {"iterations": int(it), "rel_residual": float(res)}


def dist_gmres(a, b, *, mesh=None, strategy: str = "nnz_balanced",
               tol: float = 1e-6,
               maxiter: int = 1000, restart: int = 30, M=None, x0=None):
    """Restarted GMRES(m) for general square A, distributed over the
    'chips' mesh (right-preconditioned; the (m+1, n) Arnoldi basis lives
    on device, sharded by GSPMD propagation)."""
    plan = _as_plan(a, mesh, strategy)
    m, n = plan.shape
    if m != n:
        raise ValueError("gmres needs a square matrix")
    b = jnp.asarray(b, dtype=plan.dtype)
    x0 = (jnp.zeros(n, dtype=plan.dtype) if x0 is None
          else jnp.asarray(x0, dtype=plan.dtype))
    arrs_m, apply_m = (None, None) if M is None else M
    x, it, res = _solvers._gmres_loop(
        plan.device_arrays(), arrs_m, b, x0,
        jnp.asarray(tol, dtype=plan.dtype),
        jnp.asarray(maxiter, jnp.int32), int(restart),
        apply_a=plan.apply_pure, apply_m=apply_m,
    )
    return x, {"iterations": int(it), "rel_residual": float(res)}


def dist_bicgstab(a, b, *, mesh=None, strategy: str = "nnz_balanced",
                  tol: float = 1e-6,
                  maxiter: int = 1000, M=None, x0=None):
    """BiCGSTAB for general square A, distributed over the 'chips' mesh."""
    plan = _as_plan(a, mesh, strategy)
    m, n = plan.shape
    if m != n:
        raise ValueError("bicgstab needs a square matrix")
    b = jnp.asarray(b, dtype=plan.dtype)
    x0 = (jnp.zeros(n, dtype=plan.dtype) if x0 is None
          else jnp.asarray(x0, dtype=plan.dtype))
    arrs_m, apply_m = (None, None) if M is None else M
    x, it, res = _solvers._bicgstab_loop(
        plan.device_arrays(), arrs_m, b, x0,
        jnp.asarray(tol, dtype=plan.dtype),
        jnp.asarray(maxiter, jnp.int32),
        apply_a=plan.apply_pure, apply_m=apply_m,
    )
    return x, {"iterations": int(it), "rel_residual": float(res)}
