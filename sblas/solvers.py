"""Jitted iterative solvers on the plan API (device-resident CG / PCG).

examples/cg.py shows the host-loop version; in this module the whole
Krylov iteration lives inside a single ``lax.while_loop`` under jit, with
the matrix's retiled arrays passed as jit arguments
(``plan.device_arrays()`` + ``apply_pure``; closed-over arrays would be
embedded in the compiled program as constants). One dispatch per solve;
no host↔device traffic inside the loop.

    x, info = sblas.solvers.cg(A, b, tol=1e-6)
    x, info = sblas.solvers.cg(A, b, M=sblas.solvers.jacobi(A))

Preconditioners are ``(arrs, apply)`` pairs where ``apply(arrs, r) -> z``
is jit-composable; ``jacobi(a)`` builds diagonal scaling. (SSOR via two
SpTRSV tile solves composes the same way — see examples/cg.py for the
host-side variant.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .formats import CSR
from .ops.spmv import SpmvPlan


def jacobi(a: CSR):
    """Diagonal (Jacobi) preconditioner: z = r / diag(A)."""
    coo = a.tocoo()
    d = np.ones(a.shape[0], dtype=a.dtype)
    m = coo.row == coo.col
    d[coo.row[m]] = coo.data[m]
    inv = jnp.asarray((1.0 / d).astype(a.dtype))

    def apply(arrs, r):
        return arrs * r

    return inv, apply


@functools.partial(jax.jit, static_argnames=("apply_a", "apply_m"))
def _cg_loop(arrs_a, arrs_m, b, x0, tol, maxiter, apply_a, apply_m):
    bnorm = jnp.linalg.norm(b)
    r0 = b - apply_a(arrs_a, x0)
    z0 = apply_m(arrs_m, r0) if apply_m else r0
    state = (x0, r0, z0, z0, jnp.vdot(r0, z0), jnp.asarray(0, jnp.int32))

    def cond(s):
        _, r, *_ , it = s
        return (jnp.linalg.norm(r) > tol * bnorm) & (it < maxiter)

    def step(s):
        x, r, z, p, rz, it = s
        ap = apply_a(arrs_a, p)
        alpha = rz / jnp.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = apply_m(arrs_m, r) if apply_m else r
        rz_new = jnp.vdot(r, z)
        p = z + (rz_new / rz) * p
        return (x, r, z, p, rz_new, it + 1)

    x, r, *_, it = lax.while_loop(cond, step, state)
    return x, it, jnp.linalg.norm(r) / jnp.maximum(bnorm, 1e-30)


def ichol(a: CSR, *, shift: float = 0.0, max_shift_tries: int = 6,
          trsv_sweeps: int | None = None):
    """IC(0) preconditioner: M = L L^T on the pattern of tril(A).

    Factorization is the native C++ sweep (python fallback); application
    is two jit-composable SpTRSV solves on the platform's route (forward
    on L, transposed back solve). On a non-positive pivot the diagonal is shifted
    (A + shift·diag(A)) and retried, doubling up to ``max_shift_tries``
    times — the standard shifted-IC rescue. Returns an (arrs, apply)
    pair for :func:`cg` / :func:`bicgstab`.

    ``trsv_sweeps=k`` swaps the exact solves for k Jacobi sweeps each
    (``ops.sptrsv_iter``): the triangular applies become bandwidth-bound
    SpMV passes instead of the latency-bound wavefront — the
    Anzt/Chow/Dongarra inexact-preconditioning trade. The preconditioner
    becomes nonstationary only in exact arithmetic terms; for fixed k it
    stays a fixed linear operator, so plain CG remains valid.
    """
    from .formats import tril, csr_transpose
    from .ops.sptrsv import SptrsvPlan
    from . import native

    lo = tril(a)
    n = lo.shape[0]
    last = lo.indptr[1:] - 1
    has_diag = (lo.indptr[1:] > lo.indptr[:-1]) & (
        lo.indices[np.maximum(last, 0)] == np.arange(n))
    if not has_diag.all():
        raise ValueError("IC(0) needs a full diagonal")
    diag_mask = lo.indices == lo.row_ids()
    base = lo.data.astype(np.float64).copy()
    sh = shift if shift > 0 else 0.0
    for _ in range(max_shift_tries + 1):
        vals = base.copy()
        if sh:
            vals[diag_mask] *= (1.0 + sh)
        rc = native.ic0_inplace(lo.indptr, lo.indices, vals)
        if rc == -1:
            rc = _ic0_numpy(lo.indptr, lo.indices, vals)
        if rc == 0:
            break
        sh = max(2 * sh, 1e-3)
    else:
        raise ValueError("IC(0) breakdown persists after diagonal shifts")

    l = CSR(lo.shape, lo.indptr, lo.indices, vals.astype(a.dtype))
    if trsv_sweeps is not None:
        from .ops.sptrsv_iter import SptrsvJacobiPlan

        fwd = SptrsvJacobiPlan(l, lower=True, sweeps=trsv_sweeps)
        bwd = SptrsvJacobiPlan(csr_transpose(l), lower=False,
                               sweeps=trsv_sweeps)
    else:
        fwd = SptrsvPlan(l, lower=True)
        bwd = SptrsvPlan(csr_transpose(l), lower=False)
    arrs = {"f": fwd.device_arrays(), "b": bwd.device_arrays()}

    def apply(arrs, r):
        return bwd.apply_pure(arrs["b"], fwd.apply_pure(arrs["f"], r))

    return arrs, apply


def ilu(a: CSR, *, shift: float = 0.0, max_shift_tries: int = 6,
        trsv_sweeps: int | None = None):
    """ILU(0) preconditioner: M = L U on the pattern of A (nonsymmetric).

    The factorization is the native C++ IKJ sweep (`sblas_ilu0_f64`;
    python fallback), application is two jit-composable SpTRSV solves:
    forward on unit-diagonal L, back solve on U. On a zero pivot
    the diagonal is shifted (A + shift·diag(A)) and retried, doubling up
    to ``max_shift_tries`` times. Returns an (arrs, apply) pair for
    :func:`gmres` / :func:`bicgstab` (reference: s-blas has no solver
    layer — this composes the SpTRSV capability the way cuSPARSE users
    compose csrilu02 + csrsv2).
    """
    from .formats import tril, triu, has_full_diagonal
    from .ops.sptrsv import SptrsvPlan
    from . import native

    if a.shape[0] != a.shape[1]:
        raise ValueError("ILU(0) needs a square matrix")
    if not has_full_diagonal(a):
        raise ValueError("ILU(0) needs a full diagonal")
    coo = a.tocoo()
    diag_mask = coo.row == coo.col
    base = coo.data.astype(np.float64).copy()
    sh = shift if shift > 0 else 0.0
    for _ in range(max_shift_tries + 1):
        vals = base.copy()
        if sh:
            vals[diag_mask] *= (1.0 + sh)
        fac = CSR(a.shape, a.indptr, a.indices, vals)
        rc = native.ilu0_inplace(fac.indptr, fac.indices, fac.data)
        if rc == -1:
            rc = _ilu0_numpy(fac.indptr, fac.indices, fac.data)
        if rc == 0:
            break
        sh = max(2 * sh, 1e-3)
    else:
        raise ValueError("ILU(0) breakdown persists after diagonal shifts")

    fac = CSR(a.shape, fac.indptr, fac.indices, fac.data.astype(a.dtype))
    l = tril(fac, unit_diagonal=True)
    u = triu(fac)
    if trsv_sweeps is not None:
        from .ops.sptrsv_iter import SptrsvJacobiPlan

        fwd = SptrsvJacobiPlan(l, lower=True, unit_diagonal=True,
                               sweeps=trsv_sweeps)
        bwd = SptrsvJacobiPlan(u, lower=False, sweeps=trsv_sweeps)
    else:
        fwd = SptrsvPlan(l, lower=True, unit_diagonal=True)
        bwd = SptrsvPlan(u, lower=False)
    arrs = {"f": fwd.device_arrays(), "b": bwd.device_arrays()}

    def apply(arrs, r):
        return bwd.apply_pure(arrs["b"], fwd.apply_pure(arrs["f"], r))

    return arrs, apply


def _ilu0_numpy(indptr, indices, vals) -> int:
    """Reference ILU(0) (slow python IKJ; the C++ path is the fast one)."""
    n = len(indptr) - 1
    diag = np.full(n, -1, dtype=np.int64)
    pos = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        p0, p1 = int(indptr[i]), int(indptr[i + 1])
        pos[indices[p0:p1]] = np.arange(p0, p1)
        bad = 0
        for p in range(p0, p1):
            k = int(indices[p])
            if k >= i:
                break
            ukk = vals[diag[k]]
            if ukk == 0.0:
                bad = k + 1
                break
            lik = vals[p] / ukk
            vals[p] = lik
            for q in range(int(diag[k]) + 1, int(indptr[k + 1])):
                pj = pos[indices[q]]
                if pj >= 0:
                    vals[pj] -= lik * vals[q]
        if not bad:
            pd = pos[i]
            if pd < 0 or vals[pd] == 0.0:
                bad = i + 1
            else:
                diag[i] = pd
        pos[indices[p0:p1]] = -1
        if bad:
            return int(bad)
    return 0


def _ic0_numpy(indptr, indices, vals) -> int:
    """Reference IC(0) (slow python loops; the C++ path is the fast one)."""
    n = len(indptr) - 1
    for i in range(n):
        p0, p1 = int(indptr[i]), int(indptr[i + 1])
        for p in range(p0, p1 - 1):
            k = int(indices[p])
            k0, k1 = int(indptr[k]), int(indptr[k + 1]) - 1
            dot = 0.0
            a_, b_ = p0, k0
            while a_ < p and b_ < k1:
                ca, cb = int(indices[a_]), int(indices[b_])
                if ca == cb:
                    dot += vals[a_] * vals[b_]
                    a_ += 1
                    b_ += 1
                elif ca < cb:
                    a_ += 1
                else:
                    b_ += 1
            vals[p] = (vals[p] - dot) / vals[int(indptr[k + 1]) - 1]
        d = vals[p1 - 1] - float(np.sum(vals[p0:p1 - 1] ** 2))
        if not d > 0.0:
            return i + 1
        vals[p1 - 1] = np.sqrt(d)
    return 0


@functools.partial(jax.jit,
                   static_argnames=("apply_a", "apply_m", "restart"))
def _gmres_loop(arrs_a, arrs_m, b, x0, tol, maxiter, restart, apply_a,
                apply_m):
    """Restarted GMRES(m), right-preconditioned (solves A·M⁻¹u = b,
    x = M⁻¹u, so the minimized residual is the TRUE residual).

    Whole solve is one while_loop over restart cycles; each cycle runs a
    fixed m Arnoldi steps (static shapes — no data-dependent early exit
    inside the cycle, the standard jit-able formulation) with modified
    Gram–Schmidt and Givens rotations, then a dense (m, m) triangular
    solve. The cycle's final residual norm falls out of the rotated RHS
    (|g[m]|) for free — the outer condition needs no extra SpMV."""
    m = restart
    n = b.shape[0]
    dtype = b.dtype
    bnorm = jnp.linalg.norm(b)

    def precond(v):
        return apply_m(arrs_m, v) if apply_m else v

    def cycle(x):
        r = b - apply_a(arrs_a, x)
        beta = jnp.linalg.norm(r)
        v0 = r / jnp.maximum(beta, 1e-30)
        vs = jnp.zeros((m + 1, n), dtype).at[0].set(v0)
        h = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def arnoldi(j, st):
            vs, h, cs, sn, g = st
            w = apply_a(arrs_a, precond(vs[j]))

            def mgs(i, wh):
                w, hcol = wh
                hij = jnp.where(i <= j, jnp.vdot(vs[i], w), 0.0)
                return (w - hij * vs[i], hcol.at[i].set(hij))

            w, hcol = lax.fori_loop(
                0, m + 1, mgs, (w, jnp.zeros(m + 1, dtype)))
            hj1 = jnp.linalg.norm(w)
            hcol = hcol.at[j + 1].set(hj1)
            vs = vs.at[j + 1].set(w / jnp.maximum(hj1, 1e-30))

            def rot(i, hc):
                do = i < j
                hi, hi1 = hc[i], hc[i + 1]
                return (hc.at[i].set(jnp.where(do, cs[i] * hi + sn[i] * hi1,
                                               hi))
                        .at[i + 1].set(jnp.where(do,
                                                 -sn[i] * hi + cs[i] * hi1,
                                                 hi1)))

            hcol = lax.fori_loop(0, m, rot, hcol)
            denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c = jnp.where(denom > 0, hcol[j] / jnp.maximum(denom, 1e-30),
                          1.0)
            s = jnp.where(denom > 0, hcol[j + 1] / jnp.maximum(denom, 1e-30),
                          0.0)
            cs = cs.at[j].set(c)
            sn = sn.at[j].set(s)
            hcol = hcol.at[j].set(denom).at[j + 1].set(0.0)
            h = h.at[:, j].set(hcol)
            gj = g[j]
            g = g.at[j].set(c * gj).at[j + 1].set(-s * gj)
            return (vs, h, cs, sn, g)

        vs, h, cs, sn, g = lax.fori_loop(0, m, arnoldi,
                                         (vs, h, cs, sn, g))
        # h[:m,:m] is upper triangular after the rotations; a zero pivot
        # means that direction converged exactly — neutralize it (y_i = 0)
        hd = jnp.diagonal(h[:m, :m])
        safe = jnp.where(hd == 0, 1.0, hd)
        hm = h[:m, :m].at[jnp.arange(m), jnp.arange(m)].set(safe)
        y = jax.scipy.linalg.solve_triangular(
            hm, jnp.where(hd == 0, 0.0, g[:m]), lower=False)
        x = x + precond(vs[:m].T @ y)
        return x, jnp.abs(g[m])

    def cond(st):
        _, rnorm, it = st
        return (rnorm > tol * bnorm) & (it < maxiter)

    def step(st):
        x, _, it = st
        x, rnorm = cycle(x)
        return (x, rnorm, it + m)

    r0 = jnp.linalg.norm(b - apply_a(arrs_a, x0))
    x, rnorm, it = lax.while_loop(cond, step,
                                  (x0, r0, jnp.asarray(0, jnp.int32)))
    return x, it, rnorm / jnp.maximum(bnorm, 1e-30)


def gmres(a, b, *, tol: float = 1e-6, maxiter: int = 1000,
          restart: int = 30, M=None, x0=None, method: str = "auto"):
    """Restarted GMRES(m) for general square A (right-preconditioned).

    ``restart`` is the Arnoldi cycle length m (memory: an (m+1, n) basis
    lives on device). ``maxiter`` counts matvecs. Returns
    ``(x, {"iterations", "rel_residual"})``.
    """
    plan = a if isinstance(a, SpmvPlan) else SpmvPlan(a, method)
    n = plan.shape[0]
    if plan.shape[0] != plan.shape[1]:
        raise ValueError("gmres needs a square matrix")
    b = jnp.asarray(b, dtype=plan.dtype)
    x0 = (jnp.zeros(n, dtype=plan.dtype) if x0 is None
          else jnp.asarray(x0, dtype=plan.dtype))
    arrs_m, apply_m = (None, None) if M is None else M
    x, it, res = _gmres_loop(
        plan.device_arrays(), arrs_m, b, x0,
        jnp.asarray(tol, dtype=plan.dtype),
        jnp.asarray(maxiter, jnp.int32), int(restart),
        apply_a=plan.apply_pure, apply_m=apply_m,
    )
    return x, {"iterations": int(it), "rel_residual": float(res)}


@functools.partial(jax.jit, static_argnames=("apply_a", "apply_m"))
def _bicgstab_loop(arrs_a, arrs_m, b, x0, tol, maxiter, apply_a, apply_m):
    bnorm = jnp.linalg.norm(b)
    r0 = b - apply_a(arrs_a, x0)
    rhat = r0
    state = (x0, r0, r0, jnp.vdot(rhat, r0), jnp.asarray(0, jnp.int32))

    def cond(s):
        _, r, *_ , it = s
        return (jnp.linalg.norm(r) > tol * bnorm) & (it < maxiter)

    def step(s):
        x, r, p, rho, it = s
        ph = apply_m(arrs_m, p) if apply_m else p
        v = apply_a(arrs_a, ph)
        alpha = rho / jnp.vdot(rhat, v)
        ssr = r - alpha * v
        sh = apply_m(arrs_m, ssr) if apply_m else ssr
        t = apply_a(arrs_a, sh)
        omega = jnp.vdot(t, ssr) / jnp.vdot(t, t)
        x = x + alpha * ph + omega * sh
        r = ssr - omega * t
        rho_new = jnp.vdot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        return (x, r, p, rho_new, it + 1)

    x, r, *_, it = lax.while_loop(cond, step, state)
    return x, it, jnp.linalg.norm(r) / jnp.maximum(bnorm, 1e-30)


def bicgstab(a, b, *, tol: float = 1e-6, maxiter: int = 1000, M=None,
             x0=None, method: str = "auto"):
    """BiCGSTAB for general (nonsymmetric) square A — same jitted
    while_loop structure as :func:`cg`."""
    plan = a if isinstance(a, SpmvPlan) else SpmvPlan(a, method)
    n = plan.shape[0]
    if plan.shape[0] != plan.shape[1]:
        raise ValueError("bicgstab needs a square matrix")
    b = jnp.asarray(b, dtype=plan.dtype)
    x0 = (jnp.zeros(n, dtype=plan.dtype) if x0 is None
          else jnp.asarray(x0, dtype=plan.dtype))
    arrs_m, apply_m = (None, None) if M is None else M
    x, it, res = _bicgstab_loop(
        plan.device_arrays(), arrs_m, b, x0,
        jnp.asarray(tol, dtype=plan.dtype),
        jnp.asarray(maxiter, jnp.int32),
        apply_a=plan.apply_pure, apply_m=apply_m,
    )
    return x, {"iterations": int(it), "rel_residual": float(res)}


def cg(a, b, *, tol: float = 1e-6, maxiter: int = 1000, M=None, x0=None,
       method: str = "auto"):
    """Conjugate gradient for SPD A (CSR/CSC), one jitted while_loop.

    ``M`` is an (arrs, apply) pair (e.g. ``jacobi(a)``). Returns
    (x, {"iterations", "rel_residual"}).
    """
    plan = a if isinstance(a, SpmvPlan) else SpmvPlan(a, method)
    n = plan.shape[0]
    if plan.shape[0] != plan.shape[1]:
        raise ValueError("cg needs a square matrix")
    b = jnp.asarray(b, dtype=plan.dtype)
    x0 = (jnp.zeros(n, dtype=plan.dtype) if x0 is None
          else jnp.asarray(x0, dtype=plan.dtype))
    arrs_m, apply_m = (None, None) if M is None else M
    # maxiter is a traced operand (only bounds the while_loop condition):
    # changing it must not trigger a recompile
    x, it, res = _cg_loop(
        plan.device_arrays(), arrs_m, b, x0,
        jnp.asarray(tol, dtype=plan.dtype),
        jnp.asarray(maxiter, jnp.int32),
        apply_a=plan.apply_pure, apply_m=apply_m,
    )
    return x, {"iterations": int(it), "rel_residual": float(res)}
