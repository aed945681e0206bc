"""Conjugate gradient on sblas kernels — the classic sparse-BLAS demo.

Shows the intended usage pattern for iterative solvers:

- build ONE plan per matrix (analysis/retile once, like the reference's
  cuSPARSE-style analyse/execute split) and call it in the loop;
- the preconditioned variant applies an SSOR preconditioner as two
  triangular solves per iteration (SpTRSV in its natural habitat —
  M = (D+L) D^-1 (D+L)^T for SPD A, applied via forward + transposed
  back solve on the same lower factor).

Run:  python examples/cg.py [n]         (Poisson 2D on an n x n grid)
"""

import sys

import numpy as np

import sblas
from sblas import datasets
from sblas.ops import SpmvPlan, SptrsvPlan


def cg(a, b, *, tol=1e-6, maxiter=1000, m_solve=None):
    """Solve A x = b (SPD A) by (preconditioned) conjugate gradient.

    ``m_solve(r) -> z`` applies the preconditioner; None = identity.
    Returns (x, iterations, final relative residual).
    """
    plan = SpmvPlan(a)
    b = np.asarray(b, dtype=a.dtype)
    bnorm = float(np.linalg.norm(b))
    x = np.zeros_like(b)
    r = b.copy()
    z = m_solve(r) if m_solve else r
    p = z.copy()
    rz = float(r @ z)
    for it in range(1, maxiter + 1):
        ap = np.asarray(plan(p))
        alpha = rz / float(p @ ap)
        x += alpha * p
        r -= alpha * ap
        res = float(np.linalg.norm(r)) / max(bnorm, 1e-30)
        if res < tol:
            return x, it, res
        z = m_solve(r) if m_solve else r
        rz_new = float(r @ z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, maxiter, res


def ssor_preconditioner(a, omega: float = 1.0):
    """SSOR: M = (D/w + L) (D/w)^-1 (D/w + L)^T for SPD A = L + D + L^T.

    Applied as one forward SpTRSV on (D/w + L), a diagonal scale, and one
    transposed back solve on the same stored factor (sptrsv trans=True —
    no second analysis, no transposed copy)."""
    lo = sblas.tril(a)  # includes the diagonal
    coo = lo.tocoo()
    diag = np.zeros(a.shape[0], dtype=np.float64)
    diag[coo.row[coo.row == coo.col]] = coo.data[coo.row == coo.col]
    if omega != 1.0:
        scaled = coo.data.copy()
        scaled[coo.row == coo.col] /= omega
        lo = sblas.coo_to_csr(
            sblas.COO(lo.shape, coo.row, coo.col, scaled))
        diag = diag / omega
    fwd = SptrsvPlan(lo, lower=True)
    bwd = SptrsvPlan(sblas.csr_transpose(lo), lower=False)
    dscale = (diag).astype(a.dtype)

    def m_solve(r):
        y = np.asarray(fwd(r))
        return np.asarray(bwd(y * dscale))

    return m_solve


def main():
    import os

    if os.environ.get("SBLAS_PLATFORM"):
        # e.g. SBLAS_PLATFORM=cpu, set before any device API call
        import jax

        jax.config.update("jax_platforms", os.environ["SBLAS_PLATFORM"])
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 48
    a = datasets.poisson2d(n, dtype=np.float32)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a.shape[0]).astype(np.float32)

    x, it, res = cg(a, b, tol=1e-5)
    print(f"CG          : {it:4d} iterations, rel residual {res:.2e}")

    x, it, res = cg(a, b, tol=1e-5, m_solve=ssor_preconditioner(a))
    print(f"CG + SSOR   : {it:4d} iterations, rel residual {res:.2e}")

    # the library's jitted solvers (one lax.while_loop, IC(0) precond):
    from sblas import solvers

    xj, info = solvers.cg(a, b, tol=1e-5, M=solvers.ichol(a))
    print(f"jit CG+IC(0): {info['iterations']:4d} iterations, "
          f"rel residual {info['rel_residual']:.2e}")

    err = np.linalg.norm(a.to_scipy() @ x - b) / np.linalg.norm(b)
    print(f"check       : ||Ax-b||/||b|| = {err:.2e}")


if __name__ == "__main__":
    main()
