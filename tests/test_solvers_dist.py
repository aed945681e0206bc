"""Distributed Krylov solvers on the 8-virtual-device CPU mesh.

The whole iteration is one jitted while_loop whose SpMV is the shard_map
body — so these tests exercise the collective path every iteration.
"""

import numpy as np
import pytest

import jax

from sblas import datasets, solvers
from sblas.formats import CSR
from sblas.parallel import DistSpmvPlan, dist_cg, dist_bicgstab

pytestmark = pytest.mark.skipif(
    jax.device_count() < 2, reason="needs the multi-device CPU mesh")


def test_dist_cg_matches_direct():
    a = datasets.poisson2d(32, dtype=np.float32)
    b = np.random.default_rng(1).standard_normal(a.shape[0]).astype(
        np.float32)
    x, info = dist_cg(a, b, tol=1e-5)
    assert info["rel_residual"] < 1e-5
    err = (np.linalg.norm(a.to_scipy() @ np.asarray(x) - b)
           / np.linalg.norm(b))
    assert err < 5e-5


def test_dist_cg_accepts_plan_and_matches_single_chip():
    a = datasets.poisson2d(24, dtype=np.float32)
    plan = DistSpmvPlan(a, strategy="nnz_balanced")
    b = np.random.default_rng(3).standard_normal(a.shape[0]).astype(
        np.float32)
    x_d, info_d = dist_cg(plan, b, tol=1e-5)
    x_s, info_s = solvers.cg(a, b, tol=1e-5)
    # same algorithm, same matrix: iteration counts agree within noise
    assert abs(info_d["iterations"] - info_s["iterations"]) <= 3
    np.testing.assert_allclose(np.asarray(x_d), np.asarray(x_s),
                               rtol=0, atol=5e-4)


def test_dist_cg_nnz_split_strategy():
    a = datasets.poisson2d(20, dtype=np.float32)
    b = np.random.default_rng(5).standard_normal(a.shape[0]).astype(
        np.float32)
    x, info = dist_cg(a, b, strategy="nnz_split", tol=1e-5)
    assert info["rel_residual"] < 1e-5
    err = (np.linalg.norm(a.to_scipy() @ np.asarray(x) - b)
           / np.linalg.norm(b))
    assert err < 5e-5


def test_dist_pcg_jacobi():
    a = datasets.poisson2d(24, dtype=np.float32)
    s = a.to_scipy().astype(np.float64)
    import scipy.sparse as sp
    rng = np.random.default_rng(7)
    d = sp.diags(np.sqrt(np.exp(rng.uniform(-3, 3, a.shape[0]))))
    bad = (d @ s @ d).tocsr()
    bad.sort_indices()
    a_bad = CSR.from_scipy(bad).astype(np.float32)
    b = rng.standard_normal(a_bad.shape[0]).astype(np.float32)
    _, plain = dist_cg(a_bad, b, tol=1e-4, maxiter=3000)
    _, pre = dist_cg(a_bad, b, tol=1e-4, maxiter=3000,
                     M=solvers.jacobi(a_bad))
    assert pre["rel_residual"] < 1e-4
    assert pre["iterations"] < plain["iterations"]


def test_dist_bicgstab_nonsymmetric():
    # diagonally dominant nonsymmetric system
    n = 900
    rng = np.random.default_rng(11)
    a = datasets.random_csr(n, n, 9, bandwidth=40, seed=11,
                            dtype=np.float64)
    s = a.to_scipy().tolil()
    s.setdiag(np.abs(s).sum(axis=1).A1 + 1.0)
    a = CSR.from_scipy(s.tocsr()).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    x, info = dist_bicgstab(a, b, tol=1e-6, maxiter=500)
    assert info["rel_residual"] < 1e-6
    err = (np.linalg.norm(a.to_scipy() @ np.asarray(x) - b)
           / np.linalg.norm(b))
    assert err < 1e-5


def test_dist_cg_bucket_local_body():
    # scattered SPD matrix: graph Laplacian + I has power-law rows, so the
    # local body is degree buckets with a scatter-add merge
    g = datasets.powerlaw_graph(4096, avg_deg=12, seed=3,
                                dtype=np.float32)
    s = g.to_scipy()
    s = ((s + s.T) != 0).astype(np.float64)
    lap = (-s).tolil()
    lap.setdiag(np.asarray(s.sum(axis=1)).ravel() + 1.0)
    a = CSR.from_scipy(lap.tocsr()).astype(np.float32)
    plan = DistSpmvPlan(a)
    assert plan.local_method == "bucket"
    b = np.random.default_rng(13).standard_normal(a.shape[0]).astype(
        np.float32)
    x, info = dist_cg(plan, b, tol=1e-5, maxiter=2000)
    assert info["rel_residual"] < 1e-5
    err = (np.linalg.norm(a.to_scipy() @ np.asarray(x) - b)
           / np.linalg.norm(b))
    assert err < 5e-5


def test_dist_gmres_nonsymmetric():
    from sblas.parallel import dist_gmres

    n = 640
    rng = np.random.default_rng(31)
    a = datasets.random_csr(n, n, 9, bandwidth=40, seed=31,
                            dtype=np.float64)
    s = a.to_scipy().tolil()
    s.setdiag(np.abs(s).sum(axis=1).A1 + 1.0)
    a = CSR.from_scipy(s.tocsr()).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    x, info = dist_gmres(a, b, tol=1e-6, maxiter=600, restart=25)
    assert info["rel_residual"] < 1e-6
    err = (np.linalg.norm(a.to_scipy() @ np.asarray(x) - b)
           / np.linalg.norm(b))
    assert err < 1e-5
