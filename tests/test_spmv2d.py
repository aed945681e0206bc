"""2D-partitioned distributed SpMV on the virtual CPU mesh."""

import numpy as np
import pytest

from sblas import datasets
from sblas.golden import rel_err, spmv_golden
from sblas.parallel import Dist2DSpmvPlan, dist_spmv2d, make_mesh2d


@pytest.mark.parametrize("grid", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_2d_ell_grids(grid):
    mesh = make_mesh2d(*grid)
    a = datasets.random_csr(600, 500, 6, seed=1, dtype=np.float32)
    x = np.random.default_rng(0).standard_normal(500).astype(np.float32)
    p = Dist2DSpmvPlan(a, mesh)
    assert p.grid == grid
    assert p.local_method == "ell"
    assert rel_err(np.asarray(p(x)), spmv_golden(a, x)) < 1e-5


def test_2d_bucket_body():
    # power-law rows: each block's local body is degree buckets
    mesh = make_mesh2d(2, 4)
    a = datasets.emulate("uk-2002", scale=0.003, dtype=np.float32)
    x = np.random.default_rng(1).standard_normal(a.shape[1]).astype(
        np.float32)
    p = Dist2DSpmvPlan(a, mesh)
    assert p.local_method == "bucket"
    assert rel_err(np.asarray(p(x)), spmv_golden(a, x)) < 1e-4


def test_2d_auto_picks_mesh_and_falls_back():
    # auto mesh factorization; regular f64 rows take the ELL body
    a = datasets.random_csr(300, 300, 4, seed=2, dtype=np.float64)
    x = np.random.default_rng(2).standard_normal(300)
    p = Dist2DSpmvPlan(a)
    assert p.local_method == "ell"
    assert rel_err(np.asarray(p(x)), spmv_golden(a, x)) < 1e-12


def test_2d_alpha_beta():
    mesh = make_mesh2d(2, 2)
    a = datasets.random_csr(256, 256, 5, seed=3, dtype=np.float32)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(256).astype(np.float32)
    y0 = rng.standard_normal(256).astype(np.float32)
    out = np.asarray(Dist2DSpmvPlan(a, mesh)(x, alpha=2.0, beta=0.5, y=y0))
    assert rel_err(out, spmv_golden(a, x, alpha=2.0, beta=0.5, y=y0)) < 1e-5


def test_2d_empty_rows_and_rect():
    # tall rectangular with empty rows exercises block padding
    mesh = make_mesh2d(2, 4)
    a = datasets.random_csr(700, 260, 2, seed=4, dtype=np.float32)
    x = np.random.default_rng(4).standard_normal(260).astype(np.float32)
    got = np.asarray(dist_spmv2d(a, x, mesh))
    assert rel_err(got, spmv_golden(a, x)) < 1e-5


def test_2d_rejects_1d_mesh():
    from sblas.parallel import make_mesh

    a = datasets.random_csr(64, 64, 3, seed=5, dtype=np.float32)
    with pytest.raises(ValueError):
        Dist2DSpmvPlan(a, make_mesh(4))


@pytest.mark.parametrize("grid,k", [((2, 4), 8), ((4, 2), 3)])
def test_2d_spmm(grid, k):
    from sblas.parallel import Dist2DSpmmPlan

    mesh = make_mesh2d(*grid)
    a = datasets.random_csr(500, 420, 6, seed=6, dtype=np.float32)
    x = np.random.default_rng(6).standard_normal((420, k)).astype(np.float32)
    p = Dist2DSpmmPlan(a, mesh)
    assert rel_err(np.asarray(p(x)), spmv_golden(a, x)) < 1e-5


def test_2d_spmm_alpha_beta():
    from sblas.parallel import dist_spmm2d, Dist2DSpmmPlan

    mesh = make_mesh2d(2, 2)
    a = datasets.random_csr(256, 256, 5, seed=7, dtype=np.float32)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((256, 4)).astype(np.float32)
    y0 = rng.standard_normal((256, 4)).astype(np.float32)
    out = np.asarray(Dist2DSpmmPlan(a, mesh)(x, alpha=1.5, beta=-2.0, y=y0))
    assert rel_err(out, spmv_golden(a, x, alpha=1.5, beta=-2.0, y=y0)) < 1e-5


def test_2d_spmm_bucket_body():
    from sblas.parallel import Dist2DSpmmPlan

    mesh = make_mesh2d(2, 4)
    a = datasets.emulate("uk-2002", scale=0.003, dtype=np.float32)
    x = np.random.default_rng(8).standard_normal((a.shape[1], 8)).astype(
        np.float32)
    p = Dist2DSpmmPlan(a, mesh)
    assert p.local_method == "bucket"
    assert rel_err(np.asarray(p(x)), spmv_golden(a, x)) < 1e-4
    # a second k reuses the plan's arrays
    x2 = np.random.default_rng(9).standard_normal((a.shape[1], 2)).astype(
        np.float32)
    assert rel_err(np.asarray(p(x2)), spmv_golden(a, x2)) < 1e-4


def test_2d_spmm_bytes_model():
    """The stream model counts every stacked slab: R*C blocks, each padded
    to the common geometry, 4 index + itemsize value bytes per slot."""
    from sblas.parallel import Dist2DSpmmPlan

    mesh = make_mesh2d(2, 4)
    a = datasets.emulate("cant", scale=0.04, dtype=np.float32)
    p = Dist2DSpmmPlan(a, mesh)
    slabs = p._arrs[0]
    assert all(col.shape[:2] == (2, 4) for col, _ in slabs)
    assert p.bytes_per_iter == sum(col.size for col, _ in slabs) * (4 + 4)
    assert p.bytes_per_iter >= a.nnz * 8
