"""Multi-host ('hosts','chips') hierarchical-collective plans on the
8-virtual-device CPU mesh reshaped (2, 4) / (4, 2) (SURVEY.md C11)."""

import numpy as np
import pytest

from sblas import datasets
from sblas.formats import COO, coo_to_csr
from sblas.golden import rel_err, spmv_golden, spmm_golden
from sblas.parallel import HierSpmvPlan, HierSpmmPlan, make_mesh_hier


@pytest.fixture(scope="module", params=[(2, 4), (4, 2)])
def hmesh(request):
    return make_mesh_hier(*request.param)


@pytest.mark.parametrize("strategy", ["even_rows", "nnz_balanced",
                                      "nnz_split"])
def test_hier_spmv_ell(hmesh, strategy):
    a = datasets.random_csr(700, 600, 7, seed=5, dtype=np.float64)
    x = np.random.default_rng(6).standard_normal(600)
    p = HierSpmvPlan(a, hmesh, strategy=strategy)
    assert p.local_method == "ell"  # regular rows -> one ELL slab
    y = np.asarray(p(x))
    assert rel_err(y, spmv_golden(a, x)) < 1e-12


@pytest.mark.parametrize("strategy", ["nnz_balanced", "nnz_split"])
def test_hier_spmv_bucket(hmesh, strategy):
    # power-law rows: degree-bucket local bodies under both merges
    a = datasets.emulate("uk-2002", scale=0.003, dtype=np.float32)
    x = np.random.default_rng(7).standard_normal(a.shape[1]).astype(np.float32)
    p = HierSpmvPlan(a, hmesh, strategy=strategy)
    assert p.local_method == "bucket"
    y = np.asarray(p(x))
    assert rel_err(y, spmv_golden(a, x)) < 1e-5


@pytest.mark.parametrize("strategy", ["nnz_balanced", "nnz_split"])
def test_hier_spmm(hmesh, strategy):
    a = datasets.random_csr(500, 400, 6, seed=8, dtype=np.float32)
    x = np.random.default_rng(9).standard_normal((400, 8)).astype(np.float32)
    p = HierSpmmPlan(a, hmesh, strategy=strategy)
    y = np.asarray(p(x))
    assert rel_err(y, spmm_golden(a, x)) < 1e-5


def test_hier_alpha_beta(hmesh):
    a = datasets.random_csr(300, 300, 5, seed=10, dtype=np.float64)
    x = np.random.default_rng(11).standard_normal(300)
    y0 = np.random.default_rng(12).standard_normal(300)
    got = np.asarray(HierSpmvPlan(a, hmesh)(x, alpha=2.5, beta=-0.5, y=y0))
    want = 2.5 * spmv_golden(a, x) - 0.5 * y0
    assert rel_err(got, want) < 1e-12


def test_hier_rejects_flat_mesh():
    from sblas.parallel import make_mesh

    a = datasets.random_csr(64, 64, 4, seed=13, dtype=np.float64)
    with pytest.raises(ValueError, match="hosts"):
        HierSpmvPlan(a, make_mesh(8))


def test_hier_fuzz(hmesh):
    rng = np.random.default_rng(5000)
    for seed in range(3):
        m = int(rng.integers(16, 900))
        n = int(rng.integers(16, 900))
        nnz = int(rng.integers(1, max(m * n // 8, 2)))
        coo = COO((m, n), rng.integers(0, m, nnz), rng.integers(0, n, nnz),
                  rng.standard_normal(nnz).astype(np.float32))
        a = coo_to_csr(coo).astype(np.float32)
        x = rng.standard_normal(n).astype(np.float32)
        strategy = ["even_rows", "nnz_balanced", "nnz_split"][seed % 3]
        y = np.asarray(HierSpmvPlan(a, hmesh, strategy=strategy)(x))
        assert rel_err(y, spmv_golden(a, x)) < 1e-4, (m, n, nnz, strategy)
