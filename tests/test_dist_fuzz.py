"""Structural fuzz over the distributed plans on the 8-device CPU mesh.

The dist SpTRSV batching/dealing/exchange machinery is shape-sensitive
(the round-2 clamping bug appeared only for one (n, deg, seed) triple);
these sweep random structures through every plan against the goldens."""

import numpy as np
import pytest

from sblas import datasets
from sblas.formats import COO, coo_to_csr
from sblas.golden import (rel_err, spmv_golden, spmm_golden, sptrsv_golden)
from sblas.parallel import (DistSpmvPlan, DistSpmmPlan, DistSptrsvPlan,
                            make_mesh)


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8)


@pytest.mark.parametrize("seed", range(8))
def test_dist_sptrsv_fuzz(seed, mesh8):
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(40, 1500))
    deg = float(rng.uniform(1.5, 9.0))
    skew = float(rng.choice([0.0, 0.0, 1.2]))
    l = datasets.lower_triangular(n, deg, skew=skew, seed=seed,
                                  dtype=np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    x = np.asarray(DistSptrsvPlan(l, mesh8)(b))
    assert rel_err(x, sptrsv_golden(l, b)) < 1e-3, (n, deg, skew)


@pytest.mark.parametrize("seed", range(6))
def test_dist_spmv_fuzz(seed, mesh8):
    rng = np.random.default_rng(2000 + seed)
    m = int(rng.integers(16, 1200))
    n = int(rng.integers(16, 1200))
    nnz = int(rng.integers(1, max(m * n // 8, 2)))
    coo = COO((m, n), rng.integers(0, m, nnz), rng.integers(0, n, nnz),
              rng.standard_normal(nnz).astype(np.float32))
    a = coo_to_csr(coo).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    strategy = ["even_rows", "nnz_balanced", "nnz_split"][seed % 3]
    y = np.asarray(DistSpmvPlan(a, mesh8, strategy=strategy)(x))
    assert rel_err(y, spmv_golden(a, x)) < 1e-4, (m, n, nnz, strategy)


@pytest.mark.parametrize("seed", range(4))
def test_dist_spmm_fuzz(seed, mesh8):
    rng = np.random.default_rng(3000 + seed)
    m = int(rng.integers(16, 900))
    n = int(rng.integers(16, 900))
    k = int(rng.integers(1, 17))
    nnz = int(rng.integers(1, max(m * n // 8, 2)))
    coo = COO((m, n), rng.integers(0, m, nnz), rng.integers(0, n, nnz),
              rng.standard_normal(nnz).astype(np.float32))
    a = coo_to_csr(coo).astype(np.float32)
    x = rng.standard_normal((n, k)).astype(np.float32)
    strategy = ["even_rows", "nnz_balanced", "nnz_split", "nnz_split"][seed % 4]
    y = np.asarray(DistSpmmPlan(a, mesh8, strategy=strategy)(x))
    assert rel_err(y, spmm_golden(a, x)) < 1e-4, (m, n, k, nnz, strategy)


@pytest.mark.parametrize("seed", range(4))
def test_dist_2d_fuzz(seed, mesh8):
    from sblas.parallel import Dist2DSpmvPlan, make_mesh2d

    rng = np.random.default_rng(4000 + seed)
    grid = [(2, 4), (4, 2), (8, 1), (1, 8)][seed % 4]
    m = int(rng.integers(16, 1100))
    n = int(rng.integers(16, 1100))
    nnz = int(rng.integers(1, max(m * n // 8, 2)))
    coo = COO((m, n), rng.integers(0, m, nnz), rng.integers(0, n, nnz),
              rng.standard_normal(nnz).astype(np.float32))
    a = coo_to_csr(coo).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(Dist2DSpmvPlan(a, make_mesh2d(*grid))(x))
    assert rel_err(y, spmv_golden(a, x)) < 1e-4, (m, n, nnz, grid)


@pytest.mark.parametrize("seed", range(4))
def test_halo_fuzz(seed, mesh8):
    from sblas.parallel import HaloSpmvPlan

    rng = np.random.default_rng(5000 + seed)
    n = int(rng.integers(200, 4000))
    bw = int(rng.integers(2, 12))
    a = datasets.banded(n, bw, seed=seed, dtype=np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    try:
        p = HaloSpmvPlan(a, mesh8)
    except ValueError:
        return  # halo too wide for tiny shards — designed refusal
    assert rel_err(np.asarray(p(x)), spmv_golden(a, x)) < 1e-4, (n, bw)
