"""SpTRSM (multi-RHS triangular solve) vs scipy golden."""

import numpy as np
import pytest

from sblas import datasets
from sblas.formats import coo_to_csc, csr_transpose
from sblas.golden import rel_err, sptrsm_golden
from sblas.ops import SptrsmPlan, sptrsm, sptrsv


def _tol(dtype):
    return 1e-10 if dtype == np.float64 else 2e-4


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 8])
def test_sptrsm_tiles(dtype, k):
    l = datasets.lower_triangular(200, 5, seed=1, dtype=dtype)
    b = np.random.default_rng(0).standard_normal((200, k)).astype(dtype)
    x = np.asarray(sptrsm(l, b, method="tiles"))
    assert x.shape == (200, k)
    assert rel_err(x, sptrsm_golden(l, b)) < _tol(dtype)


def test_sptrsm_upper():
    l = datasets.lower_triangular(150, 4, seed=2, dtype=np.float32)
    u = csr_transpose(l)
    b = np.random.default_rng(1).standard_normal((150, 5)).astype(np.float32)
    x = np.asarray(sptrsm(u, b, lower=False, method="tiles"))
    assert rel_err(x, sptrsm_golden(u, b, lower=False)) < 2e-4


def test_sptrsm_matches_columnwise_sptrsv():
    l = datasets.lower_triangular(180, 5, seed=4, dtype=np.float32)
    b = np.random.default_rng(3).standard_normal((180, 3)).astype(np.float32)
    xm = np.asarray(sptrsm(l, b, method="tiles"))
    for j in range(3):
        xj = np.asarray(sptrsv(l, b[:, j], method="tiles"))
        np.testing.assert_allclose(xm[:, j], xj, rtol=1e-5, atol=1e-6)


def test_sptrsm_trans_and_csc():
    l = datasets.lower_triangular(160, 4, seed=5, dtype=np.float32)
    b = np.random.default_rng(4).standard_normal((160, 6)).astype(np.float32)
    # backsolve L^T X = B
    xt = np.asarray(sptrsm(l, b, trans=True))
    assert rel_err(xt, sptrsm_golden(csr_transpose(l), b, lower=False)) < 2e-4
    # CSC input
    xc = np.asarray(sptrsm(coo_to_csc(l.tocoo()), b))
    assert rel_err(xc, sptrsm_golden(l, b)) < 2e-4


def test_sptrsm_unit_diagonal():
    l = datasets.lower_triangular(120, 4, seed=6, dtype=np.float32,
                                  unit_diagonal=True)
    b = np.random.default_rng(5).standard_normal((120, 2)).astype(np.float32)
    x = np.asarray(sptrsm(l, b, unit_diagonal=True, method="tiles"))
    assert rel_err(x, sptrsm_golden(l, b, unit_diagonal=True)) < 2e-4


def test_sptrsm_rejects_bad_shape():
    l = datasets.lower_triangular(64, 3, seed=7, dtype=np.float32)
    plan = SptrsmPlan(l, method="tiles")
    with pytest.raises(ValueError):
        plan(np.zeros(64, dtype=np.float32))
    with pytest.raises(ValueError):
        plan(np.zeros((32, 4), dtype=np.float32))


def test_sptrsm_apply_pure_jit_composable():
    import jax

    l = datasets.lower_triangular(128, 4, seed=8, dtype=np.float32)
    b = np.random.default_rng(6).standard_normal((128, 4)).astype(np.float32)
    plan = SptrsmPlan(l, method="tiles")
    arrs = plan.device_arrays()
    x = np.asarray(jax.jit(plan.apply_pure)(arrs, b))
    assert rel_err(x, sptrsm_golden(l, b)) < 2e-4
