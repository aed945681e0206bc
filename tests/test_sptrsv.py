import numpy as np
import pytest

from sblas import datasets
from sblas.golden import sptrsv_golden, rel_err
from sblas.ops.sptrsv import SptrsvPlan
from sblas.sptrsv_schedule import build_level_schedule, validate_schedule
from sblas.formats import tril, csr_transpose
from sblas import native


def test_level_schedule_simple():
    # bidiagonal: level[i] = i (fully serial)
    l = datasets.banded(10, 1, seed=0, dtype=np.float64)
    l = tril(l)
    sched = build_level_schedule(l)
    np.testing.assert_array_equal(sched.levels, np.arange(10))
    assert sched.nlevels == 10
    validate_schedule(sched)


def test_level_schedule_diagonal():
    # diagonal matrix: all rows level 0
    from sblas.formats import COO, coo_to_csr

    n = 16
    l = coo_to_csr(COO((n, n), np.arange(n), np.arange(n), np.ones(n)))
    sched = build_level_schedule(l)
    assert sched.nlevels == 1
    validate_schedule(sched)


def test_native_matches_numpy_levels():
    l = tril(datasets.random_csr(300, 300, 6, seed=1, dtype=np.float64))
    lv_np, nl_np = native._level_schedule_numpy(l.indptr, l.indices, 300, lower=True)
    if native.have_native():
        lv_c, nl_c = native.level_schedule(l.indptr, l.indices, 300, lower=True)
        np.testing.assert_array_equal(lv_c, lv_np)
        assert nl_c == nl_np


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("gen", ["band", "random", "chol"])
def test_sptrsv_vs_golden(dtype, gen):
    if gen == "band":
        l = datasets.lower_triangular(200, 4, bandwidth=8, seed=2, dtype=dtype)
    elif gen == "random":
        l = datasets.lower_triangular(300, 6, seed=3, dtype=dtype)
    else:
        a = datasets.spd_diag_dominant(150, 5, bandwidth=12, seed=4, dtype=np.float64)
        l = datasets.cholesky_factor(a, dtype=dtype)
    b = np.random.default_rng(5).standard_normal(l.shape[0]).astype(dtype)
    x = np.asarray(SptrsvPlan(l)(b))
    ref = sptrsv_golden(l, b)
    tol = 1e-10 if dtype == np.float64 else 2e-4
    assert rel_err(x, ref) < tol


def test_sptrsv_unit_diagonal():
    l = datasets.lower_triangular(100, 5, seed=6, dtype=np.float64,
                                  unit_diagonal=True)
    b = np.random.default_rng(7).standard_normal(100)
    x = np.asarray(SptrsvPlan(l, unit_diagonal=True)(b))
    ref = sptrsv_golden(l, b, unit_diagonal=True)
    assert rel_err(x, ref) < 1e-10


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sptrsv_upper(dtype):
    lo = datasets.lower_triangular(150, 5, seed=8, dtype=dtype)
    u = csr_transpose(lo)
    b = np.random.default_rng(9).standard_normal(150).astype(dtype)
    x = np.asarray(SptrsvPlan(u, lower=False)(b))
    ref = sptrsv_golden(u, b, lower=False)
    tol = 1e-10 if dtype == np.float64 else 2e-4
    assert rel_err(x, ref) < tol


def test_sptrsv_missing_diag_raises():
    from sblas.formats import COO, coo_to_csr

    l = coo_to_csr(COO((3, 3), [1, 2], [0, 1], [1.0, 1.0]))
    with pytest.raises(ValueError):
        SptrsvPlan(l)


def test_sptrsv_tile_sizes():
    l = datasets.lower_triangular(256, 6, seed=10, dtype=np.float64)
    b = np.random.default_rng(11).standard_normal(256)
    ref = sptrsv_golden(l, b)
    for tr in (8, 32, 128):
        x = np.asarray(SptrsvPlan(l, tile_rows=tr, validate=True)(b))
        assert rel_err(x, ref) < 1e-10


def test_native_golden_matches_scipy():
    if not native.have_native():
        pytest.skip("no native lib")
    l = datasets.lower_triangular(200, 5, seed=12, dtype=np.float64)
    b = np.random.default_rng(13).standard_normal(200)
    x = native.sptrsv_golden_native(l.indptr, l.indices, l.data, b)
    ref = sptrsv_golden(l, b)
    assert rel_err(x, ref) < 1e-12
