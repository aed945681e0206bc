"""The C++ host helpers against their numpy references."""

import numpy as np
import pytest

from sblas import datasets, native
from sblas.formats import csr_transpose, tril


@pytest.fixture
def lib():
    if not native.have_native():
        pytest.skip("no native toolchain")


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("gen", ["random", "band", "chol-nd"])
def test_native_level_schedule_matches_numpy(lib, gen, lower):
    if gen == "random":
        l = tril(datasets.random_csr(400, 400, 7, seed=1, dtype=np.float64))
    elif gen == "band":
        l = datasets.lower_triangular(500, 6, bandwidth=30, seed=2,
                                      dtype=np.float64)
    else:
        l = datasets.cholesky_factor(datasets.poisson2d_nd(20,
                                                           dtype=np.float64))
    if not lower:
        l = csr_transpose(l)
    n = l.shape[0]
    lv_c, nl_c = native.level_schedule(l.indptr, l.indices, n, lower=lower)
    lv_np, nl_np = native._level_schedule_numpy(l.indptr, l.indices, n,
                                                lower=lower)
    np.testing.assert_array_equal(lv_c, lv_np)
    assert nl_c == nl_np


@pytest.mark.parametrize("n", [12, 30])
def test_native_ic0_matches_numpy(lib, n):
    from sblas.solvers import _ic0_numpy

    lo = tril(datasets.poisson2d(n, dtype=np.float64))
    v_c = lo.data.astype(np.float64).copy()
    v_np = v_c.copy()
    assert native.ic0_inplace(lo.indptr, lo.indices, v_c) == 0
    assert _ic0_numpy(lo.indptr, lo.indices, v_np) == 0
    np.testing.assert_allclose(v_c, v_np, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_native_ilu0_matches_numpy(lib, seed):
    from sblas.solvers import _ilu0_numpy

    a = datasets.spd_diag_dominant(300, 7, bandwidth=25, seed=seed,
                                   dtype=np.float64)
    v_c = a.data.astype(np.float64).copy()
    v_np = v_c.copy()
    assert native.ilu0_inplace(a.indptr, a.indices, v_c) == 0
    assert _ilu0_numpy(a.indptr, a.indices, v_np) == 0
    np.testing.assert_allclose(v_c, v_np, rtol=1e-12, atol=1e-12)
