"""Checks that need the card: compiled kernels and GPU numerics.

Marked ``gpu`` and skipped off a GPU by the ``gpu`` fixture; run on the
card by ``chip_smoke.py`` (or ``JAX_PLATFORMS=cuda pytest -m gpu tests``).
"""

import numpy as np
import pytest

from sblas import datasets
from sblas.formats import csr_transpose
from sblas.golden import rel_err, spmm_golden, sptrsm_golden

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("lower", [True, False])
def test_triton_sptrsv_compiled_matches_tiles(gpu, lower, dtype, k):
    """The kernel as compiled for the card against the tiles route on the
    same schedule, and against the golden."""
    from sblas.ops.sptrsm import SptrsmPlan

    l = datasets.cholesky_factor(datasets.poisson2d_nd(40, dtype=np.float64),
                                 dtype=dtype)
    if not lower:
        l = csr_transpose(l)
    b = np.random.default_rng(k).standard_normal((l.shape[0], k)).astype(
        dtype)
    kern = SptrsmPlan(l, lower=lower, method="triton")
    tiles = SptrsmPlan(l, lower=lower, method="tiles")
    got, ref = np.asarray(kern(b)), np.asarray(tiles(b))
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert rel_err(got, ref) < tol
    assert rel_err(got, sptrsm_golden(l, b.astype(np.float64),
                                      lower=lower)) < 10 * tol


@pytest.mark.parametrize("method", ["ell", "bsr"])
def test_f32_spmm_is_not_tf32(gpu, method):
    """A TF32 product keeps ~3 digits; the routes pin HIGHEST precision,
    so f32 SpMM stays within f32 rounding of the f64 golden."""
    from sblas.ops.spmm import SpmmPlan

    a = datasets.banded(2048, 40, seed=3, dtype=np.float32)
    x = np.random.default_rng(4).standard_normal((2048, 32)).astype(
        np.float32)
    y = np.asarray(SpmmPlan(a, method)(x))
    assert rel_err(y, spmm_golden(a, x.astype(np.float64))) < 1e-5
