"""Halo-exchange distributed SpMV on the virtual CPU mesh."""

import numpy as np
import pytest

from sblas import datasets
from sblas.golden import rel_err, spmv_golden
from sblas.parallel import HaloSpmvPlan, halo_spmv, make_mesh


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8)


def test_halo_poisson(mesh8):
    a = datasets.poisson2d(100, dtype=np.float32)
    x = np.random.default_rng(0).standard_normal(a.shape[0]).astype(
        np.float32)
    p = HaloSpmvPlan(a, mesh8)
    assert p.local_method == "ell"
    # the whole point: collective bytes far below the all_gather plan's
    assert p.collective_bytes_per_chip < (p.n_pad - p.x_chunk) * 4 / 10
    assert rel_err(np.asarray(p(x)), spmv_golden(a, x)) < 1e-5


def test_halo_skewed_rows_bucket_body(mesh8):
    # band-local but with a lognormal row-degree spread: the local body
    # switches to degree buckets, the halo exchange stays the same
    a = datasets.random_csr(8000, 8000, 20, skew=1.5, bandwidth=60, seed=1,
                            dtype=np.float32)
    x = np.random.default_rng(1).standard_normal(8000).astype(np.float32)
    p = HaloSpmvPlan(a, mesh8)
    assert p.local_method == "bucket"
    assert rel_err(np.asarray(p(x)), spmv_golden(a, x)) < 1e-4


def test_halo_refuses_scattered(mesh8):
    g = datasets.emulate("uk-2002", scale=0.003, dtype=np.float32)
    with pytest.raises(ValueError, match="not band-local"):
        HaloSpmvPlan(g, mesh8)


def test_halo_alpha_beta_and_f64(mesh8):
    a = datasets.banded(4000, 6, seed=2, dtype=np.float64)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(4000)
    y0 = rng.standard_normal(4000)
    out = np.asarray(halo_spmv(a, x, mesh8) * 0 +
                     HaloSpmvPlan(a, mesh8)(x, alpha=2.0, beta=-1.0, y=y0))
    assert rel_err(out, spmv_golden(a, x, alpha=2.0, beta=-1.0, y=y0)) < 1e-12


def test_halo_edge_chips_no_wraparound(mesh8):
    """First/last chips' halo slabs wrap the ring; their values must never
    be read (cols beyond the matrix edge don't exist)."""
    a = datasets.banded(801, 5, seed=3, dtype=np.float32)  # n % chips != 0
    x = np.random.default_rng(3).standard_normal(801).astype(np.float32)
    p = HaloSpmvPlan(a, mesh8)
    assert rel_err(np.asarray(p(x)), spmv_golden(a, x)) < 1e-5


def test_halo_spmm(mesh8):
    from sblas.parallel import HaloSpmmPlan

    a = datasets.poisson2d(80, dtype=np.float32)
    x = np.random.default_rng(4).standard_normal((a.shape[0], 8)).astype(
        np.float32)
    p = HaloSpmmPlan(a, mesh8)
    got = np.asarray(p(x))
    assert got.shape == (a.shape[0], 8)
    assert rel_err(got, spmv_golden(a, x)) < 1e-5


def test_halo_spmm_refuses_scattered(mesh8):
    from sblas.parallel import HaloSpmmPlan

    g = datasets.emulate("uk-2002", scale=0.003, dtype=np.float32)
    with pytest.raises(ValueError, match="not band-local"):
        HaloSpmmPlan(g, mesh8)
