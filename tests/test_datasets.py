import numpy as np
import pytest

from sblas import datasets
from sblas.formats import has_full_diagonal


def test_random_csr_shape_and_canonical():
    a = datasets.random_csr(100, 80, 5, seed=1)
    assert a.shape == (100, 80)
    # canonical: sorted unique columns per row
    for i in range(100):
        cols = a.indices[a.indptr[i]:a.indptr[i + 1]]
        assert np.all(np.diff(cols) > 0)


def test_random_csr_bandwidth():
    a = datasets.random_csr(200, 200, 8, bandwidth=10, seed=2)
    coo = a.tocoo()
    assert np.max(np.abs(coo.row.astype(int) - coo.col.astype(int))) <= 10


def test_banded():
    a = datasets.banded(50, 3)
    coo = a.tocoo()
    assert np.max(np.abs(coo.row.astype(int) - coo.col.astype(int))) <= 3
    assert a.nnz == 50 * 7 - 2 * (1 + 2 + 3)


def test_poisson2d_spd():
    a = datasets.poisson2d(8)
    dense = a.todense()
    np.testing.assert_allclose(dense, dense.T)
    w = np.linalg.eigvalsh(dense.astype(np.float64))
    assert w.min() > 0


def test_lower_triangular_solvable():
    l = datasets.lower_triangular(64, 6, seed=3, dtype=np.float64)
    dense = l.todense()
    assert np.allclose(np.triu(dense, k=1), 0)
    assert has_full_diagonal(l)
    # diagonally dominant -> well conditioned solve
    x = np.linalg.solve(dense, np.ones(64))
    assert np.all(np.isfinite(x))


def test_cholesky_factor_is_triangular():
    a = datasets.spd_diag_dominant(128, 6, bandwidth=16, seed=4, dtype=np.float64)
    l = datasets.cholesky_factor(a, dtype=np.float64)
    dense = l.todense()
    assert np.allclose(np.triu(dense, k=1), 0)
    assert has_full_diagonal(l)
    # L @ L.T should reconstruct A reasonably well
    rec = dense @ dense.T
    np.testing.assert_allclose(rec, a.todense(), rtol=1e-6, atol=1e-6)


def test_powerlaw_skew():
    a = datasets.powerlaw_graph(2000, avg_deg=8, seed=5)
    deg = a.row_lengths
    assert deg.max() > 4 * deg.mean()  # heavy tail exists


def test_emulate_stats():
    a = datasets.emulate("cant", scale=0.05)
    spec = datasets.SUITE["cant"]
    avg_target = spec.nnz / spec.n
    avg = a.nnz / a.shape[0]
    assert 0.5 * avg_target < avg < 2.0 * avg_target


def test_load_unknown():
    with pytest.raises(FileNotFoundError):
        datasets.load("no-such-matrix")
