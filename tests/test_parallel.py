"""Multi-chip paths on the 8-virtual-device CPU mesh (SURVEY.md §4)."""

import jax
import numpy as np
import pytest

from sblas import datasets
from sblas.golden import spmv_golden, spmm_golden, sptrsv_golden, rel_err
from sblas.parallel import (
    make_mesh, DistSpmvPlan, DistSpmmPlan, DistSptrsvPlan,
)


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "conftest should provide 8 CPU devices"
    return make_mesh(8)


@pytest.mark.parametrize("strategy", ["even_rows", "nnz_balanced", "nnz_split"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dist_spmv(mesh8, strategy, dtype):
    a = datasets.random_csr(500, 500, 8, skew=0.7, seed=1, dtype=dtype)
    x = np.random.default_rng(2).standard_normal(500).astype(dtype)
    plan = DistSpmvPlan(a, mesh8, strategy=strategy)
    y = np.asarray(plan(x))
    tol = 1e-10 if dtype == np.float64 else 5e-5
    assert rel_err(y, spmv_golden(a, x)) < tol


def test_dist_spmv_rectangular(mesh8):
    a = datasets.random_csr(300, 500, 5, seed=3, dtype=np.float64)
    x = np.random.default_rng(4).standard_normal(500)
    y = np.asarray(DistSpmvPlan(a, mesh8)(x))
    assert rel_err(y, spmv_golden(a, x)) < 1e-10


def test_dist_spmv_alpha_beta(mesh8):
    a = datasets.random_csr(200, 200, 6, seed=5, dtype=np.float64)
    rng = np.random.default_rng(6)
    x, y0 = rng.standard_normal(200), rng.standard_normal(200)
    out = np.asarray(DistSpmvPlan(a, mesh8)(x, alpha=2.0, beta=-1.0, y=y0))
    assert rel_err(out, spmv_golden(a, x, 2.0, -1.0, y0)) < 1e-10


@pytest.mark.parametrize("k", [8, 32])
def test_dist_spmm(mesh8, k):
    a = datasets.random_csr(400, 350, 7, seed=7, dtype=np.float64)
    x = np.random.default_rng(8).standard_normal((350, k))
    y = np.asarray(DistSpmmPlan(a, mesh8)(x))
    assert rel_err(y, spmm_golden(a, x)) < 1e-10


@pytest.mark.parametrize("gen", ["band", "random"])
def test_dist_sptrsv(mesh8, gen):
    if gen == "band":
        l = datasets.lower_triangular(300, 4, bandwidth=9, seed=9, dtype=np.float64)
    else:
        l = datasets.lower_triangular(300, 5, seed=10, dtype=np.float64)
    b = np.random.default_rng(11).standard_normal(300)
    x = np.asarray(DistSptrsvPlan(l, mesh8)(b))
    assert rel_err(x, sptrsv_golden(l, b)) < 1e-10


def test_dist_matches_single_chip(mesh8):
    from sblas.ops.spmv import SpmvPlan

    a = datasets.random_csr(256, 256, 8, seed=12, dtype=np.float64)
    x = np.random.default_rng(13).standard_normal(256)
    y_single = np.asarray(SpmvPlan(a, "ell")(x))
    y_multi = np.asarray(DistSpmvPlan(a, mesh8)(x))
    assert rel_err(y_multi, y_single) < 1e-12


def test_ring_spmv(mesh8):
    from sblas.parallel import RingSpmvPlan

    a = datasets.random_csr(400, 400, 8, seed=20, dtype=np.float64)
    x = np.random.default_rng(21).standard_normal(400)
    y = np.asarray(RingSpmvPlan(a, mesh8)(x))
    assert rel_err(y, spmv_golden(a, x)) < 1e-10


def test_ring_matches_allgather(mesh8):
    from sblas.parallel import RingSpmvPlan, DistSpmvPlan

    a = datasets.random_csr(256, 256, 6, bandwidth=40, seed=22,
                            dtype=np.float32)
    x = np.random.default_rng(23).standard_normal(256).astype(np.float32)
    y_ring = np.asarray(RingSpmvPlan(a, mesh8)(x))
    y_ag = np.asarray(DistSpmvPlan(a, mesh8)(x))
    assert rel_err(y_ring, y_ag) < 1e-5


@pytest.mark.parametrize("strategy", ["nnz_balanced", "nnz_split"])
def test_dist_spmv_bucket_body(mesh8, strategy):
    # power-law rows: every device runs degree buckets with a scatter-add
    # merge of its slots (plus a psum under nnz_split)
    g = datasets.emulate("uk-2002", scale=0.005, dtype=np.float32)
    x = np.random.default_rng(30).standard_normal(g.shape[1]).astype(np.float32)
    p = DistSpmvPlan(g, mesh8, strategy=strategy)
    assert p.local_method == "bucket"
    y = np.asarray(p(x))
    assert rel_err(y, spmv_golden(g, x)) < 1e-5


def test_dist_spmm_bucket_body(mesh8):
    from sblas.parallel.spmm_dist import DistSpmmPlan

    g = datasets.emulate("uk-2002", scale=0.004, dtype=np.float32)
    x = np.random.default_rng(31).standard_normal((g.shape[1], 8)).astype(np.float32)
    p = DistSpmmPlan(g, mesh8)
    assert p.local_method == "bucket"
    y = np.asarray(p(x))
    assert rel_err(y, spmm_golden(g, x)) < 1e-5


def test_dist_spmm_ell_body_any_k(mesh8):
    # regular FEM rows: one ELL slab per device serves any k
    from sblas.parallel.spmm_dist import DistSpmmPlan

    a = datasets.emulate("cant", scale=0.05, dtype=np.float32)
    p = DistSpmmPlan(a, mesh8)
    assert p.local_method == "ell"
    for k in (8, 5):
        x = np.random.default_rng(40 + k).standard_normal(
            (a.shape[1], k)).astype(np.float32)
        y = np.asarray(p(x))
        assert rel_err(y, spmm_golden(a, x)) < 1e-5


def test_dist_auto_falls_back_on_f64(mesh8):
    a = datasets.random_csr(256, 256, 8, seed=32, dtype=np.float64)
    p = DistSpmvPlan(a, mesh8)
    assert p.local_method == "ell"


def test_dist_sptrsv_batching_reduces_collectives(mesh8):
    # Level batching must fuse chains into few exchanges and the shrunk
    # all_gather must move far fewer bytes than one length-n psum per level
    # (SURVEY.md hard-part 4).
    a = datasets.spd_diag_dominant(200, 5, bandwidth=12, seed=4,
                                   dtype=np.float64)
    l = datasets.cholesky_factor(a, dtype=np.float64)
    b = np.random.default_rng(40).standard_normal(l.shape[0])
    p = DistSptrsvPlan(l, mesh8)
    x = np.asarray(p(b))
    assert rel_err(x, sptrsv_golden(l, b)) < 1e-10
    assert p.nbatches < p.nlevels / 4
    old_bytes = p.nlevels * (l.shape[0] + 2) * 8
    assert p.collective_bytes < old_bytes / 2


def test_dist_sptrsv_upper(mesh8):
    from sblas.formats import csr_transpose

    lo = datasets.lower_triangular(250, 5, seed=41, dtype=np.float64)
    u = csr_transpose(lo)
    b = np.random.default_rng(42).standard_normal(250)
    x = np.asarray(DistSptrsvPlan(u, mesh8, lower=False)(b))
    assert rel_err(x, sptrsv_golden(u, b, lower=False)) < 1e-10


def _heavy_rows_matrix(m=6000, heavy=6000, seed=60):
    """Regular rows plus two rows longer than the bucket width cap (2048),
    which split across several slots of one device."""
    from sblas.formats import COO, coo_to_csr

    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.repeat(np.arange(m), 6),
                           np.full(heavy, 7), np.full(heavy, m - 3)])
    cols = rng.integers(0, m, len(rows))
    return coo_to_csr(COO((m, m), rows, cols, rng.standard_normal(
        len(rows)).astype(np.float32))).astype(np.float32)


@pytest.mark.parametrize("strategy", ["nnz_balanced", "nnz_split"])
def test_dist_spmv_heavy_rows(mesh8, strategy):
    a = _heavy_rows_matrix()
    assert a.row_lengths.max() > 2048
    x = np.random.default_rng(61).standard_normal(a.shape[1]).astype(np.float32)
    p = DistSpmvPlan(a, mesh8, strategy=strategy)
    assert p.local_method == "bucket"
    assert rel_err(np.asarray(p(x)), spmv_golden(a, x)) < 1e-5


def test_dist_spmm_heavy_rows(mesh8):
    from sblas.parallel.spmm_dist import DistSpmmPlan

    a = _heavy_rows_matrix()
    x = np.random.default_rng(70).standard_normal((a.shape[1], 8)).astype(np.float32)
    y = np.asarray(DistSpmmPlan(a, mesh8, strategy="nnz_split")(x))
    assert rel_err(y, spmm_golden(a, x)) < 1e-5


@pytest.mark.parametrize("local_method,matrix", [
    ("ell", "cant"), ("bucket", "uk-2002"),
])
def test_dist_spmm_nnz_split(mesh8, local_method, matrix):
    # nnz_split for DistSpmmPlan under each local body the matrix selects
    from sblas.parallel.spmm_dist import DistSpmmPlan

    a = datasets.emulate(matrix, scale=0.05 if matrix == "cant" else 0.004,
                         dtype=np.float32)
    p = DistSpmmPlan(a, mesh8, strategy="nnz_split")
    assert p.local_method == local_method
    for k in (8, 3):
        x = np.random.default_rng(80 + k).standard_normal(
            (a.shape[1], k)).astype(np.float32)
        y = np.asarray(p(x))
        assert rel_err(y, spmm_golden(a, x)) < 1e-5, (local_method, k)


def test_dist_sptrsv_segment_tail_no_clamp(mesh8):
    """Regression: a segment's last batch used to dynamic-slice past the
    slot map's end; XLA clamps the start, scattering the exchange onto the
    previous batch's rows (0.24 rel-err on exactly this instance)."""
    l = datasets.lower_triangular(600, 5, seed=1, dtype=np.float32)
    b = np.random.default_rng(0).standard_normal(600).astype(np.float32)
    x = np.asarray(DistSptrsvPlan(l, mesh8)(b))
    assert rel_err(x, sptrsv_golden(l, b)) < 1e-4


def test_dist_sptrsm(mesh8):
    from sblas.parallel import DistSptrsmPlan
    from sblas.golden import sptrsm_golden

    l = datasets.lower_triangular(500, 5, seed=3, dtype=np.float32)
    b = np.random.default_rng(1).standard_normal((500, 6)).astype(np.float32)
    plan = DistSptrsmPlan(l, mesh8)
    x = np.asarray(plan(b))
    assert x.shape == (500, 6)
    assert rel_err(x, sptrsm_golden(l, b)) < 1e-4
    # per-column agreement with the 1-RHS dist solve
    x0 = np.asarray(DistSptrsvPlan(l, mesh8)(b[:, 0]))
    np.testing.assert_allclose(x[:, 0], x0, rtol=1e-5, atol=1e-6)


def test_bench_dist_spmv_bucket_local(mesh8):
    """bench_dist_spmv on a plan whose local body is degree buckets."""
    from sblas.bench_lib import bench_dist_spmv

    g = datasets.emulate("uk-2002", scale=0.005, dtype=np.float32)
    rec = bench_dist_spmv(g, mesh8, iters=2)
    assert rec.extra["local_method"] == "bucket"
    assert rec.extra["rel_err"] < 1e-4
    assert rec.as_dict()["device"]["platform"] == "cpu"


def test_dist_trailing_empty_rows(mesh8):
    """Regression: per-shard outputs must cover every shard row, including
    shards whose rows are all empty."""
    from sblas.formats import COO, coo_to_csr

    rng = np.random.default_rng(30)
    m = 2600                       # shards of 325 rows; some nearly empty
    rows = rng.integers(0, 900, 9000)
    cols = rng.integers(0, m, 9000)
    a = coo_to_csr(COO((m, m), rows, cols,
                       rng.standard_normal(9000).astype(np.float32)))
    x = rng.standard_normal(m).astype(np.float32)
    for strategy in ("nnz_balanced", "nnz_split"):
        p = DistSpmvPlan(a.astype(np.float32), mesh8, strategy=strategy)
        y = np.asarray(p(x))
        assert np.all(y[900:] == 0.0)
        assert rel_err(y, spmv_golden(a, x)) < 1e-4
