import numpy as np
import pytest

from sblas import datasets
from sblas.golden import spmv_golden, rel_err, default_tol
from sblas.ops.spmv import SpmvPlan


MATRICES = {
    "banded": lambda dt: datasets.banded(300, 5, seed=1, dtype=dt),
    "random": lambda dt: datasets.random_csr(257, 301, 9, seed=2, dtype=dt),
    "skewed": lambda dt: datasets.random_csr(400, 400, 12, skew=1.2, seed=3, dtype=dt),
    "empty_rows": lambda dt: datasets.random_csr(100, 90, 2, seed=4, dtype=dt),
    "poisson": lambda dt: datasets.poisson2d(17, dtype=dt),
}


@pytest.mark.parametrize("method", ["coo", "ell", "bucket"])
@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmv_methods_vs_golden(method, name, dtype):
    a = MATRICES[name](dtype)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(a.shape[1]).astype(dtype)
    plan = SpmvPlan(a, method)
    y = np.asarray(plan(x))
    ref = spmv_golden(a, x)
    assert rel_err(y, ref) < default_tol(dtype), f"{method}/{name}"


@pytest.mark.parametrize("method", ["coo", "ell", "bucket"])
def test_spmv_alpha_beta(method):
    a = datasets.random_csr(64, 64, 6, seed=5, dtype=np.float64)
    rng = np.random.default_rng(8)
    x = rng.standard_normal(64)
    y0 = rng.standard_normal(64)
    plan = SpmvPlan(a, method)
    out = np.asarray(plan(x, alpha=2.5, beta=-0.5, y=y0))
    ref = spmv_golden(a, x, alpha=2.5, beta=-0.5, y=y0)
    assert rel_err(out, ref) < 1e-11


def test_spmv_beta_requires_y():
    a = datasets.random_csr(8, 8, 2, seed=0)
    with pytest.raises(ValueError):
        SpmvPlan(a, "coo")(np.ones(8, np.float32), beta=1.0)


def test_spmv_shape_check():
    a = datasets.random_csr(8, 10, 2, seed=0)
    with pytest.raises(ValueError):
        SpmvPlan(a, "coo")(np.ones(9, np.float32))


def test_spmv_heavy_row_split():
    # one row with 600 nnz, max_width forces splitting across bucket slots
    rng = np.random.default_rng(11)
    rows = np.concatenate([np.zeros(600, np.int64),
                           rng.integers(1, 200, 400)])
    cols = rng.integers(0, 200, 1000)
    vals = rng.standard_normal(1000)
    from sblas.formats import COO, coo_to_csr
    a = coo_to_csr(COO((200, 200), rows, cols, vals))
    x = rng.standard_normal(200)
    plan = SpmvPlan(a, "bucket", max_width=128)
    y = np.asarray(plan(x))
    assert rel_err(y, spmv_golden(a, x)) < 1e-11


def test_spmv_toplevel_cache():
    import sblas

    a = datasets.random_csr(32, 32, 4, seed=6)
    x = np.ones(32, np.float32)
    y1 = sblas.spmv(a, x, method="coo")
    y2 = sblas.spmv(a, x, method="coo")
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2))


def test_spmv_rectangular_wide_and_tall():
    for (m, n) in [(50, 300), (300, 50)]:
        a = datasets.random_csr(m, n, 4, seed=9, dtype=np.float64)
        x = np.random.default_rng(1).standard_normal(n)
        for method in ("coo", "ell", "bucket"):
            y = np.asarray(SpmvPlan(a, method)(x))
            assert rel_err(y, spmv_golden(a, x)) < 1e-11


def test_spmv_bsr_method():
    a = datasets.random_csr(300, 280, 10, bandwidth=50, seed=21, dtype=np.float32)
    x = np.random.default_rng(22).standard_normal(280).astype(np.float32)
    y = np.asarray(SpmvPlan(a, "bsr")(x))
    assert rel_err(y, spmv_golden(a, x)) < 2e-5


def test_spmv_bsr_f64():
    a = datasets.poisson2d(20, dtype=np.float64)
    x = np.random.default_rng(23).standard_normal(a.shape[1])
    y = np.asarray(SpmvPlan(a, "bsr")(x))
    assert rel_err(y, spmv_golden(a, x)) < 1e-11


# one matrix per class the routes are chosen for: FEM (regular rows near
# the diagonal), graph (power-law rows, scattered columns), band
CLASSES = {
    "fem": lambda dt: datasets.emulate("cant", scale=0.005, dtype=dt),
    "graph": lambda dt: datasets.emulate("uk-2002", scale=0.0002, dtype=dt),
    "band": lambda dt: datasets.banded(400, 20, seed=8, dtype=dt),
}


@pytest.mark.parametrize("ab", [(1.0, 0.0), (-1.5, 0.75)])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("matrix", list(CLASSES))
@pytest.mark.parametrize("method", ["coo", "ell", "bucket", "bsr"])
def test_spmv_routes_vs_scipy(method, matrix, dtype, trans, ab):
    """Every XLA route through the public entry point, against scipy."""
    import sblas

    a = CLASSES[matrix](dtype)
    alpha, beta = ab
    m, n = (a.shape[1], a.shape[0]) if trans else a.shape
    rng = np.random.default_rng(9)
    x = rng.standard_normal(n).astype(dtype)
    y0 = rng.standard_normal(m).astype(dtype)
    got = np.asarray(sblas.spmv(a, x, alpha, beta, y0 if beta else None,
                                trans=trans, method=method))
    at = a.to_scipy().T.tocsr() if trans else a.to_scipy()
    want = alpha * (at @ x.astype(np.float64)) + beta * y0
    assert got.dtype == dtype
    assert rel_err(got, want) < default_tol(dtype), (method, matrix)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("matrix,route", [("fem", "ell"), ("band", "ell"),
                                          ("graph", "bucket")])
def test_spmv_auto_route_by_platform(monkeypatch, platform, matrix, route):
    """Route choice reads the matrix, never the platform: the same XLA
    route on a GPU as on the CPU."""
    import sblas.utils.backend as be

    monkeypatch.setattr(be, "platform", lambda: platform)
    a = CLASSES[matrix](np.float32)
    assert SpmvPlan(a, "auto").method == route


def test_spmv_pick_layout_rule():
    from sblas.ops.spmv import pick_layout

    assert pick_layout(np.array([5, 5, 6, 4])) == "ell"
    assert pick_layout(np.array([1, 1, 1, 8])) == "ell"   # fits 8 wide
    assert pick_layout(np.array([1] * 20 + [30])) == "bucket"
    assert pick_layout(np.array([1] * 20 + [9])) == "bucket"
    assert pick_layout(np.zeros(0, np.int32)) == "ell"


def test_spmv_unknown_method_rejected():
    a = datasets.random_csr(8, 8, 2, seed=0)
    for bad in ("pallas", "pseg", "rcm", "pallas_ds"):
        with pytest.raises(ValueError, match="unknown spmv method"):
            SpmvPlan(a, bad)


def test_spmv_trailing_empty_rows():
    """Rows after the last nonempty block must come out exactly zero on
    every route (the bucket scatter and the ELL slice both end at m)."""
    from sblas.formats import COO, coo_to_csr

    rng = np.random.default_rng(0)
    m, n = 1500, 800
    rows = rng.integers(0, 1024, 30000)       # rows >= 1024 all empty
    cols = rng.integers(0, n, 30000)
    a = coo_to_csr(COO((m, n), rows, cols,
                       rng.standard_normal(30000).astype(np.float32)))
    x = rng.standard_normal(n).astype(np.float32)
    for method in ("coo", "ell", "bucket", "bsr"):
        y = np.asarray(SpmvPlan(a, method)(x))
        assert np.all(y[1024:] == 0.0), method
        assert rel_err(y, spmv_golden(a, x)) < 1e-5, method


@pytest.mark.parametrize("method", ["coo", "ell", "bucket", "bsr"])
def test_spmv_plan_call_inside_jit(method):
    """A plan's __call__ and apply_pure both trace inside jit."""
    import jax

    a = datasets.emulate("uk-2002", scale=0.0002, dtype=np.float32)
    plan = SpmvPlan(a, method)
    x = np.random.default_rng(23).standard_normal(a.shape[1]).astype(
        np.float32)
    want = spmv_golden(a, x)
    assert rel_err(np.asarray(jax.jit(lambda v: plan(v))(x)), want) < 1e-5
    y = jax.jit(plan.apply_pure)(plan.device_arrays(), x)
    assert rel_err(np.asarray(y), want) < 1e-5
