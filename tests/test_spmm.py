import numpy as np
import pytest

from sblas import datasets
from sblas.golden import spmm_golden, rel_err, default_tol
from sblas.ops.spmm import SpmmPlan


@pytest.mark.parametrize("method", ["ell", "bucket"])
@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmm_vs_golden(method, k, dtype):
    a = datasets.random_csr(200, 150, 7, seed=1, dtype=dtype)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((150, k)).astype(dtype)
    y = np.asarray(SpmmPlan(a, method)(x))
    ref = spmm_golden(a, x)
    assert rel_err(y, ref) < default_tol(dtype)


@pytest.mark.parametrize("method", ["ell", "bucket"])
def test_spmm_alpha_beta(method):
    a = datasets.random_csr(64, 64, 5, seed=3, dtype=np.float64)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 8))
    y0 = rng.standard_normal((64, 8))
    out = np.asarray(SpmmPlan(a, method)(x, alpha=1.5, beta=2.0, y=y0))
    ref = spmm_golden(a, x, alpha=1.5, beta=2.0, y=y0)
    assert rel_err(out, ref) < 1e-11


def test_spmm_skewed_chunking():
    # skewed rows + small intermediate to force multi-chunk lax.map
    a = datasets.random_csr(500, 500, 10, skew=1.0, seed=5, dtype=np.float32)
    x = np.random.default_rng(6).standard_normal((500, 32)).astype(np.float32)
    plan = SpmmPlan(a, "bucket", intermediate_mb=1)
    y = np.asarray(plan(x))
    assert rel_err(y, spmm_golden(a, x)) < 2e-5


def test_spmm_shape_check():
    a = datasets.random_csr(8, 10, 2, seed=0)
    with pytest.raises(ValueError):
        SpmmPlan(a, "ell")(np.ones((11, 4), np.float32))


@pytest.mark.parametrize("k", [8, 32])
def test_spmm_bsr(k):
    a = datasets.random_csr(300, 260, 12, bandwidth=60, seed=31, dtype=np.float64)
    x = np.random.default_rng(32).standard_normal((260, k))
    y = np.asarray(SpmmPlan(a, "bsr")(x))
    assert rel_err(y, spmm_golden(a, x)) < 1e-11


def test_spmm_auto_picks_bsr_for_block_dense():
    # truly block-dense: narrow band so 128x128 diagonal blocks are >15% full
    a = datasets.banded(512, 40, seed=33, dtype=np.float32)
    from sblas.retile_bsr import bsr_stats
    assert bsr_stats(a)["density"] > 0.15
    plan = SpmmPlan(a, "auto")
    assert plan.method == "bsr"


def test_spmm_bucket_apply_pure():
    # bucket device_arrays/apply_pure used to raise NotImplementedError,
    # crashing bench_spmm on skew-selected matrices
    import jax

    a = datasets.random_csr(500, 500, 10, skew=1.0, seed=7, dtype=np.float32)
    x = np.random.default_rng(8).standard_normal((500, 8)).astype(np.float32)
    plan = SpmmPlan(a, "bucket")
    y = np.asarray(jax.jit(plan.apply_pure)(plan.device_arrays(), x))
    assert rel_err(y, spmm_golden(a, x)) < 2e-5


CLASSES = {
    "fem": lambda dt: datasets.emulate("cant", scale=0.005, dtype=dt),
    "graph": lambda dt: datasets.emulate("uk-2002", scale=0.0002, dtype=dt),
    "band": lambda dt: datasets.banded(400, 20, seed=8, dtype=dt),
}
METHODS = ["ell", "bucket", "bsr", "spmv_passes"]


@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("matrix", list(CLASSES))
@pytest.mark.parametrize("method", METHODS)
def test_spmm_routes_vs_scipy(method, matrix, dtype, k):
    """Every XLA route through the public entry point, against scipy."""
    import sblas

    a = CLASSES[matrix](dtype)
    x = np.random.default_rng(k).standard_normal((a.shape[1], k)).astype(
        dtype)
    got = np.asarray(sblas.spmm(a, x, method=method))
    assert got.dtype == dtype and got.shape == (a.shape[0], k)
    assert rel_err(got, spmm_golden(a, x.astype(np.float64))) < \
        default_tol(dtype), (method, matrix, k)


@pytest.mark.parametrize("ab", [(1.0, 0.0), (2.0, -0.5)])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_spmm_trans_alpha_beta(method, trans, ab):
    import sblas

    a = datasets.random_csr(180, 140, 7, seed=12, dtype=np.float64)
    alpha, beta = ab
    m, n = (140, 180) if trans else (180, 140)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((n, 8))
    y0 = rng.standard_normal((m, 8))
    got = np.asarray(sblas.spmm(a, x, alpha, beta, y0 if beta else None,
                                trans=trans, method=method))
    at = a.to_scipy().T.tocsr() if trans else a.to_scipy()
    assert rel_err(got, alpha * (at @ x) + beta * y0) < 1e-11


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("matrix,route", [("dense-band", "bsr"),
                                          ("graph", "bucket")])
def test_spmm_auto_route_by_platform(monkeypatch, platform, matrix, route):
    """Route choice reads the matrix: dense blocks for a band that fills
    its 128x128 blocks, degree buckets for a power-law graph, on either
    platform."""
    import sblas.utils.backend as be

    monkeypatch.setattr(be, "platform", lambda: platform)
    a = (datasets.banded(512, 40, seed=33, dtype=np.float32)
         if matrix == "dense-band" else CLASSES[matrix](np.float32))
    assert SpmmPlan(a, "auto").method == route


def test_spmm_auto_bsr_respects_device_memory(monkeypatch):
    """The dense-block route is taken only if its blocks fit a quarter of
    the device's memory, as the device reports it."""
    import sblas.utils.backend as be

    a = datasets.banded(512, 40, seed=33, dtype=np.float32)
    monkeypatch.setattr(be, "device_bytes_limit", lambda: 1 << 40)
    assert SpmmPlan(a, "auto").method == "bsr"
    monkeypatch.setattr(be, "device_bytes_limit", lambda: 1 << 20)
    assert SpmmPlan(a, "auto").method == "ell"


def test_spmm_intermediate_budget_from_device(monkeypatch):
    """The gather chunk budget is a sixteenth of the device's memory."""
    import sblas.utils.backend as be

    a = datasets.random_csr(64, 64, 4, seed=2, dtype=np.float32)
    monkeypatch.setattr(be, "device_bytes_limit", lambda: 64 << 30)
    assert SpmmPlan(a, "ell")._intermediate == 4 << 30
    monkeypatch.setattr(be, "device_bytes_limit", lambda: None)
    assert SpmmPlan(a, "ell")._intermediate == 256 << 20
    assert SpmmPlan(a, "ell", intermediate_mb=1)._intermediate == 1 << 20


def test_spmm_unknown_method_rejected():
    a = datasets.random_csr(8, 8, 2, seed=0)
    for bad in ("pallas", "pseg", "bsr_pallas", "bsr_pallas_t", "pallas_ds"):
        with pytest.raises(ValueError, match="unknown spmm method"):
            SpmmPlan(a, bad)


def _dot_precisions(fn, *args):
    import jax

    text = jax.jit(fn).lower(*args).as_text()
    return [line for line in text.splitlines() if "dot_general" in line]


@pytest.mark.parametrize("method", ["ell", "bucket", "bsr"])
def test_f32_contractions_run_at_highest_precision(method):
    """A float32 dot may run in TF32 on a GPU unless asked otherwise:
    every contraction of the K-wide routes carries precision HIGHEST in
    the lowered program."""
    a = datasets.random_csr(300, 300, 9, skew=1.2, bandwidth=40, seed=4,
                            dtype=np.float32)
    x = np.ones((300, 8), np.float32)
    plan = SpmmPlan(a, method)
    dots = _dot_precisions(plan.apply_pure, plan.device_arrays(), x)
    assert dots, "no contraction lowered"
    assert all("precision = [HIGHEST, HIGHEST]" in d for d in dots), dots


def test_spmv_bsr_and_sptrsm_contractions_at_highest_precision():
    from sblas.ops.spmv import SpmvPlan
    from sblas.ops.sptrsm import SptrsmPlan

    a = datasets.banded(300, 20, seed=5, dtype=np.float32)
    p = SpmvPlan(a, "bsr")
    dots = _dot_precisions(p.apply_pure, p.device_arrays(),
                           np.ones(300, np.float32))
    l = datasets.lower_triangular(200, 5, seed=6, dtype=np.float32)
    t = SptrsmPlan(l, method="tiles")
    dots += _dot_precisions(t.apply_pure, t.device_arrays(),
                            np.ones((200, 4), np.float32))
    assert len(dots) >= 2
    assert all("precision = [HIGHEST, HIGHEST]" in d for d in dots), dots


def test_spmm_spmv_passes_method():
    # k SpMV passes over one shared SpmvPlan
    import jax

    a = datasets.emulate("cant", scale=0.1, dtype=np.float32)
    plan = SpmmPlan(a, "spmv_passes", k_hint=8)
    assert plan.method == "spmv_passes"
    x = np.random.default_rng(3).standard_normal(
        (a.shape[1], 8)).astype(np.float32)
    y = np.asarray(jax.jit(plan.apply_pure)(plan.device_arrays(), x))
    assert rel_err(y, spmm_golden(a, x)) < 2e-5
    # __call__ path with alpha/beta
    yv = np.random.default_rng(4).standard_normal(
        (a.shape[0], 8)).astype(np.float32)
    out = np.asarray(plan(x, alpha=2.0, beta=-0.5, y=yv))
    assert rel_err(out, 2.0 * spmm_golden(a, x) - 0.5 * yv) < 2e-5
