"""Large-matrix paths at small sizes (SURVEY.md §7 hard parts 1 & 4):
heavy rows split across bucket slots, SpMM gathers chunked over row
blocks, and triangular solves whose level count equals their row count.
Thresholds are shrunk so the machinery runs on CPU-friendly shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sblas import datasets
from sblas.formats import COO, coo_to_csr, tril
from sblas.golden import rel_err, spmm_golden, spmv_golden, sptrsv_golden
from sblas.ops.spmm import SpmmPlan
from sblas.ops.spmv import SpmvPlan


def _rows_of_degree(degs, n=4096, seed=0):
    """A matrix whose row i has exactly degs[i] distinct columns."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(len(degs)), degs)
    cols = np.concatenate([rng.choice(n, d, replace=False) for d in degs])
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return coo_to_csr(COO((len(degs), n), rows, cols, vals))


@pytest.mark.parametrize("max_width", [64, 128])
def test_heavy_rows_split_at_width_boundary(max_width):
    """Rows of max_width - 1, max_width, max_width + 1 and 3 * max_width
    entries split into the right number of slots and sum back exactly."""
    from sblas.retile import to_bucket_ell

    degs = [max_width - 1, max_width, max_width + 1, 3 * max_width, 5, 0]
    a = _rows_of_degree(degs)
    be = to_bucket_ell(a, max_width=max_width)
    slots = np.bincount(be.perm[be.perm < len(degs)], minlength=len(degs))
    np.testing.assert_array_equal(slots, [1, 1, 2, 3, 1, 1])
    x = np.random.default_rng(1).standard_normal(a.shape[1]).astype(
        np.float32)
    y = np.asarray(SpmvPlan(a, "bucket", max_width=max_width)(x))
    assert rel_err(y, spmv_golden(a, x)) < 1e-5


@pytest.mark.parametrize("k", [3, 32])
@pytest.mark.parametrize("method", ["ell", "bucket"])
def test_spmm_row_chunks_match_one_chunk(method, k):
    """A gather budget of 1 MiB forces many lax.map row blocks; the result
    equals the single-block contraction."""
    a = datasets.random_csr(3000, 3000, 20, skew=1.0, bandwidth=300,
                            seed=4, dtype=np.float32)
    x = np.random.default_rng(k).standard_normal((3000, k)).astype(
        np.float32)
    small = SpmmPlan(a, method, intermediate_mb=1)
    whole = SpmmPlan(a, method, intermediate_mb=1 << 12)
    widths = ([small._width] if method == "ell"
              else list(small._bucket_widths))
    assert min(small._blk(w, k, 4, 3000) for w in widths) < 3000
    np.testing.assert_allclose(np.asarray(small(x)), np.asarray(whole(x)),
                               rtol=1e-5, atol=1e-5)
    assert rel_err(np.asarray(small(x)), spmm_golden(a, x)) < 2e-5


def test_spmm_blk_divides_rows():
    plan = SpmmPlan(datasets.random_csr(64, 64, 4, seed=0), "ell",
                    intermediate_mb=1)
    for mp in (8, 64, 1000, 4096, 4104):
        for width, k in ((8, 1), (200, 32), (2048, 8)):
            blk = plan._blk(width, k, 4, mp)
            assert blk % 8 == 0 and mp % blk == 0 and blk <= mp


@pytest.mark.parametrize("method", ["tiles"])
def test_sptrsv_fully_serial_chain(method):
    """A bidiagonal chain: one row per level, every tile a trip."""
    from sblas.ops.sptrsv import SptrsvPlan

    l = tril(datasets.banded(700, 1, seed=5, dtype=np.float64))
    plan = SptrsvPlan(l, method=method)
    assert plan.nlevels == 700
    b = np.random.default_rng(6).standard_normal(700)
    assert rel_err(np.asarray(plan(b)), sptrsv_golden(l, b)) < 1e-10


def test_kernel_rows_wider_than_chunk():
    """Rows several chunks wide (dense separator rows): the kernel's chunk
    loop stops at each tile's own longest row and still sums every one."""
    from sblas.ops.kernels import sptrsv_triton
    from sblas.sptrsv_schedule import build_level_schedule

    n = 600
    rng = np.random.default_rng(7)
    rows, cols = [], []
    for i in range(1, n):
        d = 300 if i % 97 == 0 else 3       # a few very wide rows
        c = rng.choice(i, min(d, i), replace=False)
        rows.append(np.full(len(c), i))
        cols.append(c)
    rows = np.concatenate(rows + [np.arange(n)])
    cols = np.concatenate(cols + [np.arange(n)])
    vals = np.concatenate([rng.standard_normal(len(rows) - n) * 0.01,
                           np.full(n, 2.0)])
    l = coo_to_csr(COO((n, n), rows, cols, vals))
    sched = build_level_schedule(l)
    wb = 16
    arrs = {k: jnp.asarray(v)
            for k, v in sptrsv_triton.kernel_arrays(sched, wb).items()}
    assert int(np.asarray(arrs["nch"]).max()) > 10
    b = rng.standard_normal(n)
    x = sptrsv_triton.solve(arrs, jnp.asarray(b), n=n,
                            tile_rows=sched.tile_rows,
                            num_tiles=sched.num_tiles, wb=wb,
                            interpret=True)
    assert rel_err(np.asarray(x), sptrsv_golden(l, b)) < 1e-10
