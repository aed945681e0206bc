"""RCM reordering: fill recovery and algebraic correctness."""

import numpy as np
import pytest

from sblas import datasets
from sblas.formats import CSR
from sblas.golden import rel_err, spmv_golden
from sblas.ops import SpmvPlan
from sblas.reorder import rcm, rcm_profile, unpermute


def _scrambled_banded(n=4000, bw=60, nnz_per_row=40, seed=0):
    """A banded matrix with its numbering destroyed — the regime RCM fixes."""
    a = datasets.random_csr(n, n, nnz_per_row, bandwidth=bw, seed=seed,
                            dtype=np.float32)
    rng = np.random.default_rng(seed + 1)
    p = rng.permutation(n)
    s = a.to_scipy().tocsr()[p][:, p].tocsr()
    s.sort_indices()
    return CSR.from_scipy(s).astype(np.float32)


def test_rcm_restores_fill():
    # locality, as rcm_profile reports it: bandwidth and mean row span
    a = _scrambled_banded()
    prof = rcm_profile(a)
    assert prof["bandwidth_after"] < prof["bandwidth_before"] / 3, prof
    assert prof["span_after"] < prof["span_before"] / 3, prof


def test_rcm_spmv_correct():
    a = _scrambled_banded(n=2000)
    ap, perm = rcm(a)
    x = np.random.default_rng(2).standard_normal(2000).astype(np.float32)
    plan = SpmvPlan(ap, "ell")
    y = unpermute(np.asarray(plan(x[perm])), perm)
    assert rel_err(y, spmv_golden(a, x)) < 1e-5


@pytest.mark.parametrize("method", ["coo", "ell", "bucket", "bsr"])
def test_rcm_spmv_every_route(method):
    """P A P^T through each route, unpermuted, equals A x."""
    a = _scrambled_banded(n=3000, seed=3)
    ap, perm = rcm(a)
    x = np.random.default_rng(3).standard_normal(3000).astype(np.float32)
    y = unpermute(np.asarray(SpmvPlan(ap, method)(x[perm])), perm)
    assert rel_err(y, spmv_golden(a, x)) < 1e-4


def test_rcm_rejects_rectangular():
    a = datasets.random_csr(10, 20, 3, seed=4, dtype=np.float32)
    with pytest.raises(ValueError):
        rcm(a)


def test_rcm_bsr_block_density():
    """RCM turns a scrambled band into dense-enough 128x128 blocks for the
    dense-block route: far fewer blocks, all touched near the diagonal."""
    from sblas.retile_bsr import bsr_stats

    a = _scrambled_banded(n=4000, seed=8)
    ap, _ = rcm(a)
    assert bsr_stats(ap)["nblocks"] * 5 < bsr_stats(a)["nblocks"]
    assert bsr_stats(ap)["density"] > 5 * bsr_stats(a)["density"]
