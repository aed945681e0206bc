"""Randomized property tests (SURVEY.md §4): structure-perturbation
invariants across formats, layouts, and ops, seeded for reproducibility."""

import numpy as np
import pytest

from sblas import datasets
from sblas.formats import COO, CSR, coo_to_csr, csr_transpose
from sblas.golden import spmv_golden, rel_err
from sblas.ops.spmv import SpmvPlan


@pytest.mark.parametrize("seed", range(8))
def test_random_structure_roundtrip(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(1, 400))
    n = int(rng.integers(1, 400))
    nnz = int(rng.integers(0, max(m * n // 4, 1)))
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    coo = COO((m, n), rows, cols, vals)
    csr = coo_to_csr(coo)
    # duplicates merged
    np.testing.assert_allclose(csr.todense(), coo.todense(), atol=1e-12)
    # transpose involution
    tt = csr_transpose(csr_transpose(csr))
    np.testing.assert_allclose(tt.todense(), csr.todense())
    # row permutation of input == permutation of output (SpMV linearity)
    if m and n and csr.nnz:
        x = rng.standard_normal(n)
        y = spmv_golden(csr, x)
        perm = rng.permutation(m)
        pc = csr.tocoo()
        inv = np.empty(m, dtype=np.int64)
        inv[perm] = np.arange(m)
        permuted = coo_to_csr(COO((m, n), inv[pc.row], pc.col, pc.data))
        yp = spmv_golden(permuted, x)
        np.testing.assert_allclose(yp[inv], y, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("seed", range(5))
def test_spmv_methods_agree_random(seed):
    rng = np.random.default_rng(100 + seed)
    m = int(rng.integers(16, 300))
    a = datasets.random_csr(m, m, float(rng.integers(1, 12)),
                            skew=float(rng.uniform(0, 1.5)),
                            seed=seed, dtype=np.float64)
    x = rng.standard_normal(m)
    ys = {meth: np.asarray(SpmvPlan(a, meth)(x))
          for meth in ("coo", "ell", "bucket", "bsr")}
    ref = spmv_golden(a, x)
    for meth, y in ys.items():
        assert rel_err(y, ref) < 1e-10, meth


def _random_coo_csr(rng, max_m=600, max_n=600, div=6):
    m = int(rng.integers(1, max_m))
    n = int(rng.integers(1, max_n))
    nnz = int(rng.integers(0, max(m * n // div, 1)))
    coo = COO((m, n), rng.integers(0, m, nnz), rng.integers(0, n, nnz),
              rng.standard_normal(nnz).astype(np.float32))
    return coo_to_csr(coo).astype(np.float32)


def _ell_to_dense(col, val, m, n):
    dense = np.zeros((col.shape[0], n))
    np.add.at(dense, (np.repeat(np.arange(col.shape[0]), col.shape[1]),
                      col.ravel()), val.ravel())
    return dense[:m]


@pytest.mark.parametrize("seed", range(4))
def test_ell_pack_random_roundtrip(seed):
    from sblas.retile import to_ell

    a = _random_coo_csr(np.random.default_rng(200 + seed))
    e = to_ell(a)
    assert e.col.shape[1] % 8 == 0 and e.col.shape[0] % 8 == 0
    np.testing.assert_allclose(_ell_to_dense(e.col, e.val, *a.shape),
                               a.to_scipy().toarray(), rtol=0, atol=0)


@pytest.mark.parametrize("seed", range(6))
def test_bucket_pack_random_roundtrip(seed):
    """Degree buckets with heavy-row splitting reconstruct the matrix
    exactly: every slot's partial row lands on its row through ``perm``."""
    from sblas.retile import to_bucket_ell

    rng = np.random.default_rng(100 + seed)
    a = _random_coo_csr(rng, div=4)
    be = to_bucket_ell(a, max_width=int(rng.integers(8, 64)))
    m, n = a.shape
    dense = np.zeros((m + 1, n))
    start = 0
    for b in be.buckets:
        r = b.col.shape[0]
        part = _ell_to_dense(b.col, b.val, r, n)
        np.add.at(dense, be.perm[start:start + r], part)
        start += r
    np.testing.assert_allclose(dense[:m], a.to_scipy().toarray(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_bsr_pack_random_roundtrip(seed):
    from sblas.retile_bsr import pack_bsr

    a = _random_coo_csr(np.random.default_rng(400 + seed), div=20)
    b = pack_bsr(a, br=32, bc=32)
    dense = np.zeros((b.num_brows * 32, b.num_bcols * 32))
    for blk, r, c in zip(b.blocks, b.brow, b.bcol):
        dense[r * 32:(r + 1) * 32, c * 32:(c + 1) * 32] += blk
    np.testing.assert_allclose(dense[: a.shape[0], : a.shape[1]],
                               a.to_scipy().toarray(), rtol=0, atol=0)


@pytest.mark.parametrize("seed", range(4))
def test_stack_rows_random_roundtrip(seed):
    """The distributed local layout reconstructs every device's rows, under
    a row split and an nnz split, for ELL and bucket geometries."""
    from sblas.parallel.local import local_parts, stack_rows

    rng = np.random.default_rng(500 + seed)
    a = (datasets.powerlaw_graph(int(rng.integers(200, 900)), 8, seed=seed,
                                 dtype=np.float32)
         if seed % 2 else _random_coo_csr(rng, div=8))
    m, n = a.shape
    want = a.to_scipy().toarray()
    for strategy in ("nnz_balanced", "nnz_split"):
        parts, row_starts, row_base = local_parts(a, 4, strategy)
        st = (stack_rows(parts, np.float32, out_rows=m, row_base=row_base)
              if row_base else stack_rows(parts, np.float32))
        got = np.zeros((m, n))
        for d in range(4):
            out = np.zeros((st.out_rows + 1, n))
            start = 0
            for col, val in st.buckets:
                r = col.shape[1]
                part = _ell_to_dense(col[d], val[d], r, n)
                rows = (np.arange(r) if st.perm is None
                        else st.perm[d, start:start + r])
                np.add.at(out, rows, part)
                start += r
            if row_base:
                got += out[:m]
            else:
                r0, r1 = row_starts[d], row_starts[d + 1]
                got[r0:r1] = out[: r1 - r0]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_trans_csc_algebra_random(seed):
    """spmv over {CSR, CSC} x {trans, no-trans} all agree with scipy."""
    from sblas.formats import coo_to_csc
    from sblas.ops import spmv

    rng = np.random.default_rng(200 + seed)
    m = int(rng.integers(2, 300))
    n = int(rng.integers(2, 300))
    nnz = int(rng.integers(1, max(m * n // 5, 2)))
    coo = COO((m, n), rng.integers(0, m, nnz), rng.integers(0, n, nnz),
              rng.standard_normal(nnz).astype(np.float32))
    a = coo_to_csr(coo).astype(np.float32)
    c = coo_to_csc(a.tocoo())
    s = a.to_scipy().astype(np.float64)
    x = rng.standard_normal(n).astype(np.float32)
    xt = rng.standard_normal(m).astype(np.float32)
    for mat in (a, c):
        assert rel_err(np.asarray(spmv(mat, x)), s @ x) < 1e-4
        assert rel_err(np.asarray(spmv(mat, xt, trans=True)), s.T @ xt) < 1e-4
