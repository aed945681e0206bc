"""Bandwidth-reducing reordering (reverse Cuthill–McKee).

An SpMV gathers x[col] for every nonzero; rows whose columns sit close
together read x from few cache lines, scattered columns read one line per
nonzero. FEM matrices from meshers usually arrive with good locality;
matrices with scrambled numbering do not. RCM restores locality for
anything whose underlying graph is mesh-like.

Usage:

    ap, perm = sblas.reorder.rcm(a)      # ap = P A P^T, symmetric perm
    plan = SpmvPlan(ap)
    y = unpermute(plan(x[perm]), perm)   # or stay in permuted space

``rcm_profile(a)`` reports the bandwidth and mean row span before and
after, so callers can decide whether the two permutation applications per
drop-in call are worth it (iterative solvers amortize them to zero by
staying in permuted space).
"""

from __future__ import annotations

import numpy as np

from .formats import CSR


def rcm(a: CSR) -> tuple[CSR, np.ndarray]:
    """Symmetric reverse Cuthill–McKee reordering of a square CSR matrix.

    Returns (P A P^T, perm) with ``perm[new] = old`` — i.e. apply as
    ``x_perm = x[perm]`` and ``y = y_perm_inverse`` (see ``unpermute``).
    The ordering is computed on the symmetrized pattern |A| + |A|^T.
    """
    m, n = a.shape
    if m != n:
        raise ValueError("rcm needs a square matrix")
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    s = a.to_scipy().tocsr()
    pattern = (abs(s) + abs(s).T).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(pattern, symmetric_mode=True),
                      dtype=np.int64)
    sp = s[perm][:, perm].tocsr()
    sp.sort_indices()
    return CSR.from_scipy(sp).astype(a.dtype), perm


def unpermute(y_perm, perm: np.ndarray):
    """Undo the row permutation of ``rcm`` on a result vector/matrix."""
    out = np.empty_like(np.asarray(y_perm))
    out[perm] = np.asarray(y_perm)
    return out


def rcm_profile(a: CSR) -> dict:
    """Bandwidth (max |i - j|) and mean row span (max - min column per
    row) before and after RCM."""
    def stats(mat):
        rows = mat.row_ids().astype(np.int64)
        cols = mat.indices.astype(np.int64)
        if not len(cols):
            return 0, 0.0
        m = mat.shape[0]
        lo = np.full(m, np.iinfo(np.int64).max)
        hi = np.full(m, -1)
        np.minimum.at(lo, rows, cols)
        np.maximum.at(hi, rows, cols)
        live = hi >= 0
        return (int(np.abs(rows - cols).max()),
                float((hi[live] - lo[live]).mean()))

    ap, _ = rcm(a)
    (bw0, span0), (bw1, span1) = stats(a), stats(ap)
    return {"bandwidth_before": bw0, "bandwidth_after": bw1,
            "span_before": span0, "span_after": span1}
