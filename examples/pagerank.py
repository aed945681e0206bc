"""PageRank on a power-law graph — repeated SpMV over one plan.

Usage pattern demonstrated:

- build the column-stochastic operator M = A^T D^-1 host-side with the
  format toolkit (csr_transpose + a diagonal scale on the nnz stream);
- one ``SpmvPlan`` under ``auto`` (degree buckets with heavy-row splitting
  for power-law rows), built once;
- the power iteration runs on the device: one jitted step per iteration
  with the plan's arrays passed as arguments (``apply_pure``).

Run:  SBLAS_PLATFORM=cpu python examples/pagerank.py [n_nodes]
"""

import sys

import numpy as np


def stochastic_transpose(a):
    """M = A^T D^-1 (column-stochastic), D = out-degree; dangling nodes
    get a zero column (handled by the damping term)."""
    import sblas

    deg = np.maximum(a.row_lengths.astype(np.float64), 1.0)
    # PageRank uses the unit adjacency (dataset generators carry random
    # benchmark values): edge weight = 1/out-degree
    w = (1.0 / np.repeat(deg, a.row_lengths)).astype(a.dtype)
    scaled = sblas.CSR(a.shape, a.indptr, a.indices, w)
    return sblas.csr_transpose(scaled)


def pagerank(a, *, damping=0.85, tol=1e-8, maxiter=200, method="auto"):
    """Returns (rank vector, iterations): a host loop around one jitted
    power-iteration step; only the convergence test reads back."""
    import jax
    import jax.numpy as jnp

    from sblas.ops import SpmvPlan

    n = a.shape[0]
    plan = SpmvPlan(stochastic_transpose(a), method)
    dangling = jnp.asarray((a.row_lengths == 0).astype(plan.dtype))

    @jax.jit
    def step(arrs, r):
        leak = damping * jnp.dot(dangling, r) / n      # dangling mass
        r_new = (1.0 - damping) / n + damping * plan.apply_pure(arrs, r) + leak
        return r_new, jnp.abs(r_new - r).sum()

    arrs = plan.device_arrays()
    r = jnp.full(n, 1.0 / n, dtype=plan.dtype)
    for it in range(1, maxiter + 1):
        r, delta = step(arrs, r)
        if float(delta) < tol:
            return np.asarray(r, dtype=np.float64), it
    return np.asarray(r, dtype=np.float64), maxiter


def main():
    import os

    if os.environ.get("SBLAS_PLATFORM"):
        import jax

        jax.config.update("jax_platforms", os.environ["SBLAS_PLATFORM"])
    from sblas import datasets

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 30000
    g = datasets.powerlaw_graph(n, 12.0, 2.1, seed=0, dtype=np.float32)
    r, it = pagerank(g)
    top = np.argsort(-r)[:5]
    print(f"converged in {it} iterations; sum(r) = {r.sum():.6f}")
    print("top nodes:", top.tolist(), [round(float(r[t]), 6) for t in top])


if __name__ == "__main__":
    main()
