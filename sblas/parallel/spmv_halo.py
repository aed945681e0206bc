"""Halo-exchange distributed SpMV: neighbor strips instead of all_gather.

For banded/FEM matrices under a contiguous row partition, chip d's block
touches columns only inside [r0_d - H_l, r1_d + H_r): everything it needs
beyond its own x shard lives in the boundary strips of its two ring
neighbors. The 1D all_gather plan moves ~n·4 bytes per device per SpMV —
that term is what kills weak scaling (BASELINE config #4/#5); the halo
plan moves 2·H·4 bytes per device (H = max one-sided halo over devices, for
SPMD-uniform slab shapes), independent of the number of devices and of n
for mesh-like matrices.

Data flow per device (shard_map body):

    left  = ppermute(my top H rows    -> right neighbor)
    right = ppermute(my bottom H rows -> left  neighbor)
    x_ext = concat(left, x_own, right)
    y_own = local-spmv(block, x_ext)

Construction REFUSES (ValueError) when the required halo exceeds
``max_halo_frac`` of the shard size — scattered matrices should use the
all_gather or 2D plans instead; the caller decides.

Local compute: XLA ELL, or degree buckets on skewed rows (:mod:`.local`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..formats import CSR, COO, coo_to_csr
from .local import apply_rows, stack_rows
from .mesh import make_mesh, chips_axis


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _halo_partition(a: CSR, ndev: int, max_halo_frac: float):
    """Even row split + halo width + per-chip blocks in ext coordinates.

    Returns (chunk, halo, blocks) or raises ValueError when the matrix is
    not band-local enough."""
    m, n = a.shape
    chunk = _round_up(-(-n // ndev), 8)
    row_starts = [min(d * chunk, n) for d in range(ndev + 1)]

    halo = 0
    parts = []
    s_csr = a.to_scipy().tocsr()
    for d in range(ndev):
        r0, r1 = row_starts[d], row_starts[d + 1]
        sub = s_csr[r0:r1]
        parts.append(sub)
        if sub.nnz:
            lo = int(sub.indices.min())
            hi = int(sub.indices.max())
            halo = max(halo, d * chunk - lo if lo < d * chunk else 0,
                       hi - (d * chunk + chunk - 1)
                       if hi >= d * chunk + chunk else 0)
    halo = _round_up(max(halo, 8), 8)
    if halo > max_halo_frac * chunk:
        raise ValueError(
            f"halo {halo} exceeds {max_halo_frac:.0%} of the {chunk}-row "
            "shard — matrix is not band-local; use DistSpmvPlan "
            "(all_gather) or the 2D plan"
        )
    if halo > chunk:
        raise ValueError("halo wider than a shard; fewer devices or "
                         "another plan")
    ext = chunk + 2 * halo
    blocks = []
    for d in range(ndev):
        sub = parts[d].tocoo()
        base = d * chunk - halo
        blocks.append(coo_to_csr(COO(
            (parts[d].shape[0], ext),
            sub.row.astype(np.int64),
            sub.col.astype(np.int64) - base,
            sub.data,
        )).astype(a.dtype))
    return chunk, halo, blocks


class _HaloPlan:
    """Shared set-up: even row split, halo width, stacked local blocks."""

    def __init__(self, a: CSR, mesh: Mesh | None, max_halo_frac: float):
        m, n = a.shape
        if m != n:
            raise ValueError("halo plan needs a square matrix (x partition "
                             "= row partition)")
        self.mesh = mesh or make_mesh()
        ndev = int(self.mesh.devices.size)
        self.ndev = ndev
        self.shape = a.shape
        self.dtype = a.dtype

        # even row split so the x shards are uniform (required for fixed
        # ppermute slab shapes); nnz balance is secondary here
        chunk, halo, blocks = _halo_partition(a, ndev, max_halo_frac)
        self.x_chunk = chunk
        self.n_pad = chunk * ndev
        self.halo = halo
        self.ext = chunk + 2 * halo
        st = stack_rows(blocks, a.dtype, out_rows=chunk)
        self.local_method = st.method
        self.bytes_per_iter = st.bytes_per_iter
        sh = NamedSharding(self.mesh, P(chips_axis))
        self._arrs = (
            tuple((jax.device_put(c, sh), jax.device_put(v, sh))
                  for c, v in st.buckets),
            None if st.perm is None else jax.device_put(st.perm, sh))
        # collective model: two H-slabs per device per iteration
        self.collective_bytes_per_chip = 2 * halo * a.data.itemsize

    def _build_run(self, x_spec):
        ndev, halo, chunk = self.ndev, self.halo, self.x_chunk
        n = self.shape[0]
        fwd = [(i, (i + 1) % ndev) for i in range(ndev)]   # d -> d+1
        bwd = [(i, (i - 1) % ndev) for i in range(ndev)]   # d -> d-1

        def body(arrs, x_own):
            # x_own: (chunk,) or (chunk, k). Left halo = previous device's
            # bottom rows; right halo = next device's top rows. The ring
            # wraps, but wrap slabs are never read: halo columns past the
            # matrix edge do not occur (halo derives from real column
            # spans).
            buckets, perm = arrs
            with jax.named_scope("collective"):
                left = lax.ppermute(x_own[-halo:], chips_axis, fwd)
                right = lax.ppermute(x_own[:halo], chips_axis, bwd)
            x_ext = jnp.concatenate([left, x_own, right])
            with jax.named_scope("kernel"):
                y = apply_rows(buckets, perm, x_ext, chunk)
            return y[None]

        fn = shard_map(
            body, mesh=self.mesh,
            in_specs=(P(chips_axis), x_spec),
            out_specs=P(chips_axis, *([None] * len(x_spec))),
            check_vma=False,
        )

        @jax.jit
        def run(arrs, x_pad):
            y = fn(arrs, x_pad)                # (ndev, chunk[, k])
            return y.reshape((-1,) + y.shape[2:])[:n]

        return run

    def _apply(self, x, alpha, beta, y):
        out = alpha * self._run(self._arrs, x)
        if y is not None:
            out = out + beta * jnp.asarray(y, dtype=self.dtype)
        elif beta != 0.0:
            raise ValueError("beta != 0 requires y")
        return out


class HaloSpmvPlan(_HaloPlan):
    """Row-partitioned SpMV with neighbor halo exchange (square A)."""

    def __init__(self, a: CSR, mesh: Mesh | None = None, *,
                 max_halo_frac: float = 0.5):
        super().__init__(a, mesh, max_halo_frac)
        self._x_sharding = NamedSharding(self.mesh, P(chips_axis))
        self._run = self._build_run(P(chips_axis))

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        m, n = self.shape
        x = jnp.asarray(x, dtype=self.dtype)
        if x.shape != (n,):
            raise ValueError(f"x must have shape ({n},)")
        x_pad = jnp.zeros(self.n_pad, dtype=self.dtype).at[:n].set(x)
        return self._apply(jax.device_put(x_pad, self._x_sharding),
                           alpha, beta, y)


def halo_spmv(a: CSR, x, mesh: Mesh | None = None, **kw):
    """One-shot halo-exchange distributed SpMV."""
    return HaloSpmvPlan(a, mesh, **kw)(x)


class HaloSpmmPlan(_HaloPlan):
    """Row-partitioned SpMM with neighbor halo exchange: the dense RHS X
    is row-sharded like x, the exchange moves two (H, k) slabs per device —
    still independent of n and device count, now amortized over k columns
    of arithmetic."""

    def __init__(self, a: CSR, mesh: Mesh | None = None, *,
                 max_halo_frac: float = 0.5):
        super().__init__(a, mesh, max_halo_frac)
        self._x_sharding = NamedSharding(self.mesh, P(chips_axis, None))
        self._run = self._build_run(P(chips_axis, None))

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        m, n = self.shape
        x = jnp.asarray(x, dtype=self.dtype)
        if x.ndim != 2 or x.shape[0] != n:
            raise ValueError(f"X must have shape ({n}, k), got {x.shape}")
        x_pad = jnp.zeros((self.n_pad, x.shape[1]),
                          dtype=self.dtype).at[:n].set(x)
        return self._apply(jax.device_put(x_pad, self._x_sharding),
                           alpha, beta, y)


def halo_spmm(a: CSR, x, mesh: Mesh | None = None, **kw):
    """One-shot halo-exchange distributed SpMM."""
    return HaloSpmmPlan(a, mesh, **kw)(x)
