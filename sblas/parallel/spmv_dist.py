"""Multi-chip SpMV over a 1D 'chips' mesh (SURVEY.md §3.4, BASELINE config #4).

Data flow per chip (shard_map body):

    x_full  = all_gather(x_shard, 'chips')
    y_local = ELL-spmv(local shard, x_full)
    [nnz-split] y = psum(partial y)

Partition strategies mirror the reference (even_rows / nnz_balanced row
splits; nnz_split with cut rows). Per-device shards are retiled to a common
geometry (:func:`.local.stack_rows`) so they stack into sharded arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..formats import CSR, INDEX_DTYPE
from ..ops.common import ell_dot
from ..partition import partition_rows
from ..retile import to_ell
from .local import apply_rows, shard_rows
from .mesh import make_mesh, chips_axis

def _round_up(x, m):
    return ((x + m - 1) // m) * m


class DistSpmvPlan:
    """Partition + retile + shard_map executor for one matrix on one mesh.

    Local compute inside the shard_map body is the XLA ELL gather, or
    degree buckets when a block's rows are skewed (:mod:`.local`);
    ``local_method`` records which."""

    def __init__(self, a: CSR, mesh: Mesh | None = None, *,
                 strategy: str = "nnz_balanced"):
        self.mesh = mesh or make_mesh()
        ndev = self.mesh.devices.size
        self.ndev = ndev
        self.shape = a.shape
        self.dtype = a.dtype
        self.strategy = strategy
        m, n = a.shape
        self.x_chunk = _round_up(max(-(-n // ndev), 1), 8)
        self.n_pad = self.x_chunk * ndev

        sh = NamedSharding(self.mesh, P(chips_axis))
        sr = shard_rows(a, ndev, strategy, sh)
        self._split = sr.unpad is None
        self._unpad = sr.unpad
        self.local_method = sr.method
        self.bytes_per_iter = sr.bytes_per_iter
        self._arrs = sr.arrs
        self._x_sharding = sh
        self._build_fn(sr.out_rows)

    def _build_fn(self, out_rows: int):
        m, n = self.shape
        split = self._split

        def body(arrs, x_shard):
            buckets, perm = arrs
            with jax.named_scope("collective"):
                x_full = lax.all_gather(x_shard, chips_axis, tiled=True)
            with jax.named_scope("kernel"):
                y = apply_rows(buckets, perm, x_full, out_rows)
            if split:
                # rows cut between two devices hold partial sums: one
                # psum over the shared row space merges them
                with jax.named_scope("collective"):
                    y = lax.psum(y, chips_axis)
            return y[None]

        fn = shard_map(
            body, mesh=self.mesh,
            in_specs=(P(chips_axis), P(chips_axis)),
            out_specs=P(None, None) if split else P(chips_axis, None),
            check_vma=False,
        )

        if split:
            @jax.jit
            def run(arrs, x_pad):
                return fn(arrs, x_pad).reshape(-1)[:m]
        else:
            unpad = self._unpad

            @jax.jit
            def run(arrs, x_pad):
                return fn(arrs, x_pad).reshape(-1)[unpad]

        self._run = run

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        m, n = self.shape
        x = jnp.asarray(x, dtype=self.dtype)
        if x.shape != (n,):
            raise ValueError(f"x must have shape ({n},)")
        x_pad = jnp.zeros(self.n_pad, dtype=self.dtype).at[:n].set(x)
        x_pad = jax.device_put(x_pad, self._x_sharding)
        out = alpha * self._run(self._arrs, x_pad)
        if y is not None:
            out = out + beta * jnp.asarray(y, dtype=self.dtype)
        elif beta != 0.0:
            raise ValueError("beta != 0 requires y")
        return out

    def device_arrays(self):
        """Matrix-side device arrays, for passing through jit arguments
        (closure constants would be embedded in the compiled program).
        Pair with :meth:`apply_pure` so solver loops
        (``parallel/solvers_dist.py``) keep the whole Krylov iteration
        on-device."""
        return self._arrs

    def apply_pure(self, arrs, x):
        """Pure ``y = A @ x`` on global (n,)->(m,) vectors, jit-composable:
        no host work, so a ``lax.while_loop`` can call it every iteration."""
        n = self.shape[1]
        x = jnp.asarray(x, dtype=self.dtype)
        x_pad = jnp.zeros(self.n_pad, dtype=self.dtype).at[:n].set(x)
        x_pad = jax.lax.with_sharding_constraint(x_pad, self._x_sharding)
        return self._run(arrs, x_pad)

class RingSpmvPlan:
    """Ring SpMV: x stays sharded; shards rotate around the ring with
    `ppermute` while each chip accumulates the matching column block's
    partial product (SURVEY.md §5 "long-context" analogue — the SpMV
    equivalent of ring attention, for x too large to replicate in HBM).

    Per chip d, the local rows are split into ndev column blocks; at ring
    step k the device holds x shard (d+k) mod ndev and applies block
    A[rows_d, cols_{(d+k) mod ndev}]. ndev steps; each moves x_chunk to the
    next device once — total traffic equals one all_gather, but peak memory
    is one shard instead of the full x."""

    def __init__(self, a: CSR, mesh: Mesh | None = None, *,
                 strategy: str = "nnz_balanced"):
        self.mesh = mesh or make_mesh()
        ndev = int(self.mesh.devices.size)
        self.ndev = ndev
        self.shape = a.shape
        self.dtype = a.dtype
        m, n = a.shape
        self.x_chunk = _round_up(max(-(-n // ndev), 1), 8)
        self.n_pad = self.x_chunk * ndev

        part = partition_rows(a, ndev, strategy)
        # split each chip's rows by column block; one ELL per ring offset k
        # covering block (d, (d+k) % ndev), indices local to the block.
        per_offset = []  # k -> (col, val) stacked over chips
        rows_pad = max(_round_up(max(p.shape[0], 1), 8) for p in part.parts)
        self.rows_pad = rows_pad
        sh = lambda spec: NamedSharding(self.mesh, spec)
        for k in range(ndev):
            blocks = []
            for d, p in enumerate(part.parts):
                src_blk = (d + k) % ndev
                c0 = src_blk * self.x_chunk
                c1 = min(c0 + self.x_chunk, n)
                coo = p.tocoo()
                sel = (coo.col >= c0) & (coo.col < c1)
                from ..formats import COO, coo_to_csr

                blk = coo_to_csr(COO((p.shape[0], self.x_chunk),
                                     coo.row[sel], coo.col[sel] - c0,
                                     coo.data[sel]))
                blocks.append(to_ell(blk))
            width = max(max(e.width for e in blocks), 8)
            col = np.zeros((ndev, rows_pad, width), dtype=INDEX_DTYPE)
            val = np.zeros((ndev, rows_pad, width), dtype=a.dtype)
            for d, e in enumerate(blocks):
                col[d, : e.col.shape[0], : e.width] = e.col
                val[d, : e.val.shape[0], : e.width] = e.val
            per_offset.append((
                jax.device_put(col, sh(P(chips_axis))),
                jax.device_put(val, sh(P(chips_axis))),
            ))
        self._per_offset = per_offset
        slot = np.empty(m, dtype=np.int64)
        for d in range(ndev):
            r0, r1 = int(part.row_starts[d]), int(part.row_starts[d + 1])
            slot[r0:r1] = d * rows_pad + np.arange(r1 - r0)
        self._unpad = jnp.asarray(slot.astype(INDEX_DTYPE))
        self._x_sharding = sh(P(chips_axis))
        self.bytes_per_iter = sum(
            c.size * (a.data.itemsize + 4) for c, v in per_offset
        )
        self._build()

    def _build(self):
        ndev = self.ndev
        rows_pad = self.rows_pad
        shift = [(i, (i - 1) % ndev) for i in range(ndev)]

        def body(x_shard, *offset_arrays):
            xcur = x_shard[0]
            y = jnp.zeros((rows_pad,), dtype=xcur.dtype)
            for k in range(ndev):
                col, val = offset_arrays[2 * k], offset_arrays[2 * k + 1]
                y = y + ell_dot(val[0], col[0], xcur)
                if k + 1 < ndev:
                    xcur = lax.ppermute(xcur, chips_axis, shift)
            return y[None]

        flat_specs = tuple(P(chips_axis) for _ in range(2 * ndev))
        fn = shard_map(
            body, mesh=self.mesh,
            in_specs=(P(chips_axis),) + flat_specs,
            out_specs=P(chips_axis, None),
            check_vma=False,
        )
        unpad = self._unpad

        @jax.jit
        def run(x_pad, *offset_arrays):
            y = fn(x_pad[:, None].reshape(self.ndev, -1), *offset_arrays)
            return y.reshape(-1)[unpad]

        self._run = run

    def __call__(self, x):
        m, n = self.shape
        x = jnp.asarray(x, dtype=self.dtype)
        if x.shape != (n,):
            raise ValueError(f"x must have shape ({n},)")
        x_pad = jnp.zeros(self.n_pad, dtype=self.dtype).at[:n].set(x)
        x_pad = jax.device_put(x_pad, self._x_sharding)
        flat = []
        for col, val in self._per_offset:
            flat.extend([col, val])
        return self._run(x_pad, *flat)

def dist_spmv(a: CSR, x, mesh: Mesh | None = None, *,
              strategy: str = "nnz_balanced", alpha: float = 1.0,
              beta: float = 0.0, y=None):
    """One-shot distributed SpMV (plan not cached; build a DistSpmvPlan for
    repeated use)."""
    return DistSpmvPlan(a, mesh, strategy=strategy)(x, alpha, beta, y)
