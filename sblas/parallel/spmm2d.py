"""2D-partitioned multi-device SpMM over a ('rows', 'cols') mesh.

Same data flow as spmv2d (see that module's traffic analysis): device
(i, j) owns block A[rows_i, cols_j]; the dense RHS X lives row-sharded over
the 'cols' axis — chunk j is already on every device of mesh column j — and
the single collective is a psum of the (m/R, k) partial Y over 'cols'. For
K RHS columns the 2D layout's advantage over the 1D all_gather grows
K-fold: 1D must replicate the full (n, k) X per device, 2D moves only
~2·(m/R)·k.

Local compute: the XLA ELL contraction, or degree buckets on skewed rows
(:mod:`.local`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..formats import CSR, INDEX_DTYPE
from ..partition import partition_rows
from .local import apply_rows, split_2d_blocks, stack_rows, unpad_slots
from .mesh import make_mesh2d, rows_axis, cols_axis


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class Dist2DSpmmPlan:
    """Partition + retile + shard_map SpMM executor over a 2D mesh."""

    def __init__(self, a: CSR, mesh: Mesh | None = None):
        self.mesh = mesh or make_mesh2d()
        if self.mesh.axis_names != (rows_axis, cols_axis):
            raise ValueError(
                f"need a ('{rows_axis}', '{cols_axis}') mesh; got "
                f"{self.mesh.axis_names} (make_mesh2d builds one)"
            )
        R, C = self.mesh.devices.shape
        self.grid = (R, C)
        self.shape = a.shape
        self.dtype = a.dtype
        m, n = a.shape
        self.x_chunk = _round_up(max(-(-n // C), 1), 128)
        self.n_pad = self.x_chunk * C

        part = partition_rows(a, R, "nnz_balanced")
        self.nnz_balance = part.balance()
        row_starts = [int(r) for r in part.row_starts]
        blocks = split_2d_blocks(part.parts, self.x_chunk, C)
        st = stack_rows(blocks, a.dtype)
        self.local_method = st.method
        self.bytes_per_iter = st.bytes_per_iter
        sh = NamedSharding(self.mesh, P(rows_axis, cols_axis))
        r4 = lambda arr: jax.device_put(
            arr.reshape((R, C) + arr.shape[1:]), sh)
        self._arrs = (tuple((r4(c), r4(v)) for c, v in st.buckets),
                      None if st.perm is None else r4(st.perm))
        self._unpad = jnp.asarray(
            unpad_slots(row_starts, st.out_rows).astype(INDEX_DTYPE))
        self._x_sharding = NamedSharding(self.mesh, P(cols_axis, None))
        out_rows = st.out_rows

        def body(arrs, x_shard):
            # arrays: (1, 1, ...) this device's block; x_shard: (x_chunk, k)
            buckets, perm = jax.tree.map(lambda t: t[0], arrs)
            with jax.named_scope("kernel"):
                y_loc = apply_rows(buckets, perm, x_shard, out_rows)
            with jax.named_scope("collective"):
                y = lax.psum(y_loc, cols_axis)
            return y[None]

        fn = shard_map(
            body, mesh=self.mesh,
            in_specs=(P(rows_axis, cols_axis), P(cols_axis, None)),
            out_specs=P(rows_axis, None, None),
            check_vma=False,
        )
        unpad = self._unpad

        @jax.jit
        def run(arrs, x_pad):
            y = fn(arrs, x_pad)  # (R, out_rows, k)
            return y.reshape(-1, y.shape[-1])[unpad]

        self._run = run

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        m, n = self.shape
        x = jnp.asarray(x, dtype=self.dtype)
        if x.ndim != 2 or x.shape[0] != n:
            raise ValueError(f"X must have shape ({n}, k), got {x.shape}")
        k = x.shape[1]
        x_pad = jnp.zeros((self.n_pad, k), dtype=self.dtype).at[:n].set(x)
        x_pad = jax.device_put(x_pad, self._x_sharding)
        out = alpha * self._run(self._arrs, x_pad)
        if y is not None:
            out = out + beta * jnp.asarray(y, dtype=self.dtype)
        elif beta != 0.0:
            raise ValueError("beta != 0 requires y")
        return out


def dist_spmm2d(a: CSR, x, mesh: Mesh | None = None, **kw):
    """One-shot 2D-partitioned distributed SpMM."""
    return Dist2DSpmmPlan(a, mesh, **kw)(x)
