"""2D-partitioned multi-device SpMV over a ('rows', 'cols') mesh.

The 1D plans replicate x on every device via ``all_gather`` — per-device
traffic grows with the full problem size n, which is what caps 1D scaling
(SURVEY.md §5 "long-context analogue"). The 2D plan is the SpMV analogue
of A-stationary 2D matmul sharding: device (i, j) owns block
A[rows_i, cols_j], x lives sharded over the 'cols' axis (chunk j on every
device of column j — already where it's needed, no gather at all), and the
single collective is a ``psum`` of the (m/R)-length partial y over 'cols'.

Per-device bytes: 1D all_gather moves ~n per device; 2D psum moves
~2·(C-1)/C · m/R per device (reduce-scatter + all-gather lowering). For a
square matrix on a P-device mesh with R=C=√P that is ~2·m/√P — the 2D
plan's traffic *shrinks* as the mesh grows, which keeps weak scaling
(BASELINE config #5) tractable for matrices whose x no longer fits one
device.

Partitioning: rows nnz-balanced into R groups (reference strategy); columns
split evenly in 128-aligned chunks so the x sharding is uniform. Local
compute is the XLA ELL gather, or degree buckets on skewed rows
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


class Dist2DSpmvPlan:
    """Partition + retile + shard_map executor over a 2D mesh."""

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

        # block (i, j): rows_i x [j*x_chunk, (j+1)*x_chunk), local col idx
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
        self._x_sharding = NamedSharding(self.mesh, P(cols_axis))
        self._build_fn(st.out_rows)

    def _build_fn(self, out_rows: int):
        def body(arrs, x_shard):
            # arrays: (1, 1, ...) this device's block; x_shard: (x_chunk,)
            # — this device's column chunk, no gather needed
            buckets, perm = jax.tree.map(lambda t: t[0], arrs)
            with jax.named_scope("kernel"):
                y_loc = apply_rows(buckets, perm, x_shard, out_rows)
            with jax.named_scope("collective"):
                y = lax.psum(y_loc, cols_axis)
            return y[None]

        fn = shard_map(
            body, mesh=self.mesh,
            in_specs=(P(rows_axis, cols_axis), P(cols_axis)),
            out_specs=P(rows_axis, None),
            check_vma=False,
        )
        unpad = self._unpad

        @jax.jit
        def run(arrs, x_pad):
            return fn(arrs, x_pad).reshape(-1)[unpad]   # (R, out_rows)

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


def dist_spmv2d(a: CSR, x, mesh: Mesh | None = None, **kw):
    """One-shot 2D-partitioned distributed SpMV."""
    return Dist2DSpmvPlan(a, mesh, **kw)(x)
