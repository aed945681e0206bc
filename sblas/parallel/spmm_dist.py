"""Multi-device SpMM over the 1D 'chips' mesh (BASELINE config #5).

Same partition/collective structure as spmv_dist: X (n, k) is row-sharded,
all-gathered, each device runs its local K-wide contraction (ELL, or
degree buckets on skewed rows; :mod:`.local`), and Y comes out
row-sharded."""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..formats import CSR
from .local import apply_rows, shard_rows
from .mesh import make_mesh, chips_axis
from .spmv_dist import _round_up


class DistSpmmPlan:
    """Row-sharded X, all_gather, local K-wide product, row-sharded Y
    (or a psum merge under ``nnz_split``)."""

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

        sr = shard_rows(a, ndev, strategy,
                        NamedSharding(self.mesh, P(chips_axis)))
        self._split = sr.unpad is None
        self._unpad = sr.unpad
        self.local_method = sr.method
        self.bytes_per_iter_nx = sr.bytes_per_iter
        self._out_rows = sr.out_rows
        self._arrs = sr.arrs
        self._x_sharding = NamedSharding(self.mesh, P(chips_axis, None))
        self._runs = {}

    def _get_run(self, k: int):
        if k in self._runs:
            return self._runs[k]
        m = self.shape[0]
        out_rows = self._out_rows
        split = self._split

        def body(arrs, x_shard):
            buckets, perm = arrs
            with jax.named_scope("collective"):
                x_full = lax.all_gather(x_shard, chips_axis, tiled=True)
            with jax.named_scope("kernel"):
                y = apply_rows(buckets, perm, x_full, out_rows)
            if split:
                with jax.named_scope("collective"):
                    y = lax.psum(y, chips_axis)
            return y[None]

        fn = shard_map(
            body, mesh=self.mesh,
            in_specs=(P(chips_axis), P(chips_axis, None)),
            out_specs=(P(None, None, None) if split
                       else P(chips_axis, None, None)),
            check_vma=False,
        )

        if split:
            @jax.jit
            def run(arrs, x_pad):
                return fn(arrs, x_pad).reshape(-1, k)[:m]
        else:
            unpad = self._unpad

            @jax.jit
            def run(arrs, x_pad):
                return fn(arrs, x_pad).reshape(-1, k)[unpad]

        self._runs[k] = run
        return run

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        m, n = self.shape
        x = jnp.asarray(x, dtype=self.dtype)
        if x.ndim != 2 or x.shape[0] != n:
            raise ValueError(f"X must have shape ({n}, k)")
        k = x.shape[1]
        x_pad = jnp.zeros((self.n_pad, k), dtype=self.dtype).at[:n].set(x)
        x_pad = jax.device_put(x_pad, self._x_sharding)
        out = alpha * self._get_run(k)(self._arrs, x_pad)
        if y is not None:
            out = out + beta * jnp.asarray(y, dtype=self.dtype)
        elif beta != 0.0:
            raise ValueError("beta != 0 requires y")
        return out


def dist_spmm(a: CSR, x, mesh: Mesh | None = None, **kw):
    alpha = kw.pop("alpha", 1.0)
    beta = kw.pop("beta", 0.0)
    y = kw.pop("y", None)
    return DistSpmmPlan(a, mesh, **kw)(x, alpha, beta, y)
