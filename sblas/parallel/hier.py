"""Multi-host ('hosts', 'chips') hierarchical mesh plans (SURVEY.md C11).

Devices within a host share a fast link; hosts are joined by a slower
network. The flat 1D plans treat every device pair as equal, so their
single all_gather makes every device's x chunk cross the host network
separately. The hierarchical plans split the collective by mesh axis:

    x_host = all_gather(x_chunk, 'chips')      # within a host
    x_full = all_gather(x_host,  'hosts')      # one transfer per host
    y      = local_spmv(shard, x_full)
    [nnz_split] y = psum(y, 'chips') then psum(y, 'hosts')

On a real multi-host cluster the mesh should be built with
``make_mesh_hier()`` (devices grouped by process so 'chips' is intra-host);
on the 8-virtual-CPU test mesh any (hosts, chips) reshape exercises the same
code path (the collectives are axis-named, not topology-named).

Partitioning, layout stacking and the local bodies are shared with the flat
1D plans (:mod:`.local`) — the hierarchy changes only the collective
schedule.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..formats import CSR
from .local import apply_rows, shard_rows
from .mesh import hosts_axis, chips_axis
from .spmv_dist import _round_up


def make_mesh_hier(hosts: int | None = None, chips: int | None = None) -> Mesh:
    """('hosts', 'chips') mesh. With no args, hosts = jax.process_count()
    and chips = local device count — the physical hierarchy. Explicit
    (hosts, chips) reshapes the flat device list (for virtual-device tests).
    """
    devs = jax.devices()
    if hosts is None and chips is None:
        hosts = jax.process_count()
        chips = max(len(devs) // hosts, 1)
    elif hosts is None:
        hosts = len(devs) // chips
    elif chips is None:
        chips = len(devs) // hosts
    if hosts * chips > len(devs):
        raise ValueError(f"requested {hosts}x{chips} devices, have {len(devs)}")
    if jax.process_count() > 1:
        # group by process so the 'chips' axis is intra-host and the
        # 'hosts' axis crosses processes
        devs = sorted(devs, key=lambda d: (d.process_index, d.id))
    arr = np.array(devs[: hosts * chips]).reshape(hosts, chips)
    return Mesh(arr, (hosts_axis, chips_axis))


class _HierPlan:
    """Shared set-up: 1D row/nnz partition over all hosts*chips devices,
    stacked local blocks, the hierarchical collective schedule."""

    def __init__(self, a: CSR, mesh: Mesh, strategy: str):
        if mesh.axis_names != (hosts_axis, chips_axis):
            raise ValueError(
                f"{type(self).__name__} needs a ('{hosts_axis}', "
                f"'{chips_axis}') mesh, got {mesh.axis_names}; use "
                "make_mesh_hier()")
        self.mesh = mesh
        self.nhosts, self.nchips = mesh.devices.shape
        ndev = self.nhosts * self.nchips
        self.ndev = ndev
        self.shape = a.shape
        self.dtype = a.dtype
        self.strategy = strategy
        m, n = a.shape
        self.x_chunk = _round_up(max(-(-n // ndev), 1), 8)
        self.n_pad = self.x_chunk * ndev

        sr = shard_rows(a, ndev, strategy,
                        NamedSharding(self.mesh, P((hosts_axis, chips_axis))))
        self._split = sr.unpad is None
        self._unpad = sr.unpad
        self.local_method = sr.method
        self.bytes_per_iter = sr.bytes_per_iter
        self._out_rows = sr.out_rows
        self._arrs = sr.arrs

    def _build_run(self, k: int | None):
        """Executor for x of shape (n_pad,) (``k`` None) or (n_pad, k)."""
        m = self.shape[0]
        out_rows, split = self._out_rows, self._split
        axes = (hosts_axis, chips_axis)
        tail = () if k is None else (None,)

        def body(arrs, x_shard):
            buckets, perm = arrs
            with jax.named_scope("collective_intra_host"):
                x_host = lax.all_gather(x_shard, chips_axis, tiled=True)
            with jax.named_scope("collective_inter_host"):
                x_full = lax.all_gather(x_host, hosts_axis, tiled=True)
            with jax.named_scope("kernel"):
                y = apply_rows(buckets, perm, x_full, out_rows)
            if split:
                with jax.named_scope("collective_intra_host"):
                    y = lax.psum(y, chips_axis)
                with jax.named_scope("collective_inter_host"):
                    y = lax.psum(y, hosts_axis)
            return y[None, None]

        fn = shard_map(
            body, mesh=self.mesh,
            in_specs=(P(axes), P(axes, *tail)),
            out_specs=(P(None, None, None, *tail) if split
                       else P(*axes, None, *tail)),
            check_vma=False,
        )
        flat = (-1,) + (() if k is None else (k,))

        if split:
            @jax.jit
            def run(arrs, x_pad):
                return fn(arrs, x_pad).reshape(flat)[:m]
        else:
            unpad = self._unpad

            @jax.jit
            def run(arrs, x_pad):
                return fn(arrs, x_pad).reshape(flat)[unpad]

        return run

    def _apply(self, run, x_pad, alpha, beta, y):
        out = alpha * run(self._arrs, x_pad)
        if y is not None:
            out = out + beta * jnp.asarray(y, dtype=self.dtype)
        elif beta != 0.0:
            raise ValueError("beta != 0 requires y")
        return out


class HierSpmvPlan(_HierPlan):
    """1D row/nnz partition over all hosts*chips devices, hierarchical
    collectives. Local compute: XLA ELL, or degree buckets on skewed rows
    (``local_method`` records which)."""

    def __init__(self, a: CSR, mesh: Mesh, *, strategy: str = "nnz_balanced"):
        super().__init__(a, mesh, strategy)
        self._x_sharding = NamedSharding(self.mesh,
                                         P((hosts_axis, chips_axis)))
        self._run = self._build_run(None)

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        m, n = self.shape
        x = jnp.asarray(x, dtype=self.dtype)
        if x.shape != (n,):
            raise ValueError(f"x must have shape ({n},)")
        x_pad = jnp.zeros(self.n_pad, dtype=self.dtype).at[:n].set(x)
        x_pad = jax.device_put(x_pad, self._x_sharding)
        return self._apply(self._run, x_pad, alpha, beta, y)


class HierSpmmPlan(_HierPlan):
    """Hierarchical-collective SpMM: same schedule as HierSpmvPlan with the
    K-wide local contraction."""

    def __init__(self, a: CSR, mesh: Mesh, *, strategy: str = "nnz_balanced"):
        super().__init__(a, mesh, strategy)
        self._x_sharding = NamedSharding(
            self.mesh, P((hosts_axis, chips_axis), None))
        self._runs = {}

    def __call__(self, x, alpha: float = 1.0, beta: float = 0.0, y=None):
        m, n = self.shape
        x = jnp.asarray(x, dtype=self.dtype)
        if x.ndim != 2 or x.shape[0] != n:
            raise ValueError(f"X must have shape ({n}, k)")
        k = x.shape[1]
        if k not in self._runs:
            self._runs[k] = self._build_run(k)
        x_pad = jnp.zeros((self.n_pad, k), dtype=self.dtype).at[:n].set(x)
        x_pad = jax.device_put(x_pad, self._x_sharding)
        return self._apply(self._runs[k], x_pad, alpha, beta, y)
