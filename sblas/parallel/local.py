"""Per-device local layouts shared by the distributed plans.

Every plan partitions A into one block of rows per device, then runs the
same local product inside its ``shard_map`` body. :func:`stack_rows`
retiles those blocks to one common geometry so they stack into sharded
``(ndev, ...)`` arrays, and :func:`apply_rows` is the local product.

The geometry follows the matrix, by the single-card rule
(:func:`sblas.ops.spmv.pick_layout` over the rows of all blocks): one ELL
slab when the longest row is within 4x the mean row, else degree buckets
with heavy rows split at ``max_width`` (a power-law block would otherwise
pad its ELL slab to the hub degree).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..formats import CSR, COO, INDEX_DTYPE, coo_to_csr
from ..ops.common import ell_dot
from ..ops.spmv import pick_layout
from ..partition import partition_rows, partition_nnz_split
from ..retile import to_ell, to_bucket_ell


def _round_up(x, m):
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True, eq=False)
class StackedRows:
    """Row blocks of ``ndev`` devices on one geometry.

    - ``buckets``: tuple of ``(col, val)``, each ``(ndev, rows_b, width_b)``;
      padded entries point at column 0 with value 0.
    - ``perm``: ``(ndev, sum rows_b)`` output row of each slot, ``out_rows``
      for pad slots; None when the one slab's rows are the output rows.
    - ``out_rows``: length of each device's output.
    """

    buckets: tuple
    perm: np.ndarray | None
    out_rows: int
    method: str

    @property
    def bytes_per_iter(self) -> int:
        return sum(c.size * (c.itemsize + v.itemsize)
                   for c, v in self.buckets)


def stack_rows(parts: list[CSR], dtype, *, out_rows: int | None = None,
               row_base=None, max_width: int = 2048) -> StackedRows:
    """Retile per-device blocks (``parts``, in local row coordinates) to a
    common geometry. ``row_base[d]`` offsets device d's output rows (an
    nnz split writes into one shared row space); ``out_rows`` fixes the
    output length (default: the longest block, rounded up to 8)."""
    ndev = len(parts)
    skewed = pick_layout(np.concatenate(
        [p.row_lengths for p in parts])) == "bucket"
    if out_rows is None:
        out_rows = max(_round_up(max(p.shape[0], 1), 8) for p in parts)
    if not skewed:
        ells = [to_ell(p) for p in parts]
        width = max(e.width for e in ells)
        rows = out_rows if row_base is None else max(e.col.shape[0]
                                                     for e in ells)
        col = np.zeros((ndev, rows, width), dtype=INDEX_DTYPE)
        val = np.zeros((ndev, rows, width), dtype=dtype)
        for d, e in enumerate(ells):
            col[d, : e.m, : e.width] = e.col[: e.m]
            val[d, : e.m, : e.width] = e.val[: e.m]
        perm = None
        if row_base is not None:
            # an nnz split: each device's rows land at its own offset
            perm = np.full((ndev, rows), out_rows, dtype=INDEX_DTYPE)
            for d, e in enumerate(ells):
                perm[d, : e.m] = row_base[d] + np.arange(e.m)
        return StackedRows(((col, val),), perm, out_rows, "ell")

    # degree buckets, keyed across devices by their power-of-two width
    packs = [to_bucket_ell(p, max_width=max_width) if p.shape[0] else None
             for p in parts]
    keys = sorted({_bucket_key(b.width) for be in packs if be
                   for b in be.buckets})
    shape = {}
    for be in filter(None, packs):
        for b in be.buckets:
            r, w = shape.get(_bucket_key(b.width), (0, 0))
            shape[_bucket_key(b.width)] = (max(r, b.col.shape[0]),
                                           max(w, b.width))
    buckets, perms = [], []
    for key in keys:
        rows, width = shape[key]
        col = np.zeros((ndev, rows, width), dtype=INDEX_DTYPE)
        val = np.zeros((ndev, rows, width), dtype=dtype)
        perm = np.full((ndev, rows), out_rows, dtype=INDEX_DTYPE)
        for d, be in enumerate(packs):
            if be is None:
                continue
            start = 0
            for b in be.buckets:
                r = b.col.shape[0]
                if _bucket_key(b.width) == key:
                    col[d, :r, : b.width] = b.col
                    val[d, :r, : b.width] = b.val
                    p = be.perm[start: start + r].astype(np.int64)
                    base = 0 if row_base is None else int(row_base[d])
                    perm[d, :r] = np.where(p == parts[d].shape[0], out_rows,
                                           p + base)
                start += r
        buckets.append((col, val))
        perms.append(perm)
    return StackedRows(tuple(buckets), np.concatenate(perms, axis=1),
                       out_rows, "bucket")


def local_parts(a: CSR, ndev: int, strategy: str):
    """Row blocks of ``a`` for ``ndev`` devices, in local row coordinates.

    Returns ``(parts, row_starts, row_base)``: a row split (``even_rows``,
    ``nnz_balanced``) fills ``row_starts``; ``nnz_split`` cuts rows at equal
    nnz, so two devices may share a row, and fills ``row_base`` (the first
    global row of each part) for a psum merge instead."""
    if strategy in ("even_rows", "nnz_balanced"):
        part = partition_rows(a, ndev, strategy)
        return list(part.parts), [int(r) for r in part.row_starts], None
    if strategy == "nnz_split":
        part = partition_nnz_split(a, ndev)
        return list(part.parts), None, [int(r) for r in part.first_row]
    raise ValueError(f"unknown strategy {strategy!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedRows:
    """A 1D-partitioned matrix on the mesh: ``arrs`` = (buckets, perm) as
    sharded device arrays; ``unpad`` gathers the row-sharded outputs back
    into row order, or is None under an nnz split (outputs psum-merge in
    one shared row space)."""

    arrs: tuple
    out_rows: int
    unpad: object
    method: str
    bytes_per_iter: int


def shard_rows(a: CSR, ndev: int, strategy: str, sharding) -> ShardedRows:
    """Partition ``a`` by ``strategy``, stack the blocks and place them."""
    parts, row_starts, row_base = local_parts(a, ndev, strategy)
    if row_base is not None:
        st = stack_rows(parts, a.dtype, out_rows=a.shape[0],
                        row_base=row_base)
        unpad = None
    else:
        st = stack_rows(parts, a.dtype)
        unpad = jnp.asarray(
            unpad_slots(row_starts, st.out_rows).astype(INDEX_DTYPE))
    put = lambda arr: jax.device_put(arr, sharding)
    arrs = (tuple((put(c), put(v)) for c, v in st.buckets),
            None if st.perm is None else put(st.perm))
    return ShardedRows(arrs, st.out_rows, unpad, st.method,
                       st.bytes_per_iter)


def _bucket_key(width: int) -> int:
    return int(np.ceil(np.log2(max(width, 1))))


def apply_rows(buckets, perm, x, out_rows: int):
    """One device's local product inside a ``shard_map`` body: ``buckets``
    are this device's ``(col, val)`` slabs (leading device axis of size 1),
    ``x`` the operand it reads, (n,) or (n, k). Returns (out_rows,) or
    (out_rows, k)."""
    parts = [ell_dot(val[0], col[0], x) for col, val in buckets]
    if perm is None:
        return parts[0][:out_rows]
    flat = jnp.concatenate(parts)
    out = jnp.zeros((out_rows + 1,) + x.shape[1:], dtype=flat.dtype)
    return out.at[perm[0]].add(flat)[:out_rows]


def split_2d_blocks(parts, n_chunk: int, ncols: int):
    """Split each row-partition part into ``ncols`` column blocks of width
    ``n_chunk`` with chunk-local column indices (shared by the 2D plans).
    Returns the R*C blocks in row-major (i*C + j) order."""
    blocks = []
    for p in parts:
        coo = p.tocoo()
        for j in range(ncols):
            c0 = j * n_chunk
            sel = (coo.col >= c0) & (coo.col < c0 + n_chunk)
            blocks.append(coo_to_csr(COO(
                (p.shape[0], n_chunk),
                coo.row[sel], coo.col[sel] - c0, coo.data[sel],
            )))
    return blocks


def unpad_slots(row_starts: list[int], stride: int) -> np.ndarray:
    """slot[r] = owner_block * stride + offset: the gather map that
    reassembles per-device padded outputs into original row order."""
    m = int(row_starts[-1])
    slot = np.empty(m, dtype=np.int64)
    for i in range(len(row_starts) - 1):
        r0, r1 = row_starts[i], row_starts[i + 1]
        slot[r0:r1] = i * stride + np.arange(r1 - r0)
    return slot
