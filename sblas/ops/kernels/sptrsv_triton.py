"""Level-set triangular solve in one Pallas-Triton kernel launch.

The XLA ``tiles`` route (:func:`sblas.ops.sptrsv._solve_tiles`) walks the
level schedule with a ``lax.fori_loop``: one loop trip per tile, and on a
GPU every trip launches its own gather, reduce and scatter kernels. This
kernel walks the same schedule inside a single launch, so a trip costs a
block-wide barrier instead of several launches.

It consumes the :class:`~sblas.sptrsv_schedule.LevelSchedule` unchanged
(``slot_row``, ``col``, ``val``, ``inv_diag``): the plain ``tiles`` route
runs on identical inputs and is the reference it is tested against.

- Grid: one program per right-hand side; program ``k`` owns row ``k`` of
  the (K, n + 2) solution buffer, which lives in device memory (for a
  62K-row factor that is 250 KB per right-hand side, resident in L2).
- Each tile: load the tile's ``slot_row`` and, in chunks of ``wb`` columns,
  its ``col``/``val``; gather ``x`` from the solution buffer; reduce;
  scale by ``inv_diag``; store; then a block barrier so the next tile sees
  this tile's stores. Chunks stop at the tile's own longest row
  (``nch``), not at the schedule's global width. Everything but the x
  gather of the next tile (its rows, ``b``, ``inv_diag`` and first chunk)
  is loaded before the barrier, so one dependent gather round per chunk
  is what a level costs.
- Tile rows are read through a power-of-two block of ``rb`` lanes; lanes
  past ``tile_rows`` re-read the tile's last row and store to the dump
  slot, so no two lanes store to one row.

``interpret=True`` runs the kernel on the CPU and is for tests only; the
solve routes call it with ``interpret=False`` on a GPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
import jax.experimental.pallas as pl
import jax.experimental.pallas.triton as plt

from ...sptrsv_schedule import LevelSchedule

# upper bound on rb * wb: the (rb, wb) col/val/x chunk lives in registers
_CHUNK_ELEMS = 8192
# widest chunk: past it, extra columns are padding for all but the longest
# rows (measured on an H100: 128 beat 16/32/64 on a factor 560 wide)
_MAX_WB = 128


def launch_shape(tile_rows: int, width: int) -> tuple[int, int]:
    """``(wb, num_warps)`` for a schedule: chunks as wide as the schedule
    (up to ``_MAX_WB`` columns and ``_CHUNK_ELEMS`` values), so a tile
    costs few dependent gather rounds; eight warps once a chunk passes
    4096 values."""
    rb = pl.next_power_of_2(tile_rows)
    wb = max(min(pl.next_power_of_2(width), _MAX_WB, _CHUNK_ELEMS // rb), 8)
    return wb, (8 if rb * wb > 4096 else 4)


def kernel_arrays(sched: LevelSchedule, wb: int) -> dict:
    """The schedule's arrays with ``col``/``val`` padded to a multiple of
    ``wb`` columns (pads point at the zero slot ``n``), plus ``nch``:
    chunks of ``wb`` columns covering each tile's longest row."""
    pad = -sched.width % wb
    col = np.pad(sched.col, ((0, 0), (0, pad)), constant_values=sched.n)
    val = np.pad(sched.val, ((0, 0), (0, pad)))
    deg = (sched.col != sched.n).sum(axis=1)
    tile_deg = deg.reshape(sched.num_tiles, sched.tile_rows).max(axis=1)
    return {"slot_row": sched.slot_row, "col": col, "val": val,
            "inv_diag": sched.inv_diag,
            "nch": (-(-tile_deg // wb)).astype(np.int32)}


def _kernel(nch_ref, slot_row_ref, col_ref, val_ref, inv_diag_ref, b_ref,
            x0_ref, x_ref, *, n, tile_rows, num_tiles, width, wb, barrier):
    del x0_ref  # aliased to x_ref: the zero-initialised solution buffer
    base = pl.program_id(0) * (n + 2)
    rb = pl.next_power_of_2(tile_rows)
    lane = jnp.arange(rb, dtype=jnp.int32)
    live = lane < tile_rows
    lane = jnp.minimum(lane, tile_rows - 1)
    cols = jnp.arange(wb, dtype=jnp.int32)[None, :]

    def load(t):
        # everything of tile t that does not depend on x: issued one tile
        # ahead, so only the x gather sits on the level-to-level path
        slot = t * tile_rows + lane
        rows = slot_row_ref[slot]
        off = slot[:, None] * width + cols
        return (rows, inv_diag_ref[slot], b_ref[base + rows], col_ref[off],
                val_ref[off])

    def tile(t, carry):
        rows, idg, bv, c0, v0 = carry
        slot = t * tile_rows + lane

        def chunk(c, acc):
            off = slot[:, None] * width + c * wb + cols
            xv = x_ref[base + col_ref[off]]
            return acc + jnp.sum(val_ref[off] * xv, axis=1)

        acc = jnp.sum(v0 * x_ref[base + c0], axis=1)
        acc = lax.fori_loop(jnp.int32(1), nch_ref[t], chunk, acc)
        nxt = load(jnp.minimum(t + 1, num_tiles - 1))
        xb = (bv - acc) * idg
        # pad slots (slot_row == n) and the lanes past tile_rows, which
        # re-read the tile's last row, write to the dump slot n+1
        dst = base + jnp.where((rows == n) | ~live, n + 1, rows)
        x_ref[dst] = xb
        if barrier:
            plt.debug_barrier()
        return nxt

    lax.fori_loop(jnp.int32(0), jnp.int32(num_tiles), tile, load(jnp.int32(0)))


def solve(arrs, b, *, n: int, tile_rows: int, num_tiles: int, wb: int,
          num_warps: int = 4, interpret: bool = False):
    """x = op(L)^{-1} b on the arrays of :func:`kernel_arrays` (device
    copies); ``b`` is (n,) or (n, K)."""
    width = arrs["col"].shape[1]
    bt = b.reshape(n, -1).T                                  # (K, n)
    k = bt.shape[0]
    b_pad = jnp.pad(bt, ((0, 0), (0, 2))).reshape(-1)
    kernel = functools.partial(
        _kernel, n=n, tile_rows=tile_rows, num_tiles=num_tiles, width=width,
        wb=wb, barrier=not interpret)
    call = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((k * (n + 2),), b.dtype),
        grid=(k,),
        input_output_aliases={6: 0},
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=1),
        interpret=interpret,
        name="sptrsv_levels",
    )
    x = call(arrs["nch"], arrs["slot_row"], arrs["col"].reshape(-1),
             arrs["val"].reshape(-1), arrs["inv_diag"], b_pad,
             jnp.zeros(k * (n + 2), b.dtype))
    x = x.reshape(k, n + 2)[:, :n].T
    return x[:, 0] if b.ndim == 1 else x
